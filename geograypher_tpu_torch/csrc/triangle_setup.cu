// Fused triangle setup: (9, F) coordinate rows and one camera -> per-face
// raster planes (F, 12), pixel boxes (4, F) and validity (F,).
//
// Replaces no TPU kernel: geograypher_tpu/ops/rasterize.py setup_from_soa
// (:200) runs inside one jitted program, which XLA fuses into a few
// kernels; the port's plain version (ops/tri_setup.py
// setup_from_soa_plain) is about sixty eager launches over all F faces.
//
// What bounds it on the H100: bytes.  A face reads 9 float32 and writes 12
// plane floats, 4 int32 box bounds and one valid byte (101 bytes; 101 MB
// at 1M faces, 0.030 ms at 3.35 TB/s).  One launch a view, one thread a
// face: the rows are read coalesced, the plane row leaves as three 16-byte
// stores, the box rows coalesced.  The camera and the lens terms are read
// from device memory by every thread (they stay in L1), so the wrapper
// never reads them back to the host.
//
// Bit-equal to the plain version on the card.  Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would
// otherwise contract a*b + c into an FMA) in the plain version's order of
// operations; 1 / z is the correctly rounded reciprocal and sign / |area|
// the correctly rounded division that PyTorch's kernels compute; each
// host scalar arrives as the float32 PyTorch casts it to; minimum,
// maximum and clamp pass a NaN on, as torch's do, so a NaN box edge casts
// to the same int32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.minimum / torch.maximum / torch.clamp: a NaN operand wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

struct Edge {
  float a, b, c;
};

// E(x, y) = (xb-xa)(y-ya) - (yb-ya)(x-xa): (-(yb-ya), xb-xa,
// (yb-ya)*xa - (xb-xa)*ya)
__device__ __forceinline__ Edge edge(float xa, float ya, float xb, float yb) {
  const float dy = sub(yb, ya), dx = sub(xb, xa);
  return {-dy, dx, sub(mul(dy, xa), mul(dx, ya))};
}

__global__ void __launch_bounds__(kThreads)
    triangle_setup_kernel(const float* __restrict__ soa, int64_t n,
                          const float* __restrict__ w2c,
                          const float* __restrict__ f_dev, float f_host,
                          float inv_ff_host, const float* __restrict__ dist,
                          const float* __restrict__ pcx_dev,
                          const float* __restrict__ pcy_dev, float half_w,
                          float half_h, float znear, int width, int height,
                          float* __restrict__ planes, int* __restrict__ bbox,
                          uint8_t* __restrict__ valid_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float r[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) r[k] = w2c[k];  // rows 0-2 of the 4 x 4
  const float f = f_dev != nullptr ? *f_dev : f_host;

  // the lens: (w/2 + |pcx|)^2 + (h/2 + |pcy|)^2 over f^2, times 1.69
  float k1 = 0.f, k2 = 0.f, k3 = 0.f, k4 = 0.f, p1 = 0.f, p2 = 0.f;
  float b1 = 0.f, b2 = 0.f, pcx = 0.f, pcy = 0.f, r2_lim = 0.f;
  if (dist != nullptr) {
    k1 = dist[0], k2 = dist[1], k3 = dist[2], k4 = dist[3];
    p1 = dist[4], p2 = dist[5], b1 = dist[6], b2 = dist[7];
    pcx = *pcx_dev, pcy = *pcy_dev;
    const float ex = add(half_w, fabsf(pcx)), ey = add(half_h, fabsf(pcy));
    const float num = add(mul(ex, ex), mul(ey, ey));
    // a host f: PyTorch divides by the host product f * f as a multiply
    // by the float32 reciprocal
    r2_lim = f_dev != nullptr ? __fdiv_rn(num, mul(f, f)) : mul(num, inv_ff_host);
    r2_lim = mul(r2_lim, static_cast<float>(1.69));
  }

  float sx[3], sy[3], inv_z[3];
  bool in_front = true;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float wx = soa[(3 * v) * n + i];
    const float wy = soa[(3 * v + 1) * n + i];
    const float wz = soa[(3 * v + 2) * n + i];
    const float cx = add(add(add(mul(r[0], wx), mul(r[1], wy)), mul(r[2], wz)), r[3]);
    const float cy = add(add(add(mul(r[4], wx), mul(r[5], wy)), mul(r[6], wz)), r[7]);
    const float cz = add(add(add(mul(r[8], wx), mul(r[9], wy)), mul(r[10], wz)), r[11]);
    const bool ahead = cz > znear;
    inv_z[v] = __frcp_rn(ahead ? cz : 1.f);
    in_front = in_front && ahead;
    const float xn = mul(cx, inv_z[v]);
    const float yn = mul(cy, inv_z[v]);
    if (dist == nullptr) {
      sx[v] = add(mul(xn, f), half_w);
      sy[v] = add(mul(yn, f), half_h);
    } else {
      // distort_normalized, op for op
      const float r2 = add(mul(xn, xn), mul(yn, yn));
      float t = mul(r2, k4);
      t = mul(r2, add(k3, t));
      t = mul(r2, add(k2, t));
      t = mul(r2, add(k1, t));
      const float radial = add(t, 1.f);
      const float xd = add(mul(xn, radial),
                           add(mul(p1, add(r2, mul(mul(2.f, xn), xn))),
                               mul(mul(mul(2.f, p2), xn), yn)));
      const float yd = add(mul(yn, radial),
                           add(mul(p2, add(r2, mul(mul(2.f, yn), yn))),
                               mul(mul(mul(2.f, p1), xn), yn)));
      sx[v] = add(add(add(pcx, half_w), mul(xd, add(f, b1))), mul(yd, b2));
      sy[v] = add(add(pcy, half_h), mul(yd, f));
      in_front = in_front && (r2 <= r2_lim);
    }
  }

  // edge k is opposite vertex k; E_k(v_k) = 2 * signed area
  const Edge e0 = edge(sx[1], sy[1], sx[2], sy[2]);
  const Edge e1 = edge(sx[2], sy[2], sx[0], sy[0]);
  const Edge e2 = edge(sx[0], sy[0], sx[1], sy[1]);
  const float area2 = add(add(mul(e0.a, sx[0]), mul(e0.b, sy[0])), e0.c);
  const float sign = area2 < 0.f ? -1.f : 1.f;
  const bool nondegenerate = fabsf(area2) > static_cast<float>(1e-12);
  const float inv_area2 = __fdiv_rn(sign, nondegenerate ? fabsf(area2) : 1.f);

  // pixel-centre box, clamped before the int32 cast
  const float big = 1073741824.f;  // 2^30
  const float xmin = nan_min(nan_min(sx[0], sx[1]), sx[2]);
  const float xmax = nan_max(nan_max(sx[0], sx[1]), sx[2]);
  const float ymin = nan_min(nan_min(sy[0], sy[1]), sy[2]);
  const float ymax = nan_max(nan_max(sy[0], sy[1]), sy[2]);
  int px0 = static_cast<int>(ceilf(nan_clamp(sub(xmin, 0.5f), -big, big)));
  int px1 = static_cast<int>(floorf(nan_clamp(sub(xmax, 0.5f), -big, big)));
  int py0 = static_cast<int>(ceilf(nan_clamp(sub(ymin, 0.5f), -big, big)));
  int py1 = static_cast<int>(floorf(nan_clamp(sub(ymax, 0.5f), -big, big)));
  const bool nonempty = px1 >= px0 && py1 >= py0;
  const bool on_screen = px1 >= 0 && px0 < width && py1 >= 0 && py0 < height;
  px0 = clamp_int(px0, 0, width - 1);
  px1 = clamp_int(px1, 0, width - 1);
  py0 = clamp_int(py0, 0, height - 1);
  py1 = clamp_int(py1, 0, height - 1);
  const bool valid = in_front && nondegenerate && nonempty && on_screen;

  float4 row[3];
  if (valid) {
    const float wa = mul(add(add(mul(e0.a, inv_z[0]), mul(e1.a, inv_z[1])),
                             mul(e2.a, inv_z[2])), inv_area2);
    const float wb = mul(add(add(mul(e0.b, inv_z[0]), mul(e1.b, inv_z[1])),
                             mul(e2.b, inv_z[2])), inv_area2);
    const float wc = mul(add(add(mul(e0.c, inv_z[0]), mul(e1.c, inv_z[1])),
                             mul(e2.c, inv_z[2])), inv_area2);
    row[0] = make_float4(mul(e0.a, sign), mul(e0.b, sign), mul(e0.c, sign),
                         mul(e1.a, sign));
    row[1] = make_float4(mul(e1.b, sign), mul(e1.c, sign), mul(e2.a, sign),
                         mul(e2.b, sign));
    row[2] = make_float4(mul(e2.c, sign), wa, wb, wc);
  } else {
    // the coverage-false sentinel row keeps block-granular units inert
    row[0] = make_float4(0.f, 0.f, -1.f, 0.f);
    row[1] = make_float4(0.f, -1.f, 0.f, 0.f);
    row[2] = make_float4(-1.f, 0.f, 0.f, 0.f);
  }
  float4* out = reinterpret_cast<float4*>(planes + i * 12);
  out[0] = row[0];
  out[1] = row[1];
  out[2] = row[2];
  bbox[i] = py0;
  bbox[n + i] = px0;
  bbox[2 * n + i] = py1;
  bbox[3 * n + i] = px1;
  valid_out[i] = valid ? 1 : 0;
}

}  // namespace

// soa: (9, n) float32; w2c: (4, 4) float32; f_dev: a float32 on the
// device, or null for the host value f_host (inv_ff_host: float32
// 1 / float32(f * f)); dist (8,), pcx_dev, pcy_dev: float32 on the device,
// or all null without distortion.  planes (n, 12), bbox (4, n), valid (n,)
// are written whole.
extern "C" int gg_triangle_setup(const void* soa, int64_t n, const void* w2c,
                                 const void* f_dev, float f_host,
                                 float inv_ff_host, const void* dist,
                                 const void* pcx_dev, const void* pcy_dev,
                                 float half_w, float half_h, float znear,
                                 int width, int height, void* planes,
                                 void* bbox, void* valid, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    triangle_setup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(soa), n, static_cast<const float*>(w2c),
        static_cast<const float*>(f_dev), f_host, inv_ff_host,
        static_cast<const float*>(dist), static_cast<const float*>(pcx_dev),
        static_cast<const float*>(pcy_dev), half_w, half_h, znear, width,
        height, static_cast<float*>(planes), static_cast<int*>(bbox),
        static_cast<uint8_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
