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
// at 1M faces, 0.030 ms at 3.35 TB/s).  One launch a view; 256 threads a
// block, two faces a thread, the 18 row loads of both issued before
// anything else so that more bytes are in flight.  The camera, f and the
// lens terms are read from device memory once a block, into shared
// memory (the wrapper never reads them back to the host).  A face's
// 48-byte plane row left as three 16-byte stores 48 bytes apart would
// make each warp store touch 32 half-written sectors; instead the block
// stages its rows in shared memory (a 48-byte stride meets every bank
// once in each quarter-warp phase of a 16-byte access, so no padding is
// needed) and one thread sends the block's contiguous 48 x faces bytes
// out with one bulk asynchronous copy (cp.async.bulk, the TMA without a
// tensor map: whole lines, no store instruction a thread); its address
// and size are multiples of 16 in every block, the tail's too.  Coalesced
// 16-byte stores of the staged rows ran about 1-3% slower on the H100
// (tools/setup_turns.py --store-variant).  The box rows and the valid
// bytes are written coalesced.  The pinhole and the lens each have their
// own instance of the kernel (the pinhole one needs fewer registers).
// The outputs are one buffer of 65 bytes a face (planes at 0, boxes at
// 48F, validity at 64F), which the wrapper allocates once and cuts into
// views.
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

// threads a block, faces a thread, faces a block
constexpr int kThreads = 256, kPer = 2, kFaces = kThreads * kPer;

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

// the block's shared scalars: rows 0-2 of the 4 x 4 camera, f, the lens's
// 8 terms, pcx, pcy
constexpr int kF = 12, kDist = 13, kPcx = 21, kPcy = 22, kScalars = 23;

// One face: its 9 coordinates `w` and the block's scalars `par` -> its
// plane row (three float4 at `row`), its box and validity (face i of n).
// r2_lim: the lens's bound on the squared normalized radius.
template <bool kLens>
__device__ __forceinline__ void setup_face(const float (&w)[9], const float* par,
                                           float r2_lim, float half_w, float half_h,
                                           float znear, int width, int height,
                                           float4* row, int* __restrict__ bbox,
                                           uint8_t* __restrict__ valid_out, int64_t i,
                                           int64_t n) {
  const float* r = par;
  const float f = par[kF];
  float sx[3], sy[3], inv_z[3];
  bool in_front = true;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float wx = w[3 * v], wy = w[3 * v + 1], wz = w[3 * v + 2];
    const float cx = add(add(add(mul(r[0], wx), mul(r[1], wy)), mul(r[2], wz)), r[3]);
    const float cy = add(add(add(mul(r[4], wx), mul(r[5], wy)), mul(r[6], wz)), r[7]);
    const float cz = add(add(add(mul(r[8], wx), mul(r[9], wy)), mul(r[10], wz)), r[11]);
    const bool ahead = cz > znear;
    inv_z[v] = __frcp_rn(ahead ? cz : 1.f);
    in_front = in_front && ahead;
    const float xn = mul(cx, inv_z[v]);
    const float yn = mul(cy, inv_z[v]);
    if (!kLens) {
      sx[v] = add(mul(xn, f), half_w);
      sy[v] = add(mul(yn, f), half_h);
    } else {
      // distort_normalized, op for op
      const float k1 = par[kDist], k2 = par[kDist + 1], k3 = par[kDist + 2];
      const float k4 = par[kDist + 3], p1 = par[kDist + 4], p2 = par[kDist + 5];
      const float b1 = par[kDist + 6], b2 = par[kDist + 7];
      const float r2 = add(mul(xn, xn), mul(yn, yn));
      float q = mul(r2, k4);
      q = mul(r2, add(k3, q));
      q = mul(r2, add(k2, q));
      q = mul(r2, add(k1, q));
      const float radial = add(q, 1.f);
      const float xd = add(mul(xn, radial),
                           add(mul(p1, add(r2, mul(mul(2.f, xn), xn))),
                               mul(mul(mul(2.f, p2), xn), yn)));
      const float yd = add(mul(yn, radial),
                           add(mul(p2, add(r2, mul(mul(2.f, yn), yn))),
                               mul(mul(mul(2.f, p1), xn), yn)));
      sx[v] = add(add(add(par[kPcx], half_w), mul(xd, add(f, b1))), mul(yd, b2));
      sy[v] = add(add(par[kPcy], half_h), mul(yd, f));
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
  bbox[i] = py0;
  bbox[n + i] = px0;
  bbox[2 * n + i] = py1;
  bbox[3 * n + i] = px1;
  valid_out[i] = valid ? 1 : 0;
}

template <bool kLens>
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
  __shared__ float par[kScalars];
  __shared__ float4 stage[3 * kFaces];
  const int t = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kFaces;

  // the rows first, so that their loads are in flight while the block
  // reads its scalars; face j of the block is thread j % kThreads's
  float w[kPer][9];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int64_t i = first + p * kThreads + t;
    if (i < n) {
#pragma unroll
      for (int k = 0; k < 9; ++k) w[p][k] = soa[k * n + i];
    }
  }
  if (t < kF) {
    par[t] = w2c[t];
  } else if (t == kF) {
    par[kF] = f_dev != nullptr ? *f_dev : f_host;
  } else if (kLens && t < kPcx) {
    par[t] = dist[t - kDist];
  } else if (kLens && t == kPcx) {
    par[kPcx] = *pcx_dev;
  } else if (kLens && t == kPcy) {
    par[kPcy] = *pcy_dev;
  }
  __syncthreads();

  // the lens: (w/2 + |pcx|)^2 + (h/2 + |pcy|)^2 over f^2, times 1.69
  float r2_lim = 0.f;
  if (kLens) {
    const float f = par[kF];
    const float ex = add(half_w, fabsf(par[kPcx])), ey = add(half_h, fabsf(par[kPcy]));
    const float num = add(mul(ex, ex), mul(ey, ey));
    // a host f: PyTorch divides by the host product f * f as a multiply
    // by the float32 reciprocal
    r2_lim = f_dev != nullptr ? __fdiv_rn(num, mul(f, f)) : mul(num, inv_ff_host);
    r2_lim = mul(r2_lim, static_cast<float>(1.69));
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = p * kThreads + t;
    if (first + j < n) {
      setup_face<kLens>(w[p], par, r2_lim, half_w, half_h, znear, width, height,
                        stage + 3 * j, bbox, valid_out, first + j, n);
    }
  }
  // the block's rows leave as one bulk asynchronous copy of its 48 *
  // faces contiguous bytes (the TMA without a tensor map): every
  // thread's staged rows made visible to the async proxy, then one
  // thread issues the copy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (t == 0) {
    const int64_t left = n - first;
    const unsigned bytes = 48u * (left < kFaces ? static_cast<unsigned>(left) : kFaces);
    const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(stage));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(planes + 12 * first), "r"(src), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the block's shared memory stays until the copy has read it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

}  // namespace

// soa: (9, n) float32; w2c: (4, 4) float32; f_dev: a float32 on the
// device, or null for the host value f_host; dist (8,), pcx_dev, pcy_dev:
// float32 on the device, or all null without distortion.  out: one
// 16-byte aligned buffer of at least 65 * n bytes: planes (n, 12) float32
// at 0, bbox (4, n) int32 at 48 n, valid (n,) bool at 64 n, all written.
// Launched on `stream` of `device`, made the current device for the
// launch when it is not.
extern "C" int gg_triangle_setup(const void* soa, int64_t n, const void* w2c,
                                 const void* f_dev, double f_host, const void* dist,
                                 const void* pcx_dev, const void* pcy_dev,
                                 float znear, int width, int height, void* out,
                                 int device, void* stream) {
  if (n <= 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // each scalar as PyTorch takes a Python number beside float32 rows:
  // w / 2 and f rounded to float32, and a division by the host product
  // f * f made a multiply by its float32 reciprocal
  const float inv_ff_host = 1.0f / static_cast<float>(f_host * f_host);
  char* base = static_cast<char*>(out);
  const unsigned blocks = static_cast<unsigned>((n + kFaces - 1) / kFaces);
  const auto kernel = dist != nullptr ? triangle_setup_kernel<true>
                                      : triangle_setup_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(soa), n, static_cast<const float*>(w2c),
      static_cast<const float*>(f_dev), static_cast<float>(f_host), inv_ff_host,
      static_cast<const float*>(dist), static_cast<const float*>(pcx_dev),
      static_cast<const float*>(pcy_dev), static_cast<float>(width / 2.0),
      static_cast<float>(height / 2.0), znear, width, height,
      reinterpret_cast<float*>(base), reinterpret_cast<int*>(base + 48 * n),
      reinterpret_cast<uint8_t*>(base + 64 * n));
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
