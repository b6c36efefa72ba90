// Level-S sub-tile z-pass: every face of every level-S unit -> image-layout
// (best 1/z, best face id) planes, the carry the tile raster
// (raster_tiles.cu) starts from.
//
// Replaces the TPU kernel geograypher_tpu/ops/subtile.py s_raster_pallas.
// The TPU kernel packs units into 128-slot chunks of four 32-slot
// quarters, evaluates planes localized to each sub-tile's origin through a
// bf16 hi/lo matrix product and writes a sub-tile-major output that is
// relaid afterwards.  None of that is carried over, and neither are
// per-sub-tile lists: the kernel is face-parallel.
//
// The function: for each pixel, among the faces of the level-S units whose
// cell box (the unit's (h, w) sub-tile cells, ops/subtile.py _unit_fit)
// holds the pixel, the larger 1/z wins and an exact tie goes to the lower
// face id; (-inf, -1) where no S face covers the pixel.
//
// Shape: one thread per face slot of every unit; a thread whose unit is
// not an S unit returns at once.  Each thread loops over its domain: the
// face's box (setup.bbox) widened by 1 px, intersected with its unit's
// cell box in pixels and with the image.  A face that eval_plane.cuh's
// cull_rule exempts (an edge coefficient above 2^18, or a vertex sharper
// than the rounding of its edges allows) loops over the whole cell box
// instead, at most s_window cells (3x2 x 8x16 = 768 px): the plain
// version evaluates a face over exactly its unit's cells, so the domain
// must hold every pixel there that the rounded test can cover.  Sentinel
// rows (invalid faces) cover nothing and return at once.
//
// Planes are evaluated at GLOBAL pixel centres (x + 0.5, y + 0.5) with the
// tile raster's rounding (eval_plane.cuh), never at sub-tile-local
// coordinates: coverage and depth are then bit-identical to the path with
// level S off, and the kernel is bit-equal to its plain PyTorch version
// (ops/subtile.py s_raster_plain).  No tensor cores: TF32 would round the
// coefficients and flip knife-edge pixels.
//
// The z-test is one atomicMax per covered pixel on an (H, W) 64-bit key,
// ordered_bits(w + 0.0f) << 32 | (0xFFFFFFFF - id): ordered_bits maps
// floats to unsigned ints in order (sign bit flipped for non-negatives,
// all bits inverted for negatives), and + 0.0f folds -0.0 into +0.0,
// which the plain comparison treats as equal.  A max of this key is
// exactly "larger w, then lower id" whatever order the atomics land in,
// so the result is deterministic.  Key 0 never arises from a face (its
// low word is at least 2^31), so the zeroed buffer means "none"; a second
// small kernel unpacks the keys into the two planes.
//
// What bounds it on the H100: with ~1.7e7 needed candidate-pixels per 4K
// view (16 FLOP each) the work is ~0.004 ms of FP32; the (H, W) key
// buffer (zero fill, atomics that resolve in L2, the unpack) and the
// per-face plane rows are the traffic, so it is byte bound.  The design
// answer is the per-face domain: candidate-pixels fall from every unit
// slot over 128-pixel sub-tiles to each face over its own box, and no
// per-sub-tile list (and so no sort) is needed.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "eval_plane.cuh"

namespace {

constexpr int kThreads = 256;

struct SRasterArgs {
  const float* planes;         // (F, 12): 3 edge planes (A, B, C) + 1/z
  const int* bbox;             // (4, F): first/last covered row, column
  const int* cells;            // (4, n_units): cy0, cx0, cy1, cx1
  const unsigned char* s_unit; // (n_units,) bool: unit resolved at level S
  unsigned long long* keys;    // (H, W) packed (1/z, id) maxima, 0 = none
  int64_t F;
  int64_t n_units;
  int H, W, sh, sw, s_block;
};

__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__global__ void __launch_bounds__(kThreads) s_raster_kernel(SRasterArgs a) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= a.F) return;
  const int64_t u = f / a.s_block;
  if (!a.s_unit[u]) return;
  const float* row = a.planes + f * 12;
  const float a0 = row[0], b0 = row[1], c0 = row[2];
  const float a1 = row[3], b1 = row[4], c1 = row[5];
  const float a2 = row[6], b2 = row[7], c2 = row[8];
  const float wa = row[9], wb = row[10], wc = row[11];
  const int kind = cull_rule(a0, b0, c0, a1, b1, c1, a2, b2, c2, a.W, a.H);
  if (kind == kCullNever) return;
  // the unit's cell box in pixels, clipped to the image
  int y0 = a.cells[u] * a.sh;
  int x0 = a.cells[a.n_units + u] * a.sw;
  int y1 = min((a.cells[2 * a.n_units + u] + 1) * a.sh, a.H) - 1;
  int x1 = min((a.cells[3 * a.n_units + u] + 1) * a.sw, a.W) - 1;
  if (kind == kCullBox) {
    y0 = max(y0, a.bbox[f] - kCullMargin);
    x0 = max(x0, a.bbox[a.F + f] - kCullMargin);
    y1 = min(y1, a.bbox[2 * a.F + f] + kCullMargin);
    x1 = min(x1, a.bbox[3 * a.F + f] + kCullMargin);
  }
  const unsigned long long low = 0xFFFFFFFFull - static_cast<unsigned>(f);
  for (int y = y0; y <= y1; ++y) {
    const float py = static_cast<float>(y) + 0.5f;
    unsigned long long* key_row = a.keys + static_cast<int64_t>(y) * a.W;
    for (int x = x0; x <= x1; ++x) {
      const float px = static_cast<float>(x) + 0.5f;
      const float e0 = eval_plane(a0, b0, c0, px, py);
      const float e1 = eval_plane(a1, b1, c1, px, py);
      const float e2 = eval_plane(a2, b2, c2, px, py);
      if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) {
        const float w = __fadd_rn(eval_plane(wa, wb, wc, px, py), 0.0f);
        const unsigned long long key =
            (static_cast<unsigned long long>(ordered_bits(w)) << 32) | low;
        atomicMax(key_row + x, key);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) s_unpack_kernel(
    const unsigned long long* keys, float* best_w, int* best_id, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = keys[i];
  if (k == 0ull) {
    best_w[i] = -CUDART_INF_F;
    best_id[i] = -1;
  } else {
    best_w[i] = from_ordered_bits(static_cast<unsigned>(k >> 32));
    best_id[i] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k));
  }
}

}  // namespace

extern "C" int gg_s_raster(const void* planes, const void* bbox,
                           const void* cells, const void* s_unit, void* keys,
                           void* best_w, void* best_id, int64_t n_faces, int H,
                           int W, int sh, int sw, int s_block, void* stream) {
  if (sh < 1 || sw < 1 || s_block < 1 || n_faces % s_block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SRasterArgs a;
  a.planes = static_cast<const float*>(planes);
  a.bbox = static_cast<const int*>(bbox);
  a.cells = static_cast<const int*>(cells);
  a.s_unit = static_cast<const unsigned char*>(s_unit);
  a.keys = static_cast<unsigned long long*>(keys);
  a.F = n_faces;
  a.n_units = n_faces / s_block;
  a.H = H;
  a.W = W;
  a.sh = sh;
  a.sw = sw;
  a.s_block = s_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_faces > 0) {
    const int64_t blocks = (n_faces + kThreads - 1) / kThreads;
    s_raster_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n = static_cast<int64_t>(H) * W;
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    s_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a.keys, static_cast<float*>(best_w), static_cast<int*>(best_id), n);
  }
  return static_cast<int>(cudaGetLastError());
}
