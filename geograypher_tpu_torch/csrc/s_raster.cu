// Level-S sub-tile z-pass: CSR lists of small face units per occupied
// sub-tile -> image-layout (best 1/z, best face id) planes, the carry the
// tile raster (raster_tiles.cu) starts from.
//
// Replaces the TPU kernel geograypher_tpu/ops/subtile.py s_raster_pallas.
// The TPU kernel packs units into 128-slot chunks of four 32-slot
// quarters, evaluates planes localized to each sub-tile's origin through a
// bf16 hi/lo matrix product and writes a sub-tile-major output that is
// relaid afterwards.  None of that is carried over: one thread block per
// OCCUPIED sub-tile (a compact list, so empty sky and off-mesh cells cost
// nothing) reads its CSR range of units, one thread per pixel, and writes
// the image layout directly.
//
// Planes are evaluated at GLOBAL pixel centres (x + 0.5, y + 0.5) with the
// tile raster's rounding (eval_plane.cuh), never at sub-tile-local
// coordinates: coverage and depth are then bit-identical to the path with
// level S off, and the kernel is bit-equal to its plain PyTorch version
// (ops/subtile.py s_raster_plain).
//
// Tie rule (subtile.py s_raster_pallas): the larger 1/z wins and an exact
// tie goes to the lower face id.  Units are ascending inside a sub-tile's
// list and faces ascending inside a unit, so a strict > scan in list
// order gives exactly that.
//
// What bounds it on the H100: FP32 instruction throughput, 16 FLOP per
// candidate-pixel (3 edge planes + 1 depth plane, 2 mul + 2 add each).
// Its design answer is the sub-tile itself: a unit costs 128 pixels here
// against 1024 in an 8 x 128 L0 tile, so the same faces take ~8x fewer
// candidate-pixel evaluations.  Unit plane rows are staged in shared
// memory in chunks of kChunk faces and the loop runs only to the
// sub-tile's count.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "eval_plane.cuh"

namespace {

constexpr int kMaxThreads = 256;  // sub-tiles of at most 256 pixels
constexpr int kChunk = 128;       // face rows staged in shared memory

struct SRasterArgs {
  const float* planes;     // (F, 12): 3 edge planes (A, B, C) + 1/z plane
  const int* units;        // CSR unit ids, ascending per sub-tile
  const int* sub_ids;      // (n_occ,) occupied sub-tile ids: cy * nsx + cx
  const int* sub_start;    // (n_occ,) first entry in units
  const int* sub_count;    // (n_occ,) units of the sub-tile
  float* best_w;           // (H, W) 1/z of the winner, -inf = none
  int* best_id;            // (H, W) face id of the winner, -1 = none
  int H, W, sh, sw, nsx, s_block;
};

__global__ void __launch_bounds__(kMaxThreads) s_raster_kernel(SRasterArgs a) {
  __shared__ float sp[12][kChunk];
  __shared__ int sid[kChunk];

  const int s = blockIdx.x;
  const int sub = a.sub_ids[s];
  const int start = a.sub_start[s];
  const int n = a.sub_count[s] * a.s_block;  // face slots, uniform per block
  const int p = threadIdx.x;
  const int y = (sub / a.nsx) * a.sh + p / a.sw;
  const int x = (sub % a.nsx) * a.sw + p % a.sw;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  float bw = -CUDART_INF_F;
  int bid = -1;

  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int j = base + i;
      const int f = a.units[start + j / a.s_block] * a.s_block + j % a.s_block;
      sid[i] = f;
      const float* row = a.planes + static_cast<int64_t>(f) * 12;
#pragma unroll
      for (int c = 0; c < 12; ++c) sp[c][i] = row[c];
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float e0 = eval_plane(sp[0][i], sp[1][i], sp[2][i], px, py);
      const float e1 = eval_plane(sp[3][i], sp[4][i], sp[5][i], px, py);
      const float e2 = eval_plane(sp[6][i], sp[7][i], sp[8][i], px, py);
      if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) {
        const float w = eval_plane(sp[9][i], sp[10][i], sp[11][i], px, py);
        if (w > bw) {
          bw = w;
          bid = sid[i];
        }
      }
    }
  }
  if (p < a.sh * a.sw && y < a.H && x < a.W) {
    const int64_t o = static_cast<int64_t>(y) * a.W + x;
    a.best_w[o] = bw;
    a.best_id[o] = bid;
  }
}

}  // namespace

extern "C" int gg_s_raster(const void* planes, const void* units,
                           const void* sub_ids, const void* sub_start,
                           const void* sub_count, void* best_w, void* best_id,
                           int n_occ, int H, int W, int sh, int sw, int nsx,
                           int s_block, void* stream) {
  if (sh < 1 || sw < 1 || sh * sw > kMaxThreads || s_block < 1 || nsx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  SRasterArgs a;
  a.planes = static_cast<const float*>(planes);
  a.units = static_cast<const int*>(units);
  a.sub_ids = static_cast<const int*>(sub_ids);
  a.sub_start = static_cast<const int*>(sub_start);
  a.sub_count = static_cast<const int*>(sub_count);
  a.best_w = static_cast<float*>(best_w);
  a.best_id = static_cast<int*>(best_id);
  a.H = H;
  a.W = W;
  a.sh = sh;
  a.sw = sw;
  a.nsx = nsx;
  a.s_block = s_block;
  if (n_occ > 0) {
    const int threads = (sh * sw + 31) / 32 * 32;
    s_raster_kernel<<<n_occ, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
