// Tile z-buffer resolve: triangle plane rows + per-tile candidate lists
// -> pix2face.
//
// Replaces the TPU kernel geograypher_tpu/ops/pallas_raster.py
// raster_tiles_pallas (its z-resolve; the fused class counting moves to
// face_class_counts.cu).  The bf16 hi/lo coefficient split and the
// base-256 face-id digit planes of the TPU kernel exist because the TPU's
// matrix unit rounds f32 to bf16; here every plane is evaluated in native
// f32 at global pixel centres (x + 0.5, y + 0.5), with inclusive >= 0
// edge tests, so none of that is carried over.  Each plane is evaluated as
// (a*x + b*y) + c with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn, which the compiler never fuses into FMAs): the
// plain PyTorch version rounds the same way, so the two agree bit for bit
// on coverage and depth.  Pixel centres exactly on an edge shared by two
// faces are where any other rounding flips a pixel between a face and
// the background.
//
// Shape: one thread block per L0 tile (8 x 128 pixels by default), 256
// threads with 4 pixels each.  The block walks three candidate groups in
// order -- its L0 list, its L1 parent's list, and its L2 parent's list
// followed by the single global list (read from one array, never copied
// per tile) -- staging 128 candidate plane rows at a time in shared
// memory and looping only to each list's true count.
//
// Tie rules (pallas_raster.py raster_tiles_pallas docstring): inside a
// group the larger 1/z wins and an exact tie goes to the lower face id;
// across groups only a strictly larger 1/z replaces the earlier group's
// winner.
//
// Level-S carry (pallas_raster.py s_init): given the sub-tile raster's
// image-layout (best_w, best_id) planes (s_raster.cu), each pixel starts
// from its S winner instead of (-inf, -1), so an L0+ candidate beats an S
// winner only strictly -- the TPU kernel's rule.
//
// What bounds it on the H100: FP32 instruction throughput.  Each
// candidate costs every pixel of the tile 3 edge planes + 1 depth plane
// (4 x 4 FP32 ops) while its plane row is a broadcast shared-memory
// read, so the kernel does ~16 FLOP per 4 bytes of shared memory traffic
// and reads each plane row from device memory once per tile.  Its design
// answer is the per-tile loop bound (work scales with real occupancy,
// not with the capacity) and register-resident per-pixel state; culling
// candidates against sub-tile boxes is left for a later change.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "eval_plane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;  // tiles of at most 1024 pixels
constexpr int kChunk = 128;       // candidates staged in shared memory

struct RasterArgs {
  const float* planes;  // (F, 12): 3 edge planes (A, B, C) + 1/z plane
  const int* cand[4];   // per-level face-id lists, -1 = empty slot
  const int* cnt[4];    // per-level true counts (face slots)
  const float* s_w;     // (H, W) level-S carry 1/z, or null
  const int* s_id;      // (H, W) level-S carry face id, or null
  int* out;             // (H, W) pix2face, -1 = background
  int H, W, th, tw;
  int nty0, ntx0, nty1, ntx1, nty2, ntx2, s1, s2;
  int cap[4];           // per-level list widths
};

// Resolve one candidate group (list ``la`` followed by list ``lb``) for
// this thread's pixels and merge its winner into (bw, bid).
__device__ __forceinline__ void resolve_group(
    const float* __restrict__ planes, const int* __restrict__ la, int na,
    const int* __restrict__ lb, int nb, float (*sp)[kChunk], int* sid,
    const float (&px)[kPixPerThread], const float (&py)[kPixPerThread],
    float (&bw)[kPixPerThread], int (&bid)[kPixPerThread]) {
  float gw[kPixPerThread];
  int gid[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    gw[k] = -CUDART_INF_F;
    gid[k] = INT_MAX;
  }
  const int n = na + nb;  // uniform across the block
  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int j = base + i;
      const int f = j < na ? la[j] : lb[j - na];
      sid[i] = f;
      if (f >= 0) {
        const float* row = planes + static_cast<int64_t>(f) * 12;
#pragma unroll
        for (int c = 0; c < 12; ++c) sp[c][i] = row[c];
      } else {
        // coverage-false sentinel: every edge plane is the constant -1
#pragma unroll
        for (int c = 0; c < 12; ++c) sp[c][i] = (c % 3 == 2 && c < 9) ? -1.f : 0.f;
      }
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float a0 = sp[0][i], b0 = sp[1][i], c0 = sp[2][i];
      const float a1 = sp[3][i], b1 = sp[4][i], c1 = sp[5][i];
      const float a2 = sp[6][i], b2 = sp[7][i], c2 = sp[8][i];
      const float wa = sp[9][i], wb = sp[10][i], wc = sp[11][i];
      const int f = sid[i];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float e0 = eval_plane(a0, b0, c0, px[k], py[k]);
        const float e1 = eval_plane(a1, b1, c1, px[k], py[k]);
        const float e2 = eval_plane(a2, b2, c2, px[k], py[k]);
        if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) {
          const float w = eval_plane(wa, wb, wc, px[k], py[k]);
          if (w > gw[k] || (w == gw[k] && f < gid[k])) {
            gw[k] = w;
            gid[k] = f;
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    if (gw[k] > bw[k]) {
      bw[k] = gw[k];
      bid[k] = gid[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads) raster_tiles_kernel(RasterArgs a) {
  __shared__ float sp[12][kChunk];
  __shared__ int sid[kChunk];

  const int tile = blockIdx.x;
  const int ty = tile / a.ntx0;
  const int tx = tile % a.ntx0;
  const int npix = a.th * a.tw;
  float px[kPixPerThread], py[kPixPerThread], bw[kPixPerThread];
  int bid[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int y = ty * a.th + p / a.tw;
    const int x = tx * a.tw + p % a.tw;
    px[k] = static_cast<float>(x) + 0.5f;
    py[k] = static_cast<float>(y) + 0.5f;
    bw[k] = -CUDART_INF_F;
    bid[k] = -1;
    if (a.s_w != nullptr && p < npix && y < a.H && x < a.W) {
      const int64_t o = static_cast<int64_t>(y) * a.W + x;
      bw[k] = a.s_w[o];
      bid[k] = a.s_id[o];
    }
  }

  // level 0: the tile's own list
  resolve_group(a.planes, a.cand[0] + static_cast<int64_t>(tile) * a.cap[0],
                min(a.cnt[0][tile], a.cap[0]), nullptr, 0, sp, sid, px, py,
                bw, bid);
  // level 1: the parent tile's list
  const int p1 = min(ty / a.s1, a.nty1 - 1) * a.ntx1 + min(tx / a.s1, a.ntx1 - 1);
  resolve_group(a.planes, a.cand[1] + static_cast<int64_t>(p1) * a.cap[1],
                min(a.cnt[1][p1], a.cap[1]), nullptr, 0, sp, sid, px, py, bw,
                bid);
  // level 2 + global: one group, the global list read in place
  const int p2 = min(ty / a.s2, a.nty2 - 1) * a.ntx2 + min(tx / a.s2, a.ntx2 - 1);
  resolve_group(a.planes, a.cand[2] + static_cast<int64_t>(p2) * a.cap[2],
                min(a.cnt[2][p2], a.cap[2]), a.cand[3],
                min(a.cnt[3][0], a.cap[3]), sp, sid, px, py, bw, bid);

#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= npix) continue;
    const int y = ty * a.th + p / a.tw;
    const int x = tx * a.tw + p % a.tw;
    if (y < a.H && x < a.W) a.out[static_cast<int64_t>(y) * a.W + x] = bid[k];
  }
}

}  // namespace

extern "C" int gg_raster_tiles(const void* planes, const void* cand0,
                               const void* cand1, const void* cand2,
                               const void* cand3, const void* cnt0,
                               const void* cnt1, const void* cnt2,
                               const void* cnt3, const void* s_w,
                               const void* s_id, void* out, int H, int W,
                               int tile_h, int tile_w, int nty0, int ntx0,
                               int nty1, int ntx1, int nty2, int ntx2, int s1,
                               int s2, int c0, int c1, int c2, int c3,
                               void* stream) {
  if (tile_h * tile_w > kThreads * kPixPerThread || tile_h < 1 || tile_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RasterArgs a;
  a.planes = static_cast<const float*>(planes);
  a.cand[0] = static_cast<const int*>(cand0);
  a.cand[1] = static_cast<const int*>(cand1);
  a.cand[2] = static_cast<const int*>(cand2);
  a.cand[3] = static_cast<const int*>(cand3);
  a.cnt[0] = static_cast<const int*>(cnt0);
  a.cnt[1] = static_cast<const int*>(cnt1);
  a.cnt[2] = static_cast<const int*>(cnt2);
  a.cnt[3] = static_cast<const int*>(cnt3);
  a.s_w = static_cast<const float*>(s_w);
  a.s_id = static_cast<const int*>(s_id);
  a.out = static_cast<int*>(out);
  a.H = H;
  a.W = W;
  a.th = tile_h;
  a.tw = tile_w;
  a.nty0 = nty0;
  a.ntx0 = ntx0;
  a.nty1 = nty1;
  a.ntx1 = ntx1;
  a.nty2 = nty2;
  a.ntx2 = ntx2;
  a.s1 = s1;
  a.s2 = s2;
  a.cap[0] = c0;
  a.cap[1] = c1;
  a.cap[2] = c2;
  a.cap[3] = c3;
  const int n_tiles = nty0 * ntx0;
  if (n_tiles > 0) {
    raster_tiles_kernel<<<n_tiles, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
