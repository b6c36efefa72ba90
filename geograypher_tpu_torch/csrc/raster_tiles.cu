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
// the background.  For the same reason the tensor cores are not used: a
// TF32 product would round the coefficients to 10 bits and flip pixels.
//
// Shape: one thread block per L0 tile (8 x 128 pixels by default), 8
// warps, each owning one compact rectangle of the tile (8 x 16 pixels,
// 4 per lane, by default; any tile of at most 1024 pixels is split into
// the 8 rectangles of least area, at most 8 pixels per lane).  The block
// walks three candidate groups in order -- its L0 list, its L1 parent's
// list, and its L2 parent's list followed by the single global list (read
// from one array, never copied per tile).
//
// What bounds it on the H100: FP32 instruction throughput, 16 FLOP per
// candidate-pixel, while a face needs only the pixels of its own box (a
// few tens); evaluated over the whole tile, every candidate costs 1024.
// The design cuts that work:
//  - Each warp culls the candidates against its own rectangle.  A lane
//    tests one candidate's box (setup.bbox, staged with its plane row),
//    32 at a time; __ballot_sync gives the warp the candidates that may
//    cover its rectangle, and it walks only those set bits.  The in-group
//    rule does not depend on order, so the compaction cannot change a
//    result.
//  - The cull never skips a pixel the plain version covers: a face is
//    culled only outside its box widened by 1 px, and only when
//    eval_plane.cuh's cull_rule says rounding cannot carry its coverage
//    that far (no coefficient above 2^18, no vertex sharper than the
//    rounding of its edges allows); sentinel rows are always culled.
//  - Plane rows (48 B, 16-byte aligned) and boxes are staged with cp.async
//    into a double-buffered chunk of 128 candidates, so the next chunk's
//    gather overlaps this chunk's evaluation.  Rows stay one per candidate
//    in shared memory: a warp walking one candidate reads a broadcast.
//
// Tie rules (pallas_raster.py raster_tiles_pallas docstring): inside a
// group the larger 1/z wins and an exact tie goes to the lower face id;
// across groups only a strictly larger 1/z replaces the earlier group's
// winner.
//
// Level-S carry (pallas_raster.py s_init): given the sub-tile raster's
// image-layout (best_w, best_id) planes (s_raster.cu), each pixel starts
// from its S winner instead of (-inf, -1), so an L0+ candidate beats an S
// winner only strictly -- the TPU kernel's rule.  The launcher first copies
// the S winners' ids into pix2face, so a tile whose lists are all empty
// (most tiles with level S on) exits after reading its counts.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "eval_plane.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // candidates staged in shared memory

struct RasterArgs {
  const float* planes;  // (F, 12): 3 edge planes (A, B, C) + 1/z plane
  const int* bbox;      // (4, F): first/last covered row, first/last column
  const int* cand[4];   // per-level face-id lists, -1 = empty slot
  const int* cnt[4];    // per-level true counts (face slots)
  const float* s_w;     // (H, W) level-S carry 1/z, or null
  const int* s_id;      // (H, W) level-S carry face id, or null
  int* out;             // (H, W) pix2face, -1 = background
  int64_t F;
  int H, W, th, tw;
  int nty0, ntx0, nty1, ntx1, nty2, ntx2, s1, s2;
  int cap[4];           // per-level list widths
  int wx, rh, rw;       // warp grid columns, warp rectangle rows x cols
};

// What the staging and the cull read, passed by value so that no device
// function takes the address of the kernel's parameter struct.
struct Src {
  const float* planes;
  const int* bbox;
  int64_t F;
  int H, W;
};

// One chunk of candidates: plane rows (3 x float4: a0 b0 c0 a1 | b1 c1 a2
// b2 | c2 wa wb wc), boxes (y0, x0, y1, x1) and face ids.
struct Chunk {
  float4 row[kChunk][3];
  int4 box[kChunk];
  int id[kChunk];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of candidates [base, base + m) of list la ++ lb.
__device__ __forceinline__ void stage(Chunk& c, const Src a,
                                      const int* __restrict__ la, int na,
                                      const int* __restrict__ lb, int base,
                                      int m) {
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int j = base + i;
    const int f = j < na ? la[j] : lb[j - na];
    c.id[i] = f;
    if (f >= 0) {
      const float* row = a.planes + static_cast<int64_t>(f) * 12;
      cp_async16(&c.row[i][0], row);
      cp_async16(&c.row[i][1], row + 4);
      cp_async16(&c.row[i][2], row + 8);
      cp_async4(&c.box[i].x, a.bbox + f);
      cp_async4(&c.box[i].y, a.bbox + a.F + f);
      cp_async4(&c.box[i].z, a.bbox + 2 * a.F + f);
      cp_async4(&c.box[i].w, a.bbox + 3 * a.F + f);
    }
  }
  cp_async_commit();
}

// This warp's pixels and inclusive rectangle (clipped to tile and image).
struct Warp {
  int lane, y0, x0, y1, x1;
};

// Resolve one candidate group (list ``la`` followed by list ``lb``) for
// this lane's pixels and merge its winner into (bw, bid).
template <int kPix>
__device__ __forceinline__ void resolve_group(
    const Src a, Chunk (&st)[2], const int* __restrict__ la, int na,
    const int* __restrict__ lb, int nb, const Warp& wp,
    const float (&px)[kPix], const float (&py)[kPix], float (&bw)[kPix],
    int (&bid)[kPix]) {
  const int n = na + nb;  // uniform across the block
  if (n == 0) return;
  float gw[kPix];
  int gid[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    gw[k] = -CUDART_INF_F;
    gid[k] = INT_MAX;
  }
  const int n_chunks = (n + kChunk - 1) / kChunk;
  stage(st[0], a, la, na, lb, 0, min(kChunk, n));
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int base = ci * kChunk;
    if (ci + 1 < n_chunks) {
      stage(st[(ci + 1) & 1], a, la, na, lb, base + kChunk,
            min(kChunk, n - base - kChunk));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ci has landed for every thread
    const Chunk& c = st[ci & 1];
    const int m = min(kChunk, n - base);
    for (int g = 0; g < m; g += 32) {
      const int j = g + wp.lane;
      bool hit = false;
      if (j < m && c.id[j] >= 0) {
        const float4 r0 = c.row[j][0];
        const float4 r1 = c.row[j][1];
        const float c2 = c.row[j][2].x;
        const int kind = cull_rule(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z,
                                   r1.w, c2, a.W, a.H);
        if (kind == kCullExempt) {
          hit = true;
        } else if (kind == kCullBox) {
          const int4 b = c.box[j];
          hit = b.x - kCullMargin <= wp.y1 && b.z + kCullMargin >= wp.y0 &&
                b.y - kCullMargin <= wp.x1 && b.w + kCullMargin >= wp.x0;
        }
      }
      unsigned mask = __ballot_sync(0xffffffffu, hit);
      while (mask) {
        const int i = g + __ffs(mask) - 1;
        mask &= mask - 1;
        const float4 q0 = c.row[i][0];
        const float4 q1 = c.row[i][1];
        const float4 q2 = c.row[i][2];
        const int f = c.id[i];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float e0 = eval_plane(q0.x, q0.y, q0.z, px[k], py[k]);
          const float e1 = eval_plane(q0.w, q1.x, q1.y, px[k], py[k]);
          const float e2 = eval_plane(q1.z, q1.w, q2.x, px[k], py[k]);
          if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) {
            const float w = eval_plane(q2.y, q2.z, q2.w, px[k], py[k]);
            if (w > gw[k] || (w == gw[k] && f < gid[k])) {
              gw[k] = w;
              gid[k] = f;
            }
          }
        }
      }
    }
    __syncthreads();  // chunk ci is consumed before it is refilled
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (gw[k] > bw[k]) {
      bw[k] = gw[k];
      bid[k] = gid[k];
    }
  }
}

// 64 registers a thread (4 blocks an SM) at 4 pixels a lane: the tiles
// whose lists are empty cost one round trip to memory, which only
// occupancy hides.
template <int kPix>
__global__ void __launch_bounds__(kThreads, kPix == 4 ? 4 : 2)
    raster_tiles_kernel(RasterArgs a) {
  __shared__ Chunk st[2];

  const int tile = blockIdx.x;
  const int ty = tile / a.ntx0;
  const int tx = tile % a.ntx0;
  const int warp = threadIdx.x / 32;
  // this warp's rectangle, in tile coordinates, then global
  const int ry = (warp / a.wx) * a.rh;
  const int rx = (warp % a.wx) * a.rw;
  const int rows = min(a.rh, a.th - ry);  // may be <= 0: an idle warp
  const int cols = min(a.rw, a.tw - rx);
  Warp wp;
  wp.lane = threadIdx.x % 32;
  wp.y0 = ty * a.th + ry;
  wp.x0 = tx * a.tw + rx;
  wp.y1 = min(wp.y0 + rows, a.H) - 1;
  wp.x1 = min(wp.x0 + cols, a.W) - 1;

  // the three groups' lists and counts, loaded before anything waits
  const int p1 = min(ty / a.s1, a.nty1 - 1) * a.ntx1 + min(tx / a.s1, a.ntx1 - 1);
  const int p2 = min(ty / a.s2, a.nty2 - 1) * a.ntx2 + min(tx / a.s2, a.ntx2 - 1);
  const int n0 = min(a.cnt[0][tile], a.cap[0]);
  const int n1 = min(a.cnt[1][p1], a.cap[1]);
  const int n2 = min(a.cnt[2][p2], a.cap[2]);
  const int n3 = min(a.cnt[3][0], a.cap[3]);
  const Src src{a.planes, a.bbox, a.F, a.H, a.W};
  if (n0 + n1 + n2 + n3 == 0) {  // uniform across the block
    // no candidate: every pixel keeps its level-S winner (already copied
    // into out by the launcher), or the background, written row by row so
    // that a warp stores whole rows
    if (a.s_id != nullptr) return;
    for (int p = threadIdx.x; p < a.th * a.tw; p += kThreads) {
      const int y = ty * a.th + p / a.tw;
      const int x = tx * a.tw + p % a.tw;
      if (y < a.H && x < a.W) a.out[static_cast<int64_t>(y) * a.W + x] = -1;
    }
    return;
  }

  float px[kPix], py[kPix], bw[kPix];
  int bid[kPix];
  bool own[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int q = wp.lane + 32 * k;
    const int ly = q / a.rw;
    const int lx = q % a.rw;
    const int y = wp.y0 + ly;
    const int x = wp.x0 + lx;
    own[k] = ly < rows && lx < cols && y < a.H && x < a.W;
    px[k] = static_cast<float>(x) + 0.5f;
    py[k] = static_cast<float>(y) + 0.5f;
    bw[k] = -CUDART_INF_F;
    bid[k] = -1;
    if (a.s_w != nullptr && own[k]) {
      const int64_t o = static_cast<int64_t>(y) * a.W + x;
      bw[k] = a.s_w[o];
      bid[k] = a.s_id[o];
    }
  }

  // level 0: the tile's own list
  resolve_group<kPix>(src, st, a.cand[0] + static_cast<int64_t>(tile) * a.cap[0],
                      n0, nullptr, 0, wp, px, py, bw, bid);
  // level 1: the parent tile's list
  resolve_group<kPix>(src, st, a.cand[1] + static_cast<int64_t>(p1) * a.cap[1],
                      n1, nullptr, 0, wp, px, py, bw, bid);
  // level 2 + global: one group, the global list read in place
  resolve_group<kPix>(src, st, a.cand[2] + static_cast<int64_t>(p2) * a.cap[2],
                      n2, a.cand[3], n3, wp, px, py, bw, bid);

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (own[k]) {
      const int y = wp.y0 + (wp.lane + 32 * k) / a.rw;
      const int x = wp.x0 + (wp.lane + 32 * k) % a.rw;
      a.out[static_cast<int64_t>(y) * a.W + x] = bid[k];
    }
  }
}

}  // namespace

extern "C" int gg_raster_tiles(const void* planes, const void* bbox,
                               const void* cand0, const void* cand1,
                               const void* cand2, const void* cand3,
                               const void* cnt0, const void* cnt1,
                               const void* cnt2, const void* cnt3,
                               const void* s_w, const void* s_id, void* out,
                               int64_t n_faces, int H, int W, int tile_h,
                               int tile_w, int nty0, int ntx0, int nty1,
                               int ntx1, int nty2, int ntx2, int s1, int s2,
                               int c0, int c1, int c2, int c3, void* stream) {
  if (tile_h * tile_w > 1024 || tile_h < 1 || tile_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  RasterArgs a;
  a.planes = static_cast<const float*>(planes);
  a.bbox = static_cast<const int*>(bbox);
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
  a.F = n_faces;
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
  // the 8 warps as the wy x wx grid of least rectangle area
  // (ops/raster_tiles.py warp_split)
  int best = INT_MAX;
  for (int wy = 1; wy <= kWarps; wy *= 2) {
    const int wx = kWarps / wy;
    const int rh = (tile_h + wy - 1) / wy;
    const int rw = (tile_w + wx - 1) / wx;
    if (rh * rw < best) {
      best = rh * rw;
      a.wx = wx;
      a.rh = rh;
      a.rw = rw;
    }
  }
  const int n_tiles = nty0 * ntx0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_id != nullptr) {
    // the level-S winners are the answer wherever a tile has no candidate:
    // one copy, and such tiles' blocks exit at once
    const cudaError_t err = cudaMemcpyAsync(
        out, s_id, static_cast<size_t>(H) * W * sizeof(int),
        cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_tiles > 0) {
    if (best <= 4 * 32) {
      raster_tiles_kernel<4><<<n_tiles, kThreads, 0, s>>>(a);
    } else {
      raster_tiles_kernel<8><<<n_tiles, kThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
