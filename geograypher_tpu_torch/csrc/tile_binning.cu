// Tile binning: face units -> per-level tile candidate lists, around one
// stable sort of int32 tile keys.
//
// Replaces no TPU kernel: geograypher_tpu/ops/rasterize.py bin_triangles
// (:556) builds its keys and cuts its lists in XLA around one jnp.sort;
// the port's plain version (ops/binning.py bin_triangles_plain) is about
// fifty eager launches: key build, torch.cat, the sort, searchsorted and
// per-level gathers.
//
// What bounds it on the H100: bytes.  The keys (a (tile, unit) slot of
// each unit's window) are written, sorted and read back; the lists (4
// bytes a slot, and at bin_block > 1 the face-id lists, bin_block times
// that) are written once.  Three launches and no host read:
//   1. keys_kernel, one thread a unit: the unit's box over its valid
//      members (bin_block consecutive faces), exclude_blocks and
//      global_from, the finest level whose window covers the box, and the
//      window's int32 tile keys (INT32_MAX for an unused slot), unit-major:
//      slot s of unit u at u * S + s, S = wy0 * wx0 slots a unit.  Thread 0
//      also zeroes the overflow and the census.
//   2. torch.sort(keys, stable=True) in the wrapper: CUB's radix sort,
//      which carries each key's int64 position along.  The plain version
//      sorts int64 keys tile * n_units + unit (8 radix passes); int32
//      tile keys take 4, and since a unit holds a tile once and units are
//      laid out in order, the stable order leaves the units of a tile
//      ascending, as the tie rules need: the same lists.  The JAX package
//      leaves its sort to XLA as well; a stable sort is deterministic.
//   3. lists_kernel, one warp a tile: the tile's start and end by binary
//      search over the sorted tile keys (searchsorted's side="left"), the
//      unit list (position / S) cut at the cap (-1 past the count), the
//      count clipped to the cap, the face-id lists and face counts the
//      raster kernel reads (at bin_block > 1), and per block the
//      overflow sum and the census maxima, merged by integer atomics.
// All of it is integer arithmetic: bit-equal to the plain version.
// At bin_block > 1 the chain reads only the counts and the face-id lists;
// the unit (block-id) lists are written for BinnedTriangles' other
// readers, which in the port are the comparisons with the plain version
// (chip_smoke.py, tests/test_torch_kernels_gpu.py).  Writing only what the
// chain reads, and comparing with expand_block_ids of the plain lists, is
// left for a later change.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxListBlocks = 132 * 16;

struct Level {
  int th, tw, ntx;
  int64_t base;
};

// floor division by a positive divisor (torch.div(..., "floor"))
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads)
    keys_kernel(const int* __restrict__ bbox, const uint8_t* __restrict__ valid,
                const uint8_t* __restrict__ exclude, int64_t n_units, int bb,
                int64_t global_from, Level l0, Level l1, Level l2,
                int64_t base3, int wy0, int wx0, int* __restrict__ keys,
                int64_t* __restrict__ stats) {
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (u == 0) {
    for (int k = 0; k < 5; ++k) stats[k] = 0;
  }
  if (u >= n_units) return;
  const int64_t n_faces = n_units * bb;
  // the unit's box: the union over its valid members
  int y0 = INT32_MAX, x0 = INT32_MAX, y1 = -1, x1 = -1;
  bool ok = false;
  for (int k = 0; k < bb; ++k) {
    const int64_t f = u * bb + k;
    if (valid[f]) {
      ok = true;
      y0 = min(y0, bbox[f]);
      x0 = min(x0, bbox[n_faces + f]);
      y1 = max(y1, bbox[2 * n_faces + f]);
      x1 = max(x1, bbox[3 * n_faces + f]);
    }
  }
  if (exclude != nullptr && exclude[u]) ok = false;

  const Level lv[3] = {l0, l1, l2};
  int64_t ty0[3], ty1[3], tx0[3], tx1[3];
  bool fits[3];
  const bool small = u * bb + (bb - 1) < global_from;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    ty0[l] = floor_div(y0, lv[l].th);
    ty1[l] = floor_div(y1, lv[l].th);
    tx0[l] = floor_div(x0, lv[l].tw);
    tx1[l] = floor_div(x1, lv[l].tw);
    const int wy = l == 0 ? wy0 : 2, wx = l == 0 ? wx0 : 2;
    fits[l] = ty1[l] - ty0[l] < wy && tx1[l] - tx0[l] < wx && small;
  }
  const bool at_l3 = !(fits[0] || fits[1] || fits[2]);
  const int s = fits[0] ? 0 : (fits[1] ? 1 : 2);
  const int64_t sy0 = s == 0 ? ty0[0] : (s == 1 ? ty0[1] : ty0[2]);
  const int64_t sy1 = s == 0 ? ty1[0] : (s == 1 ? ty1[1] : ty1[2]);
  const int64_t sx0 = s == 0 ? tx0[0] : (s == 1 ? tx0[1] : tx0[2]);
  const int64_t sx1 = s == 0 ? tx1[0] : (s == 1 ? tx1[1] : tx1[2]);
  const int64_t base = s == 0 ? l0.base : (s == 1 ? l1.base : l2.base);
  const int64_t ntx = s == 0 ? l0.ntx : (s == 1 ? l1.ntx : l2.ntx);
  for (int dy = 0; dy < wy0; ++dy) {
    for (int dx = 0; dx < wx0; ++dx) {
      const int64_t ty = sy0 + dy, tx = sx0 + dx;
      const bool in_window = ty <= sy1 && tx <= sx1;
      int64_t key = base + ty * ntx + tx;
      bool take;
      if (dy == 0 && dx == 0) {
        if (at_l3) key = base3;
        take = ok && (in_window || at_l3);
      } else {
        take = ok && in_window && !at_l3;
      }
      keys[u * (wy0 * wx0) + dy * wx0 + dx] =
          take ? static_cast<int>(key) : INT32_MAX;
    }
  }
}

struct LevelList {
  int* cand;         // (n_tiles, cap) unit ids
  int* counts;       // (n_tiles,) clipped to cap
  int* face_cand;    // (n_tiles, cap * bb) face ids (bb > 1)
  int* face_counts;  // (n_tiles,) clipped count * bb (bb > 1)
  int64_t base;      // first tile key of the level
  int n_tiles, cap;
};

// first index i with sorted[i] >= target
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ sorted,
                                               int64_t n, int64_t target) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (sorted[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    lists_kernel(const int* __restrict__ sorted, const int64_t* __restrict__ order,
                 int64_t n_keys, int slots, int bb, LevelList v0, LevelList v1,
                 LevelList v2, LevelList v3, int64_t total_tiles,
                 int census_only, unsigned long long* __restrict__ stats) {
  __shared__ unsigned long long s_over;
  __shared__ unsigned long long s_max[4];
  if (threadIdx.x == 0) {
    s_over = 0;
    for (int l = 0; l < 4; ++l) s_max[l] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       t < total_tiles; t += n_warps) {
    const int l = t >= v3.base ? 3 : (t >= v2.base ? 2 : (t >= v1.base ? 1 : 0));
    const LevelList& v = l == 0 ? v0 : (l == 1 ? v1 : (l == 2 ? v2 : v3));
    const int64_t local = t - v.base;
    // lane 0 finds the tile's start, lane 1 the next tile's
    int64_t bound = 0;
    if (lane < 2) bound = lower_bound(sorted, n_keys, t + lane);
    const int64_t start = __shfl_sync(0xffffffffu, bound, 0);
    const int64_t count = __shfl_sync(0xffffffffu, bound, 1) - start;
    if (lane == 0) {
      if (count > v.cap) atomicAdd(&s_over, static_cast<unsigned long long>(count - v.cap));
      if (census_only && count > 0)
        atomicMax(&s_max[l], static_cast<unsigned long long>(count));
    }
    if (census_only) continue;
    const int64_t kept = count < v.cap ? count : v.cap;
    for (int j = lane; j < v.cap; j += 32) {
      v.cand[local * v.cap + j] =
          j < kept ? static_cast<int>(order[start + j] / slots) : -1;
    }
    if (lane == 0) v.counts[local] = static_cast<int>(kept);
    if (bb > 1) {
      const int width = v.cap * bb;
      for (int k = lane; k < width; k += 32) {
        const int j = k / bb;
        v.face_cand[local * width + k] =
            j < kept ? static_cast<int>(order[start + j] / slots) * bb + (k - j * bb)
                     : -1;
      }
      if (lane == 0) v.face_counts[local] = static_cast<int>(kept) * bb;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_over) atomicAdd(stats, s_over);
    for (int l = 0; l < 4; ++l) {
      if (s_max[l]) atomicMax(stats + 1 + l, s_max[l]);
    }
  }
}

}  // namespace

// bbox (4, n_units * bb) int32, valid (n_units * bb,) bool, exclude
// (n_units,) bool or null; global_from: INT64_MAX for none; per level
// 0-2 the tile size th x tw, the tile columns ntx and the tile count;
// keys: (n_units * wy0 * wx0,) int32; stats: (5,) int64, zeroed here.
extern "C" int gg_tile_binning_keys(const void* bbox, const void* valid,
                                    const void* exclude, int64_t n_units,
                                    int bb, int64_t global_from, int th0,
                                    int tw0, int ntx0, int th1, int tw1,
                                    int ntx1, int th2, int tw2, int ntx2,
                                    int n_tiles0, int n_tiles1, int n_tiles2,
                                    int wy0, int wx0, void* keys, void* stats,
                                    void* stream) {
  const Level l0{th0, tw0, ntx0, 0};
  const Level l1{th1, tw1, ntx1, n_tiles0};
  const Level l2{th2, tw2, ntx2, static_cast<int64_t>(n_tiles0) + n_tiles1};
  const int64_t base3 = l2.base + n_tiles2;
  const int64_t want = (n_units + kThreads - 1) / kThreads;
  keys_kernel<<<static_cast<unsigned>(want > 0 ? want : 1), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bbox), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(exclude), n_units, bb, global_from, l0, l1,
      l2, base3, wy0, wx0, static_cast<int*>(keys),
      static_cast<int64_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// sorted: (n_keys,) int32 tile keys, stably sorted; order: their int64
// positions before the sort (unit * slots + slot); per level 0-3 the tile count, the cap
// and the unit lists, counts, face lists and face counts (all null with
// census_only; the face ones unread at bb == 1); stats: overflow, then the
// census (4,).
extern "C" int gg_tile_binning_lists(
    const void* sorted, const void* order, int64_t n_keys, int slots, int bb,
    int n_tiles0,
    int n_tiles1, int n_tiles2, int n_tiles3, int cap0, int cap1, int cap2,
    int cap3, void* cand0, void* counts0, void* face_cand0,
    void* face_counts0, void* cand1, void* counts1, void* face_cand1,
    void* face_counts1, void* cand2, void* counts2, void* face_cand2,
    void* face_counts2, void* cand3, void* counts3, void* face_cand3,
    void* face_counts3, int census_only, void* stats, void* stream) {
  const int64_t b1 = n_tiles0, b2 = b1 + n_tiles1, b3 = b2 + n_tiles2;
  const LevelList v0{static_cast<int*>(cand0), static_cast<int*>(counts0),
                     static_cast<int*>(face_cand0),
                     static_cast<int*>(face_counts0), 0, n_tiles0, cap0};
  const LevelList v1{static_cast<int*>(cand1), static_cast<int*>(counts1),
                     static_cast<int*>(face_cand1),
                     static_cast<int*>(face_counts1), b1, n_tiles1, cap1};
  const LevelList v2{static_cast<int*>(cand2), static_cast<int*>(counts2),
                     static_cast<int*>(face_cand2),
                     static_cast<int*>(face_counts2), b2, n_tiles2, cap2};
  const LevelList v3{static_cast<int*>(cand3), static_cast<int*>(counts3),
                     static_cast<int*>(face_cand3),
                     static_cast<int*>(face_counts3), b3, n_tiles3, cap3};
  const int64_t total = b3 + n_tiles3;
  const int64_t want = (total + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < kMaxListBlocks ? want : kMaxListBlocks);
  lists_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted), static_cast<const int64_t*>(order), n_keys,
      slots, bb, v0, v1, v2, v3, total, census_only,
      static_cast<unsigned long long*>(stats));
  return static_cast<int>(cudaGetLastError());
}
