// Tile binning: face units -> per-level tile candidate lists, by counting.
//
// Replaces no TPU kernel: geograypher_tpu/ops/rasterize.py bin_triangles
// (:556) builds its keys and cuts its lists in XLA around one jnp.sort;
// the port's plain version (ops/binning.py bin_triangles_plain) is about
// fifty eager launches: key build, torch.cat, the sort, searchsorted and
// per-level gathers.
//
// What bounds it on the H100: bytes.  Each unit's box (17 bytes) is read
// and the lists (4 bytes a slot, and at bin_block > 1 the face-id lists,
// bin_block times that) are written once.  No global sort, no host read,
// one C entry point (gg_tile_binning) that launches on the caller's stream:
//   0. a memset of the (total_tiles,) int32 tile counts and the
//      long-segment queue's two counts;
//   1. count_kernel: each block takes a contiguous range of units (at most
//      one wave of blocks) and computes each unit's window keys
//      (unit_window and slot_key, the rule the scatter shares, in 32-bit
//      arithmetic; a warp visits only the window slots its lanes use).
//      Runs of equal keys in neighbouring lanes (a sorted mesh sends
//      neighbouring units to one tile) are merged by one shuffle and one
//      ballot and counted in a shared-memory histogram of every tile,
//      flushed with one integer atomicAdd a non-zero bin.  A grid whose
//      histogram does not fit shared memory (more than kMaxSharedBins tiles)
//      takes the kernel's other instantiation, which counts with global
//      atomics;
//   2. scan_kernel, one block, each thread 8 neighbouring tiles a pass,
//      read and written as int4 vectors: the exclusive scan of the counts
//      (each tile's segment start, written as its scatter cursor), the
//      overflow (the sum of max(count - cap, 0)) and the per-level census
//      maxima into the (5,) int64 stats.  The census stops here: two
//      launches after the memset and no memory a key;
//   3. scatter_kernel: the keys again (rereading 17 bytes a unit costs
//      less than writing and reading 4 x wy0 x wx0), each run of equal
//      keys claiming its slots in its tile's segment by one atomicAdd on
//      the tile's cursor, the unit ids written there.  Order inside a
//      segment is arbitrary.  The segment buffer holds n_units x wy0 x
//      wx0 ids, so that no total is read back;
//   4. cut_kernel, a warp a tile: the clipped count, -1 past it in the
//      row (and at bin_block > 1 the face counts and face-id lists the
//      raster kernel reads), and the segment's (start = cursor - count)
//      min(count, cap) smallest ids written in ascending order: up to
//      kWarpSortMax ids sorted in registers (a bitonic network over
//      shuffles).  A longer segment is queued for cut_long_kernel: a warp
//      a tile sorts up to kMidSortMax ids in registers, and a block a
//      tile cuts a longer one by bitmap windows of kBitmapWords x 32 unit
//      ids from its smallest id: a unit holds a tile once, so the set bits
//      of a window, scanned in order, are the next ranks, and the windows
//      stop once the cap is reached.
// All of it is integer arithmetic and every list is sorted before it is
// written: bit-equal to the plain version, and the same on every run.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;         // count, scatter and cut blocks
constexpr int kScanThreads = 1024;    // the one scan block
constexpr int kScanItems = 8;         // tiles a scan thread takes a pass (two int4)
constexpr int kWarpSortMax = 256;     // the cut kernel's warps sort in registers
constexpr int kMidSortMax = 512;      // the long-segment kernel's warps too
constexpr int kBitmapWords = 4096;    // the long-segment kernel's bitmap window
constexpr int kMinUnits = 1024;       // the least units a count block takes
constexpr int kMaxSharedBins = 57344;  // 224 KiB of shared histogram
constexpr int kSmemPerSm = 233472;     // an H100 SM's shared memory, bytes
constexpr int kMaxDevices = 64;
static_assert(kBitmapWords % (4 * kThreads) == 0, "a thread's bitmap words are uint4 loads");

struct Level {
  int th, tw, ntx, base;
  float inv_th, inv_tw;  // 1 / th and 1 / tw, rounded
};

// what the key rule reads besides the unit's faces
struct Grid {
  Level l0, l1, l2;
  int base3;            // the global list's key
  int64_t global_from;  // first face of the oversized tail (INT64_MAX: none)
  int bb, wy0, wx0;
};

// a unit's window: its level's first key and tile columns, the tile rows
// y0..y1 and columns x0..x1 its box covers there.  Every key is below
// the tile count, an int32 (the wrapper checks), so the window's
// arithmetic is 32-bit: 64-bit divisions took most of the time of the
// key kernel this one replaced.  A unit with no valid face returns before
// any division.
struct Window {
  int base, ntx, y0, y1, x0, x1;
  bool ok, at_l3;
};

// floor division by a positive divisor b (torch.div(..., "floor")).  For
// 0 <= a < 2^22, a * (1 / b) in float is within one half of a / b, so its
// truncation is floor(a / b) or one off, which one integer test each way
// corrects: exact, and a few instructions where an integer division by a
// value known only at run time costs some twenty.  Other a take the
// unsigned division.
__device__ __forceinline__ int floor_div(int a, int b, float inv_b) {
  if (static_cast<unsigned>(a) < (1u << 22)) {
    int q = static_cast<int>(static_cast<float>(a) * inv_b);
    if (q * b > a) {
      --q;
    } else if ((q + 1) * b <= a) {
      ++q;
    }
    return q;
  }
  const unsigned d = static_cast<unsigned>(b);
  return a >= 0 ? static_cast<int>(static_cast<unsigned>(a) / d)
                : -1 - static_cast<int>(static_cast<unsigned>(-(a + 1)) / d);
}

// The unit's box over its valid members (bin_block consecutive faces),
// exclude_blocks and global_from, and the finest level whose window covers
// the box (level 3, the global list, when none does).  A unit out of
// range has no window.
__device__ __forceinline__ Window unit_window(const int* __restrict__ bbox,
                                              const uint8_t* __restrict__ valid,
                                              const uint8_t* __restrict__ exclude,
                                              int64_t n_units, int64_t u, bool in_range,
                                              const Grid& g) {
  Window w{0, 0, 0, -1, 0, -1, false, false};
  if (!in_range) return w;
  const int bb = g.bb;
  const int64_t n_faces = n_units * bb;
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
  if (!ok || (exclude != nullptr && exclude[u])) return w;  // no key

  w.ok = true;
  // a unit of the oversized tail goes global unconditionally
  w.at_l3 = u * bb + (bb - 1) >= g.global_from;
  // the levels from the finest, each computed only when the finer one
  // does not fit (most units fit level 0)
  for (int l = 0; !w.at_l3; ++l) {
    const Level& v = l == 0 ? g.l0 : (l == 1 ? g.l1 : g.l2);
    w.y0 = floor_div(y0, v.th, v.inv_th);
    w.y1 = floor_div(y1, v.th, v.inv_th);
    w.x0 = floor_div(x0, v.tw, v.inv_tw);
    w.x1 = floor_div(x1, v.tw, v.inv_tw);
    w.base = v.base;
    w.ntx = v.ntx;
    if (w.y1 - w.y0 < (l == 0 ? g.wy0 : 2) && w.x1 - w.x0 < (l == 0 ? g.wx0 : 2)) break;
    w.at_l3 = l == 2;
  }
  return w;
}

// The tile key of slot (dy, dx) of a unit's window, -1 for an unused
// slot: a unit at level 3 holds the global list in slot (0, 0) only.
__device__ __forceinline__ int slot_key(const Window& w, int dy, int dx, int base3) {
  if (!w.ok) return -1;
  if (w.at_l3) return dy == 0 && dx == 0 ? base3 : -1;
  const int ty = w.y0 + dy, tx = w.x0 + dx;
  if (ty > w.y1 || tx > w.x1) return -1;
  return w.base + ty * w.ntx + tx;
}

// the window's rows and columns a warp must visit: the most any of its
// lanes uses (a unit at level 3 one slot, a unit with no key none; most
// units cover one tile, so most warps visit one slot of wy0 x wx0).
// Every lane of the warp must call it.
__device__ __forceinline__ void warp_extent(const Window& w, int* rows, int* cols) {
  const bool in_tiles = w.ok && !w.at_l3;
  *rows = static_cast<int>(__reduce_max_sync(
      kFull, static_cast<unsigned>(in_tiles ? w.y1 - w.y0 + 1 : w.ok)));
  *cols = static_cast<int>(__reduce_max_sync(
      kFull, static_cast<unsigned>(in_tiles ? w.x1 - w.x0 + 1 : w.ok)));
}

// exclusive scan of one int a thread over a block of kN threads; *total
// gets the block's sum.  s_warp holds 33 ints.  Every thread must call it.
template <int kN>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < kN / 32 ? s_warp[lane] : 0;
    int acc = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, acc, o);
      if (lane >= o) acc += t;
    }
    if (lane < kN / 32) s_warp[lane] = acc - mine;
    if (lane == 31) s_warp[32] = acc;
  }
  __syncthreads();
  const int out = s_warp[warp] + incl - v;
  *total = s_warp[32];
  __syncthreads();  // s_warp is free again
  return out;
}

// Runs of equal keys in neighbouring lanes (a sorted mesh sends
// neighbouring units to one tile): `starts` has a bit at each lane whose
// key differs from the lane before; a run is its start lane up to the next
// start.  Cheaper than __match_any_sync, which pays for keys it never
// merges.  Every lane of the warp must call it.
__device__ __forceinline__ unsigned run_starts(int key, int lane) {
  const int prev = __shfl_up_sync(kFull, key, 1);
  return __ballot_sync(kFull, lane == 0 || prev != key);
}

// the length of the run that starts at `lane`
__device__ __forceinline__ int run_length(unsigned starts, int lane) {
  const unsigned later = starts & ~((2u << lane) - 1);  // 2u << 31 == 0
  return (later ? __ffs(later) - 1 : 32) - lane;
}

// 1. per-tile counts of (tile, unit) keys
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const int* __restrict__ bbox, const uint8_t* __restrict__ valid,
                 const uint8_t* __restrict__ exclude, int64_t n_units, Grid g,
                 int64_t per_block, int total_tiles, int* __restrict__ counts) {
  extern __shared__ int s_hist[];
  int* hist = kShared ? s_hist : counts;
  if (kShared) {
    for (int b = threadIdx.x; b < total_tiles; b += kThreads) s_hist[b] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < n_units ? begin + per_block : n_units;
  for (int64_t first = begin; first < end; first += kThreads) {
    const int64_t u = first + threadIdx.x;
    const Window w = unit_window(bbox, valid, exclude, n_units, u, u < end, g);
    int rows, cols;
    warp_extent(w, &rows, &cols);
    for (int dy = 0; dy < rows; ++dy) {
      for (int dx = 0; dx < cols; ++dx) {
        const int key = slot_key(w, dy, dx, g.base3);
        const unsigned starts = run_starts(key, lane);
        if (key >= 0 && (starts >> lane & 1u))
          atomicAdd(hist + key, run_length(starts, lane));
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < total_tiles; b += kThreads) {
      const int c = s_hist[b];
      if (c) atomicAdd(counts + b, c);
    }
  }
}

struct Bases {
  int b1, b2, b3;  // first tile of levels 1, 2 and 3 (the global list)
  int cap[4];
};

__device__ __forceinline__ int level_of(int t, const Bases& lb) {
  return t >= lb.b3 ? 3 : (t >= lb.b2 ? 2 : (t >= lb.b1 ? 1 : 0));
}

// 2. segment starts (as cursors), overflow and census.  Passes of
// kScanThreads x kScanItems tiles, each thread kScanItems neighbours read
// and written as int4 vectors (counts and cursors are 16-byte aligned; a
// single SM pays dearly for strided scalar accesses), one block scan a
// pass.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ counts, int total_tiles, Bases lb,
                int* __restrict__ cursor, int64_t* __restrict__ stats) {
  __shared__ int s_warp[33];
  __shared__ unsigned long long s_over;
  __shared__ int s_max[4];
  if (threadIdx.x == 0) {
    s_over = 0;
    for (int l = 0; l < 4; ++l) s_max[l] = 0;
  }
  // s_over and s_max are first touched after the scan's barriers
  long long over = 0;
  int mx[4] = {0, 0, 0, 0};
  int carry = 0;
  for (int first = 0; first < total_tiles; first += kScanThreads * kScanItems) {
    const int t0 = first + threadIdx.x * kScanItems;
    const bool whole = t0 + kScanItems <= total_tiles;
    int c[kScanItems];
    if (whole) {
#pragma unroll
      for (int v = 0; v < kScanItems / 4; ++v) {
        const int4 q = reinterpret_cast<const int4*>(counts + t0)[v];
        c[4 * v] = q.x;
        c[4 * v + 1] = q.y;
        c[4 * v + 2] = q.z;
        c[4 * v + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kScanItems; ++i) c[i] = t0 + i < total_tiles ? counts[t0 + i] : 0;
    }
    int sum = 0, before[kScanItems];
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (t0 + i < total_tiles) {
        const int l = level_of(t0 + i, lb);
        if (c[i] > lb.cap[l]) over += c[i] - lb.cap[l];
        mx[l] = max(mx[l], c[i]);
      }
      before[i] = sum;
      sum += c[i];
    }
    int total;
    const int offset = carry + block_exclusive_scan<kScanThreads>(sum, s_warp, &total);
    if (whole) {
#pragma unroll
      for (int v = 0; v < kScanItems / 4; ++v) {
        reinterpret_cast<int4*>(cursor + t0)[v] =
            make_int4(offset + before[4 * v], offset + before[4 * v + 1],
                      offset + before[4 * v + 2], offset + before[4 * v + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kScanItems; ++i) {
        if (t0 + i < total_tiles) cursor[t0 + i] = offset + before[i];
      }
    }
    carry += total;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    over += __shfl_down_sync(kFull, over, o);
#pragma unroll
    for (int l = 0; l < 4; ++l) mx[l] = max(mx[l], __shfl_down_sync(kFull, mx[l], o));
  }
  if ((threadIdx.x & 31) == 0) {
    if (over) atomicAdd(&s_over, static_cast<unsigned long long>(over));
    for (int l = 0; l < 4; ++l) {
      if (mx[l]) atomicMax(&s_max[l], mx[l]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    stats[0] = static_cast<int64_t>(s_over);
    for (int l = 0; l < 4; ++l) stats[1 + l] = s_max[l];
  }
}

// 3. every key's unit id into its tile's segment, in no fixed order
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ bbox, const uint8_t* __restrict__ valid,
                   const uint8_t* __restrict__ exclude, int64_t n_units, Grid g,
                   int64_t per_block, int* __restrict__ cursor, int* __restrict__ seg) {
  const int lane = threadIdx.x & 31;
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1;  // lanes <= this one
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < n_units ? begin + per_block : n_units;
  for (int64_t first = begin; first < end; first += kThreads) {
    const int64_t u = first + threadIdx.x;
    const Window w = unit_window(bbox, valid, exclude, n_units, u, u < end, g);
    int rows, cols;
    warp_extent(w, &rows, &cols);
    for (int dy = 0; dy < rows; ++dy) {
      for (int dx = 0; dx < cols; ++dx) {
        const int key = slot_key(w, dy, dx, g.base3);
        const unsigned starts = run_starts(key, lane);
        const int head = 31 - __clz(starts & upto);  // the start of this lane's run
        int pos = 0;
        if (key >= 0 && head == lane) pos = atomicAdd(cursor + key, run_length(starts, lane));
        pos = __shfl_sync(kFull, pos, head);
        if (key >= 0) seg[pos + lane - head] = static_cast<int>(u);
      }
    }
  }
}

struct LevelList {
  int* cand;         // (n_tiles, cap) unit ids
  int* counts;       // (n_tiles,) clipped to cap
  int* face_cand;    // (n_tiles, cap * bb) face ids (bb > 1)
  int* face_counts;  // (n_tiles,) clipped count * bb (bb > 1)
  int base;          // first tile key of the level
  int cap;
};

struct Lists {
  LevelList v[4];
  int bb;
};

__device__ __forceinline__ LevelList level_list(const Lists& ls, int t) {
  if (t >= ls.v[3].base) return ls.v[3];
  if (t >= ls.v[2].base) return ls.v[2];
  if (t >= ls.v[1].base) return ls.v[1];
  return ls.v[0];
}

// unit id `id` at rank r of a tile's row, and its bb face ids
__device__ __forceinline__ void put(int* row, int* face_row, int bb, int r, int id) {
  row[r] = id;
  if (bb > 1) {
    for (int e = 0; e < bb; ++e) face_row[static_cast<int64_t>(r) * bb + e] = id * bb + e;
  }
}

// A warp sorts n <= 32 * E ids in registers (bitonic, E a lane, element
// lane * E + e; INT32_MAX pads) and writes the `kept` smallest.
template <int E>
__device__ __forceinline__ void warp_sort_cut(const int* __restrict__ ids, int n, int kept,
                                              int* row, int* face_row, int bb, int lane) {
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    v[e] = i < n ? ids[i] : INT32_MAX;
  }
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {  // the partner lies in lane ^ (j / E), same slot
        const bool lower = (lane & (j / E)) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int other = __shfl_xor_sync(kFull, v[e], j / E);
          const bool up = ((lane * E + e) & k) == 0;
          v[e] = lower == up ? min(v[e], other) : max(v[e], other);
        }
      } else {  // the partner is slot e ^ j of this lane
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e ^ j) > e) {
            const bool up = ((lane * E + e) & k) == 0;
            const int a = v[e], b = v[e ^ j];
            v[e] = up ? min(a, b) : max(a, b);
            v[e ^ j] = up ? max(a, b) : min(a, b);
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (lane * E + e < kept) put(row, face_row, bb, lane * E + e, v[e]);
  }
}

// 4a. each tile's list, a warp a tile: the clipped counts, -1 past them,
// and a segment of up to kWarpSortMax ids sorted in registers.  A longer
// segment is queued for the long-segment kernel: up to kMidSortMax ids at
// the front of `queue` (n_queued[0] of them), longer ones at its back
// (n_queued[1]).  Sorting up to kMidSortMax ids here would cost every warp
// registers (80 against 64) and the kernel occupancy.
__global__ void __launch_bounds__(kThreads)
    cut_kernel(const int* __restrict__ counts, const int* __restrict__ cursor,
               const int* __restrict__ seg, int total_tiles, Lists ls,
               int* __restrict__ n_queued, int* __restrict__ queue) {
  const int lane = threadIdx.x & 31;
  const int bb = ls.bb;
  const int warps = gridDim.x * (kThreads / 32);
  for (int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); t < total_tiles;
       t += warps) {
    const LevelList v = level_list(ls, t);
    const int64_t local = t - v.base;
    const int n = counts[t];
    const int kept = min(n, v.cap);
    const int* ids = seg + (cursor[t] - n);  // the scatter left the cursor at the end
    int* row = v.cand + local * v.cap;
    int* face_row = v.face_cand + local * v.cap * bb;
    if (lane == 0) {
      v.counts[local] = kept;
      if (bb > 1) v.face_counts[local] = kept * bb;
    }
    for (int j = kept + lane; j < v.cap; j += 32) row[j] = -1;
    if (bb > 1) {
      const int64_t width = static_cast<int64_t>(v.cap) * bb;
      for (int64_t k = static_cast<int64_t>(kept) * bb + lane; k < width; k += 32)
        face_row[k] = -1;
    }
    if (kept == 0) continue;
    if (n <= 32) {
      warp_sort_cut<1>(ids, n, kept, row, face_row, bb, lane);
    } else if (n <= 64) {
      warp_sort_cut<2>(ids, n, kept, row, face_row, bb, lane);
    } else if (n <= 128) {
      warp_sort_cut<4>(ids, n, kept, row, face_row, bb, lane);
    } else if (n <= kWarpSortMax) {
      warp_sort_cut<8>(ids, n, kept, row, face_row, bb, lane);
    } else if (lane == 0) {
      if (n <= kMidSortMax) {
        queue[atomicAdd(n_queued, 1)] = t;
      } else {
        queue[total_tiles - 1 - atomicAdd(n_queued + 1, 1)] = t;
      }
    }
  }
}

// a bitmap word's slot in the rank array: one int of padding every 16
// words, so that a thread's run of 16 words and a warp's 32 neighbouring
// words each fall in distinct banks
__device__ __forceinline__ int rank_slot(int word) { return word + (word >> 4); }

// 4b. the queued segments: up to kMidSortMax ids a warp a tile, sorted in
// registers; longer ones a block a tile, cut by bitmap windows of
// kBitmapWords * 32 ids from the segment's smallest id
__global__ void __launch_bounds__(kThreads)
    cut_long_kernel(const int* __restrict__ counts, const int* __restrict__ cursor,
                    const int* __restrict__ seg, int total_tiles, Lists ls,
                    const int* __restrict__ n_queued, const int* __restrict__ queue) {
  __shared__ __align__(16) unsigned bits[kBitmapWords];
  __shared__ int rank[kBitmapWords + kBitmapWords / 16];
  __shared__ int s_warp[33];
  __shared__ int s_lo;
  const int bb = ls.bb;
  const int lane = threadIdx.x & 31;
  const int mid = n_queued[0];
  for (int q = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); q < mid;
       q += gridDim.x * (kThreads / 32)) {
    const int t = queue[q];
    const LevelList v = level_list(ls, t);
    const int64_t local = t - v.base;
    const int n = counts[t];
    warp_sort_cut<kMidSortMax / 32>(seg + (cursor[t] - n), n, min(n, v.cap),
                                    v.cand + local * v.cap,
                                    v.face_cand + local * v.cap * bb, bb, lane);
  }
  const int queued = n_queued[1];
  for (int q = blockIdx.x; q < queued; q += gridDim.x) {
    const int t = queue[total_tiles - 1 - q];
    const LevelList v = level_list(ls, t);
    const int64_t local = t - v.base;
    const int n = counts[t];
    const int start = cursor[t] - n;
    const int kept = min(n, v.cap);
    int* row = v.cand + local * v.cap;
    int* face_row = v.face_cand + local * v.cap * bb;

    if (threadIdx.x == 0) s_lo = INT32_MAX;
    int lo = INT32_MAX;
    for (int i = threadIdx.x; i < n; i += kThreads) lo = min(lo, seg[start + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lo = min(lo, __shfl_down_sync(kFull, lo, o));
    __syncthreads();  // s_lo's initial value is visible
    if ((threadIdx.x & 31) == 0) atomicMin(&s_lo, lo);
    __syncthreads();
    constexpr int per = kBitmapWords / kThreads;  // bitmap words a thread
    constexpr int64_t span = static_cast<int64_t>(kBitmapWords) * 32;
    int base = 0;  // rank of the window's first id
    for (int64_t w0 = s_lo; base < kept && w0 <= INT32_MAX; w0 += span) {
      for (int i = threadIdx.x; i < kBitmapWords; i += kThreads) bits[i] = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int64_t off = seg[start + i] - w0;
        if (off >= 0 && off < span) atomicOr(bits + (off >> 5), 1u << (off & 31));
      }
      __syncthreads();
      // each thread's run of `per` words, read as uint4 vectors (a word a
      // load would be a 16-way bank conflict)
      unsigned wd[per];
#pragma unroll
      for (int v = 0; v < per / 4; ++v) {
        const uint4 q = reinterpret_cast<const uint4*>(bits + threadIdx.x * per)[v];
        wd[4 * v] = q.x;
        wd[4 * v + 1] = q.y;
        wd[4 * v + 2] = q.z;
        wd[4 * v + 3] = q.w;
      }
      int mine = 0;
#pragma unroll
      for (int k = 0; k < per; ++k) mine += __popc(wd[k]);
      int total;
      int r = block_exclusive_scan<kThreads>(mine, s_warp, &total);
#pragma unroll
      for (int k = 0; k < per; ++k) {  // each word's first rank in the window
        rank[rank_slot(threadIdx.x * per + k)] = r;
        r += __popc(wd[k]);
      }
      __syncthreads();
      // a word a thread in turn: the ids of a narrow id range spread over
      // the block (a thread's own run of words would write them alone)
      for (int word = threadIdx.x; word < kBitmapWords; word += kThreads) {
        unsigned m = bits[word];
        for (int j = base + rank[rank_slot(word)]; m && j < kept; ++j) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          put(row, face_row, bb, j, static_cast<int>(w0 + word * 32 + bit));
        }
      }
      base += total;
      __syncthreads();  // the bitmap and ranks are rewritten next
    }
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 1;
  }
  return cached[dev];
}

cudaError_t allow_shared_histogram() {
  static bool done[kMaxDevices] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      count_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSharedBins * static_cast<int>(sizeof(int)));
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

// the count and scatter grid: at most one wave of blocks, each a
// contiguous range of at least kMinUnits units (each block pays for
// zeroing and flushing its histogram); and the count kernel's shared
// memory (0 for the global-atomic histogram)
struct CountLaunch {
  int blocks;
  int64_t per_block;
  int smem;
  bool shared;
};

CountLaunch count_launch(int64_t n_units, int total_tiles) {
  CountLaunch c;
  c.shared = total_tiles <= kMaxSharedBins;
  c.smem = c.shared ? total_tiles * static_cast<int>(sizeof(int)) : 0;
  const int by_smem = kSmemPerSm / (c.smem + 1024);
  const int per_sm = by_smem < 2048 / kThreads ? by_smem : 2048 / kThreads;
  const int64_t want = (n_units + kMinUnits - 1) / kMinUnits;
  const int64_t wave = static_cast<int64_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  c.blocks = static_cast<int>(want < wave ? (want > 0 ? want : 1) : wave);
  c.per_block = (n_units + c.blocks - 1) / c.blocks;
  return c;
}

}  // namespace

// bbox (4, n_units * bb) int32, valid (n_units * bb,) bool, exclude
// (n_units,) bool or null; global_from: INT64_MAX for none; per level 0-2
// the tile size th x tw and the tile columns ntx, then the tile counts;
// the level-0 window wy0 x wx0; per level 0-3 the cap and the unit lists,
// counts, face lists and face counts (all null with census_only; the face
// ones unread at bb == 1); scratch: 16-byte aligned, (total_tiles + 5) / 4
// * 4 + 2 * total_tiles + n_units * wy0 * wx0 int32 (tile counts and the
// two queue counts, padded; cursors, the long-segment queue, segments;
// the census needs the padded counts and the cursors); stats: (5,)
// int64, the overflow then the census, written here.
extern "C" int gg_tile_binning(
    const void* bbox, const void* valid, const void* exclude, int64_t n_units, int bb,
    int64_t global_from, int th0, int tw0, int ntx0, int th1, int tw1, int ntx1,
    int th2, int tw2, int ntx2, int n_tiles0, int n_tiles1, int n_tiles2, int wy0,
    int wx0, int cap0, int cap1, int cap2, int cap3, void* cand0, void* counts0,
    void* face_cand0, void* face_counts0, void* cand1, void* counts1, void* face_cand1,
    void* face_counts1, void* cand2, void* counts2, void* face_cand2,
    void* face_counts2, void* cand3, void* counts3, void* face_cand3,
    void* face_counts3, void* scratch, int census_only, void* stats, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b1 = n_tiles0, b2 = b1 + n_tiles1, b3 = b2 + n_tiles2;
  const int total = b3 + 1;
  Grid g;
  g.l0 = Level{th0, tw0, ntx0, 0, 1.0f / th0, 1.0f / tw0};
  g.l1 = Level{th1, tw1, ntx1, b1, 1.0f / th1, 1.0f / tw1};
  g.l2 = Level{th2, tw2, ntx2, b2, 1.0f / th2, 1.0f / tw2};
  g.base3 = b3;
  g.global_from = global_from;
  g.bb = bb;
  g.wy0 = wy0;
  g.wx0 = wx0;
  int* counts = static_cast<int*>(scratch);
  int* n_queued = counts + total;
  int* cursor = counts + (total + 5) / 4 * 4;  // 16-byte aligned, as counts
  int* queue = cursor + total;
  int* seg = queue + total;
  const auto* box = static_cast<const int*>(bbox);
  const auto* ok = static_cast<const uint8_t*>(valid);
  const auto* ex = static_cast<const uint8_t*>(exclude);

  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (total + 2), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CountLaunch c = count_launch(n_units, total);
  if (c.shared) {
    if (c.smem > 48 * 1024 && (err = allow_shared_histogram()) != cudaSuccess)
      return static_cast<int>(err);
    count_kernel<true><<<c.blocks, kThreads, c.smem, st>>>(box, ok, ex, n_units, g,
                                                           c.per_block, total, counts);
  } else {
    count_kernel<false><<<c.blocks, kThreads, 0, st>>>(box, ok, ex, n_units, g,
                                                       c.per_block, total, counts);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const Bases lb{b1, b2, b3, {cap0, cap1, cap2, cap3}};
  scan_kernel<<<1, kScanThreads, 0, st>>>(counts, total, lb, cursor,
                                          static_cast<int64_t*>(stats));
  if ((err = cudaGetLastError()) != cudaSuccess || census_only)
    return static_cast<int>(err);

  scatter_kernel<<<c.blocks, kThreads, 0, st>>>(box, ok, ex, n_units, g, c.per_block,
                                                cursor, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  Lists ls;
  ls.v[0] = LevelList{static_cast<int*>(cand0), static_cast<int*>(counts0),
                      static_cast<int*>(face_cand0), static_cast<int*>(face_counts0), 0,
                      cap0};
  ls.v[1] = LevelList{static_cast<int*>(cand1), static_cast<int*>(counts1),
                      static_cast<int*>(face_cand1), static_cast<int*>(face_counts1), b1,
                      cap1};
  ls.v[2] = LevelList{static_cast<int*>(cand2), static_cast<int*>(counts2),
                      static_cast<int*>(face_cand2), static_cast<int*>(face_counts2), b2,
                      cap2};
  ls.v[3] = LevelList{static_cast<int*>(cand3), static_cast<int*>(counts3),
                      static_cast<int*>(face_cand3), static_cast<int*>(face_counts3), b3,
                      cap3};
  ls.bb = bb;
  const int wave = sm_count() * (2048 / kThreads);
  const int want = (total + kThreads / 32 - 1) / (kThreads / 32);
  cut_kernel<<<want < wave ? want : wave, kThreads, 0, st>>>(counts, cursor, seg, total, ls,
                                                             n_queued, queue);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  cut_long_kernel<<<sm_count(), kThreads, 0, st>>>(counts, cursor, seg, total, ls, n_queued,
                                                   queue);
  return static_cast<int>(cudaGetLastError());
}
