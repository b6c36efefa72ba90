// Fixed-order per-segment float sums: keys (N,) and values (N, C) float32
// -> sums (S, C) float32 and counts (S, C) int32 of the finite values,
// built from tiles in shared memory, with no global sort.
//
// Replaces no TPU kernel: the JAX package sums a view's float pixels per
// face with XLA's segment_sum (geograypher_tpu/ops/aggregate.py:76),
// which is reproducible.  index_add's float atomics add in no fixed
// order; here the order is fixed, and two runs give the same bits.
//
// The order.  The N entries are cut into tiles of 1024: 32 x 32 pixels of
// an (H, W) image (tiles numbered row-major over the tile grid, edge tiles
// cut by the image), or runs of 1024 consecutive entries of a plain list.
// A key's finite values within one tile are added from 0.0 in row-major
// position order (the entries' index order), giving one partial sum per
// (key, tile); the key's partials are then added from 0.0 in tile order.
// Every add is __fadd_rn; non-finite values are skipped and not counted.
// ops/face_sums.py face_sums_plain adds in the same order, bit for bit.
//
// Kernels, in one call (gg_face_sums), all on the caller's stream:
//  1. tile_partials, one block of 1024 threads per tile.  The tile's
//     values (up to 16 channels at a time, 40 KB at C = 10) are fetched
//     into shared memory with cp.async (16-byte copies where a tile row is
//     16-byte aligned), in flight while the block groups its keys.  No
//     sort: each warp holds 32 consecutive positions (a tile row of an
//     image), __match_any_sync gathers the lanes of one key into an entry
//     (lane mask), the entry's leader enters the key in a shared-memory
//     hash (atomicCAS, 2048 slots) and sets its warp's bit there.  A block
//     scan numbers the keys and gives each its run of entries; an entry's
//     rank in the run is the number of lower warps holding its key, so a
//     key's entries lie in warp order and, walking each mask from its low
//     bit, its values in position order.  One thread per (key, channel)
//     adds them from shared memory and writes one partial record (C sums,
//     C int16 counts, the key, the tile) at a slot taken with one integer
//     atomicAdd per block; each key's partial count rises by an integer
//     atomicAdd.  Keys are never packed with positions, so any
//     n_segments < 2^31 takes the same path.
//  2. scan_top / scan_down: an exclusive scan of the per-key partial
//     counts (hand-written block scans; tile_partials also counts the
//     partials of each 1024 keys) gives each key its bounds in the
//     partial list.
//  3. place: each partial takes a slot within its key's bounds with an
//     integer atomicSub, in any order, and stores (tile << 32 | record).
//  4. face_merge, one thread per (key, channel): a key with at most 16
//     partials orders them by tile (insertion sort in a thread-local array) and adds
//     them; keys with more go on a list.
//  5. face_merge_long, one block per listed key: a merge sort by tile in
//     shared memory (in global scratch above 4096 partials), each round
//     a binary-search rank of every entry in its partner run, O(k log^2 k)
//     and parallel, then one thread per channel adds the partials in
//     order.  A face covering every tile of a 4K view (8,160 partials)
//     never meets a quadratic selection.
// No float atomics anywhere: only the integer counters above.
//
// What bounds it on the H100: bytes.  Keys and values are read once,
// coalesced, through shared memory; the partial records (about 1.5
// partials a face hit, 60 bytes each at C = 10) are written once and read
// once; the sums and counts are written once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 1024;     // entries of a tile
constexpr int kHashBits = 11;   // a tile's key hash: 2048 slots
constexpr int kHash = 1 << kHashBits;
constexpr int kChunk = 16;      // channels staged in shared memory at a time
constexpr int kShort = 16;      // most partials a key merged by one thread
constexpr int kLongCap = 4096;  // most partials a key sorts in shared memory
constexpr int kLongThreads = 1024;
constexpr int kLongSmem = 2 * kLongCap * 8;
constexpr int kMaxDevices = 64;  // the shared-memory attributes are set once a device
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Exclusive scan of one int per thread over a block of 1024 threads;
// ``buf`` holds 33 ints of shared memory.  Every thread gets the total.
__device__ int block_exclusive_scan(int v, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = buf[lane];
    int t = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    buf[lane] = t - w;
    if (lane == 31) buf[32] = t;
  }
  __syncthreads();
  const int out = buf[warp] + x - v;
  *total = buf[32];
  __syncthreads();  // buf may be reused
  return out;
}

// Start the cp.async copies of channels [c0, c0 + cc) of the tile's
// values into vals[(row * tw + col) * cc + channel].
__device__ __forceinline__ void stage_values(const float* __restrict__ values,
                                             float* vals, int64_t y0, int x0,
                                             int rows, int cols, int W, int C,
                                             int tw, int c0, int cc) {
  const int p = threadIdx.x;
  const int64_t start0 = (y0 * W + x0) * static_cast<int64_t>(C);
  const bool rows_whole = cc == C;
  const bool aligned =
      rows_whole && (reinterpret_cast<uintptr_t>(values) & 15) == 0 &&
      start0 % 4 == 0 && (cols * C) % 4 == 0 &&
      (rows == 1 || (static_cast<int64_t>(W) * C) % 4 == 0);
  if (aligned) {
    // each tile row is one run of cols * C floats, 16-byte aligned
    const int n4 = cols * C / 4;
    for (int e = p; e < rows * n4; e += kTile) {
      const int r = e / n4, q = e - r * n4;
      cp_async16(vals + r * tw * cc + 4 * q,
                 values + start0 + static_cast<int64_t>(r) * W * C + 4 * q);
    }
  } else {
    const int row_len = cols * cc;
    for (int e = p; e < rows * row_len; e += kTile) {
      const int r = e / row_len, q = e - r * row_len;
      const int px = q / cc, ch = q - px * cc;
      cp_async4(vals + (r * tw + px) * cc + ch,
                values + ((y0 + r) * W + x0 + px) * static_cast<int64_t>(C) + c0 + ch);
    }
  }
  cp_async_commit();
}

template <typename Key>
__global__ void __launch_bounds__(kTile, 2)
    tile_partials(const Key* __restrict__ keys, const float* __restrict__ values,
                  int64_t n_segments, int H, int W, int tw_shift, int ntx, int C,
                  float* __restrict__ rec_sums, int16_t* __restrict__ rec_counts,
                  int* __restrict__ rec_face, int* __restrict__ rec_tile,
                  int* __restrict__ face_count, int* __restrict__ block_counts,
                  unsigned* __restrict__ rec_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cc_max = C < kChunk ? C : kChunk;
  float* vals = reinterpret_cast<float*>(smem);              // kTile x cc_max
  int* hkey = reinterpret_cast<int*>(vals + kTile * cc_max);  // hash: the key, -1 empty
  unsigned* hwarps = reinterpret_cast<unsigned*>(hkey + kHash);  // bit w: warp w has it
  int* hu = reinterpret_cast<int*>(hwarps + kHash);          // slot -> unique index
  int* u_slot = hu + kHash;                                  // unique index -> slot
  int* list_off = u_slot + kTile;                            // kTile + 1 list starts
  unsigned* ent_mask = reinterpret_cast<unsigned*>(list_off + kTile + 1);  // lanes
  int* ent_warp = reinterpret_cast<int*>(ent_mask + kTile);
  int* buf = ent_warp + kTile;  // 33
  int* base_s = buf + 33;

  const int tw = 1 << tw_shift, th = kTile >> tw_shift;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int64_t y0 = static_cast<int64_t>(ty) * th;
  const int x0 = tx * tw;
  const int rows = min(static_cast<int64_t>(th), H - y0), cols = min(tw, W - x0);
  const int p = threadIdx.x, lane = p & 31, warp = p >> 5;
  const int r = p >> tw_shift, x = p & (tw - 1);

  // the key's load goes out first; the first channel chunk is in flight
  // while the keys are grouped
  const bool inside = r < rows && x < cols;
  const int64_t k64 = inside ? static_cast<int64_t>(keys[(y0 + r) * W + x0 + x]) : -1;
  stage_values(values, vals, y0, x0, rows, cols, W, C, tw, 0, cc_max);
  for (int i = p; i < kHash; i += kTile) {
    hkey[i] = -1;
    hwarps[i] = 0;
  }
  // valid keys are below n_segments < 2^31
  const int k = k64 >= 0 && k64 < n_segments ? static_cast<int>(k64) : -1;
  __syncthreads();  // the hash is clear
  // a warp's 32 positions: the lanes holding one key form one entry
  const unsigned peers = __match_any_sync(kFull, k);
  const bool leader = k >= 0 && __ffs(peers) - 1 == lane;
  unsigned h = 0;
  if (leader) {
    h = (static_cast<unsigned>(k) * 2654435761u) >> (32 - kHashBits);
    for (;;) {
      const int prev = atomicCAS(hkey + h, -1, k);
      if (prev == -1 || prev == k) break;
      h = (h + 1) & (kHash - 1);
    }
    atomicOr(hwarps + h, 1u << warp);
  }
  __syncthreads();
  // number the keys in slot order, and give each its run of entries; the
  // two counts ride one int, 16 bits each (both at most 1024)
  const int s0 = 2 * p;
  const int o0 = hkey[s0] >= 0, o1 = hkey[s0 + 1] >= 0;
  const int e0 = __popc(hwarps[s0]), e1 = __popc(hwarps[s0 + 1]);
  int total;
  const int ex = block_exclusive_scan(((o0 + o1) << 16) | (e0 + e1), buf, &total);
  const int n_unique = total >> 16;
  if (o0) {
    hu[s0] = ex >> 16;
    u_slot[ex >> 16] = s0;
    list_off[ex >> 16] = ex & 0xffff;
  }
  if (o1) {
    const int u1 = (ex >> 16) + o0;
    hu[s0 + 1] = u1;
    u_slot[u1] = s0 + 1;
    list_off[u1] = (ex & 0xffff) + e0;
  }
  if (n_unique == 0) {
    cp_async_wait_all();
    return;
  }
  __syncthreads();
  // a key's entries in warp order: its rank is the number of lower warps
  // that hold it
  if (leader) {
    const int e = list_off[hu[h]] + __popc(hwarps[h] & ((1u << warp) - 1));
    ent_mask[e] = peers;
    ent_warp[e] = warp;
  }
  if (p == 0) {  // the records' slot: its round trip overlaps the value wait
    list_off[n_unique] = total & 0xffff;
    *base_s = static_cast<int>(atomicAdd(rec_total, static_cast<unsigned>(n_unique)));
  }
  int64_t base = 0;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cc = min(kChunk, C - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous chunk is read
      stage_values(values, vals, y0, x0, rows, cols, W, C, tw, c0, cc);
    }
    cp_async_wait_all();
    __syncthreads();
    if (c0 == 0) {
      base = *base_s;
      int face_block = -1;
      if (p < n_unique) {
        const int face = hkey[u_slot[p]];
        rec_face[base + p] = face;
        rec_tile[base + p] = tile;
        atomicAdd(face_count + face, 1);
        face_block = face >> 10;
      }
      // the partials of each 1024 keys, for the scan: one atomic a warp
      // and block of keys
      const unsigned same = __match_any_sync(kFull, face_block);
      if (face_block >= 0 && __ffs(same) - 1 == lane)
        atomicAdd(block_counts + face_block, __popc(same));
    }
    for (int item = p; item < n_unique * cc; item += kTile) {
      const int uu = item / cc, c = item - uu * cc;
      const int j1 = list_off[uu + 1];
      float acc = 0.0f;
      int n = 0;
      for (int j = list_off[uu]; j < j1; ++j) {
        const float* row = vals + ent_warp[j] * 32 * cc + c;
        for (unsigned m = ent_mask[j]; m; m &= m - 1) {
          const float val = row[(__ffs(m) - 1) * cc];
          if (isfinite(val)) {
            acc = __fadd_rn(acc, val);
            ++n;
          }
        }
      }
      const int64_t o = (base + uu) * C + c0 + c;
      rec_sums[o] = acc;
      rec_counts[o] = static_cast<int16_t>(n);
    }
  }
}

// one block: the partial counts of each 1024 keys become offsets; the
// total goes to *end
__global__ void __launch_bounds__(1024)
    scan_top(int* __restrict__ block_counts, int64_t n_blocks, int* __restrict__ end) {
  __shared__ int buf[33];
  int carry = 0;
  for (int64_t c = 0; c < n_blocks; c += 1024) {
    const int64_t i = c + threadIdx.x;
    const int v = i < n_blocks ? block_counts[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, buf, &total);
    if (i < n_blocks) block_counts[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *end = carry;
}

__global__ void __launch_bounds__(1024)
    scan_down(const int* __restrict__ in, int64_t n, const int* __restrict__ offsets,
              int* __restrict__ starts) {
  __shared__ int buf[33];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 1024 + threadIdx.x;
  int total;
  const int ex = block_exclusive_scan(i < n ? in[i] : 0, buf, &total);
  if (i < n) starts[i] = offsets[blockIdx.x] + ex;
}

__global__ void place(const int* __restrict__ rec_face, const int* __restrict__ rec_tile,
                      const unsigned* __restrict__ rec_total,
                      const int* __restrict__ starts, int* __restrict__ face_count,
                      u64* __restrict__ ent) {
  const int64_t n = *rec_total;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int f = rec_face[r];
    const int slot = starts[f] + atomicSub(face_count + f, 1) - 1;
    ent[slot] = (static_cast<u64>(static_cast<unsigned>(rec_tile[r])) << 32) |
                static_cast<u64>(r);
  }
}

__device__ __forceinline__ void cswap(u64& a, u64& b) {
  const u64 lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

__global__ void face_merge(const u64* __restrict__ ent, const int* __restrict__ starts,
                           const float* __restrict__ rec_sums,
                           const int16_t* __restrict__ rec_counts, int64_t n_segments,
                           int C, float* __restrict__ sums, int* __restrict__ counts,
                           int* __restrict__ long_list, unsigned* __restrict__ n_long) {
  const int64_t n_out = n_segments * C;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n_out; t += stride) {
    const int64_t f = t / C;
    const int c = static_cast<int>(t - f * C);
    const int s0 = starts[f];
    const int k = starts[f + 1] - s0;
    if (k > kShort) {
      if (c == 0) long_list[atomicAdd(n_long, 1u)] = static_cast<int>(f);
      continue;
    }
    float acc = 0.0f;
    int n = 0;
    if (k <= 4) {  // the common case: a sorting network in registers
      u64 e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = i < k ? ent[s0 + i] : ~0ull;
      cswap(e[0], e[1]);
      cswap(e[2], e[3]);
      cswap(e[0], e[2]);
      cswap(e[1], e[3]);
      cswap(e[1], e[2]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < k) {
          const int64_t o = static_cast<int64_t>(static_cast<unsigned>(e[i])) * C + c;
          acc = __fadd_rn(acc, rec_sums[o]);
          n += rec_counts[o];
        }
      }
    } else {
      u64 w[kShort];
      for (int i = 0; i < k; ++i) {  // insertion sort by tile
        const u64 e = ent[s0 + i];
        int j = i;
        while (j > 0 && w[j - 1] > e) {
          w[j] = w[j - 1];
          --j;
        }
        w[j] = e;
      }
      for (int i = 0; i < k; ++i) {
        const int64_t o = static_cast<int64_t>(static_cast<unsigned>(w[i])) * C + c;
        acc = __fadd_rn(acc, rec_sums[o]);
        n += rec_counts[o];
      }
    }
    sums[t] = acc;
    counts[t] = n;
  }
}

__global__ void __launch_bounds__(kLongThreads)
    face_merge_long(u64* ent, u64* ent2,  // read and written in turns
                    const int* __restrict__ starts, const float* __restrict__ rec_sums,
                    const int16_t* __restrict__ rec_counts, int C,
                    float* __restrict__ sums, int* __restrict__ counts,
                    const int* __restrict__ long_list,
                    const unsigned* __restrict__ n_long) {
  extern __shared__ u64 sm[];  // 2 * kLongCap
  const unsigned n_faces = *n_long;
  for (unsigned li = blockIdx.x; li < n_faces; li += gridDim.x) {
    const int f = long_list[li];
    const int s0 = starts[f];
    const int k = starts[f + 1] - s0;
    u64* a;
    u64* b;
    if (k <= kLongCap) {
      a = sm;
      b = sm + kLongCap;
      for (int i = threadIdx.x; i < k; i += blockDim.x) a[i] = ent[s0 + i];
    } else {
      a = ent + s0;
      b = ent2 + s0;
    }
    __syncthreads();
    // merge rounds: an entry's place is its index in its run plus the
    // number of smaller entries in the partner run (entries are distinct)
    for (int width = 1; width < k; width <<= 1) {
      for (int i = threadIdx.x; i < k; i += blockDim.x) {
        const u64 e = a[i];
        const int own = i / width * width;
        const int plo = own ^ width;
        int less = 0;
        if (plo < k) {
          int lo = plo, hi = min(plo + width, k);
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (a[mid] < e) lo = mid + 1;
            else hi = mid;
          }
          less = lo - plo;
        }
        b[min(own, plo) + (i - own) + less] = e;
      }
      __syncthreads();
      u64* t = a;
      a = b;
      b = t;
    }
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float acc = 0.0f;
      int n = 0;
      for (int i = 0; i < k; i += 8) {
        float v[8];
        int m[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (i + q < k) {
            const int64_t o = static_cast<int64_t>(static_cast<unsigned>(a[i + q])) * C + c;
            v[q] = rec_sums[o];
            m[q] = rec_counts[o];
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (i + q < k) {
            acc = __fadd_rn(acc, v[q]);
            n += m[q];
          }
        }
      }
      sums[static_cast<int64_t>(f) * C + c] = acc;
      counts[static_cast<int64_t>(f) * C + c] = n;
    }
    __syncthreads();  // shared memory is reused by the next face
  }
}

// shared memory of tile_partials staging cc channels: the values, the
// hash (key, warps, unique index), the unique keys' slots and list starts,
// the entries (lanes, warp), the scan buffer and the record base
constexpr int tile_smem_bytes(int cc) {
  return (kTile * cc + 3 * kHash + 4 * kTile + 1 + 33 + 1) * 4;
}

// Raise a kernel's dynamic shared memory limit to ``bytes``, once a
// device (``done`` remembers which).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, bool* done, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (dev < kMaxDevices) done[dev] = err == cudaSuccess;
  return err;
}

struct Scratch {
  float* rec_sums;
  int16_t* rec_counts;
  int* rec_face;
  int* rec_tile;
  u64* ent;
  u64* ent2;
  int* starts;
  int* long_list;
  unsigned* counters;  // records taken, keys on the long list
  int* block_counts;   // partials of each 1024 keys, then their offsets
  int* face_count;     // partials of each key
  int64_t zeroed;      // bytes from counters to the end of face_count
  int64_t bytes;
};

int64_t align256(int64_t b) { return (b + 255) / 256 * 256; }

// The scratch layout for n entries (the most partial records there can
// be), S keys and C channels, carved from ``base`` (may be null to size).
Scratch carve(void* base, int64_t n, int64_t n_segments, int C) {
  Scratch s{};
  char* p = static_cast<char*>(base);
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    char* at = p ? p + off : nullptr;
    off += align256(bytes);
    return at;
  };
  s.rec_sums = reinterpret_cast<float*>(take(n * C * 4));
  s.rec_counts = reinterpret_cast<int16_t*>(take(n * C * 2));
  s.rec_face = reinterpret_cast<int*>(take(n * 4));
  s.rec_tile = reinterpret_cast<int*>(take(n * 4));
  s.ent = reinterpret_cast<u64*>(take(n * 8));
  s.ent2 = reinterpret_cast<u64*>(take(n * 8));
  s.starts = reinterpret_cast<int*>(take((n_segments + 1) * 4));
  s.long_list = reinterpret_cast<int*>(take(n_segments * 4));
  const int64_t zero_from = off;  // one memset clears the three counters
  s.counters = reinterpret_cast<unsigned*>(take(2 * 4));
  s.block_counts = reinterpret_cast<int*>(take((n_segments + 1023) / 1024 * 4));
  s.face_count = reinterpret_cast<int*>(take(n_segments * 4));
  s.zeroed = off - zero_from;
  s.bytes = off;
  return s;
}

template <typename Key>
cudaError_t launch_tiles(const void* keys, const float* values, int64_t n_segments,
                         int H, int W, int tw_shift, int C, const Scratch& s,
                         cudaStream_t stream) {
  const int tw = 1 << tw_shift, th = kTile >> tw_shift;
  const int64_t nty = (H + th - 1) / th, ntx = (W + tw - 1) / tw;
  const int smem = tile_smem_bytes(C < kChunk ? C : kChunk);
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = allow_smem(tile_partials<Key>, attr_set, tile_smem_bytes(kChunk));
  if (err != cudaSuccess) return err;
  tile_partials<Key><<<static_cast<unsigned>(nty * ntx), kTile, smem, stream>>>(
      static_cast<const Key*>(keys), values, n_segments, H, W, tw_shift,
      static_cast<int>(ntx), C, s.rec_sums, s.rec_counts, s.rec_face, s.rec_tile,
      s.face_count, s.block_counts, s.counters);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch gg_face_sums needs for n entries, S keys, C channels.
extern "C" int64_t gg_face_sums_scratch_bytes(int64_t n, int64_t n_segments, int n_channels) {
  return carve(nullptr, n, n_segments, n_channels).bytes;
}

// keys: (n,) int32 (keys_64 = 0) or int64; values: (n, C) float32, the
// entries of an (H, W) image cut into 32 x 32 tiles (tw_shift = 5) or of
// a list, H = 1 and W = n, cut into runs of 1024 (tw_shift = 10);
// scratch: gg_face_sums_scratch_bytes(n, S, C) bytes; sums (S, C) float32
// and counts (S, C) int32 are written whole.
extern "C" int gg_face_sums(const void* keys, int keys_64, const void* values, int64_t n,
                            int H, int W, int tw_shift, int64_t n_segments, int n_channels,
                            void* scratch, void* sums, void* counts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = n_channels;
  const int64_t n_out = n_segments * C;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  if (n == 0) {
    cudaMemsetAsync(sums, 0, n_out * 4, st);
    cudaMemsetAsync(counts, 0, n_out * 4, st);
    return static_cast<int>(cudaGetLastError());
  }
  const Scratch s = carve(scratch, n, n_segments, C);
  cudaMemsetAsync(s.counters, 0, s.zeroed, st);
  const float* v = static_cast<const float*>(values);
  cudaError_t err = keys_64
      ? launch_tiles<int64_t>(keys, v, n_segments, H, W, tw_shift, C, s, st)
      : launch_tiles<int>(keys, v, n_segments, H, W, tw_shift, C, s, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_blocks = (n_segments + 1023) / 1024;
  scan_top<<<1, 1024, 0, st>>>(s.block_counts, n_blocks, s.starts + n_segments);
  scan_down<<<static_cast<unsigned>(n_blocks), 1024, 0, st>>>(s.face_count, n_segments,
                                                              s.block_counts, s.starts);
  const int64_t want_place = (n + 255) / 256;
  place<<<static_cast<unsigned>(want_place < 132 * 16 ? want_place : 132 * 16), 256, 0,
          st>>>(s.rec_face, s.rec_tile, s.counters, s.starts, s.face_count, s.ent);
  const int64_t want_merge = (n_out + 255) / 256;
  face_merge<<<static_cast<unsigned>(want_merge < 132 * 32 ? want_merge : 132 * 32), 256,
               0, st>>>(s.ent, s.starts, s.rec_sums, s.rec_counts, n_segments, C,
                        static_cast<float*>(sums), static_cast<int*>(counts),
                        s.long_list, s.counters + 1);
  static bool long_attr_set[kMaxDevices] = {};
  err = allow_smem(face_merge_long, long_attr_set, kLongSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  face_merge_long<<<132, kLongThreads, kLongSmem, st>>>(
      s.ent, s.ent2, s.starts, s.rec_sums, s.rec_counts, C, static_cast<float*>(sums),
      static_cast<int*>(counts), s.long_list, s.counters + 1);
  return static_cast<int>(cudaGetLastError());
}
