// Fixed-order per-segment float sums: values (N, C) float32 gathered
// through a stable key order -> sums (S, C) float32 and counts (S, C)
// int32 of the finite values.
//
// Replaces no TPU kernel: the JAX package sums a view's float pixels per
// face with XLA's segment_sum (geograypher_tpu/ops/aggregate.py:76),
// which is reproducible.  The port's first version used index_add, whose
// float atomics on the card add in no fixed order, so two runs could
// differ in the last bits.  Here the order is fixed before the kernel
// runs: the wrapper takes a stable sort of the keys (``order``) and the
// segment bounds from an integer bincount and cumsum (``bounds``, S + 1
// entries), and one thread per (segment, channel) adds its segment's
// values in sorted order -- pixel order within a face -- with
// __fadd_rn, skipping non-finite values and counting the finite ones.
// No float atomics, no reliance on torch's deterministic mode; the plain
// version adds in the same order and is bit-equal.
//
// What bounds it on the H100: bytes.  Each value is read once (4 bytes),
// each order entry once by each of a segment's C threads (a warp-wide
// broadcast when C is small), and the sums and counts written once.  The
// channel is the fastest thread index, so the C threads of a segment
// read one pixel's C adjacent values together; a segment's pixels are
// neighbours in the image, so consecutive order entries mostly fall in
// the same few cache lines.  Segment lengths differ (0 to a few hundred
// pixels), so a warp waits for its longest segment: the simple design
// first, tuning later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void face_sums_kernel(const float* __restrict__ values,
                                 const int* __restrict__ order,
                                 const int64_t* __restrict__ bounds,
                                 float* __restrict__ sums,
                                 int* __restrict__ counts, int64_t n_segments,
                                 int n_channels) {
  const int64_t n_out = n_segments * n_channels;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n_out; t += stride) {
    const int64_t s = t / n_channels;
    const int c = static_cast<int>(t - s * n_channels);
    const int64_t j1 = bounds[s + 1];
    float acc = 0.0f;
    int n = 0;
    for (int64_t j = bounds[s]; j < j1; ++j) {
      const float v =
          __ldg(values + static_cast<int64_t>(__ldg(order + j)) * n_channels + c);
      if (isfinite(v)) {
        acc = __fadd_rn(acc, v);
        ++n;
      }
    }
    sums[t] = acc;
    counts[t] = n;
  }
}

}  // namespace

// values: (N, C) float32; order: (M,) int32 row of every valid key in
// stable key order; bounds: (S + 1,) int64 segment starts in order, the
// last = M; sums (S, C) float32 and counts (S, C) int32 are written whole.
extern "C" int gg_face_sums(const void* values, const void* order,
                            const void* bounds, void* sums, void* counts,
                            int64_t n_segments, int n_channels, void* stream) {
  const int64_t n_out = n_segments * n_channels;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t want = (n_out + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  face_sums_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(order),
      static_cast<const int64_t*>(bounds), static_cast<float*>(sums),
      static_cast<int*>(counts), n_segments, n_channels);
  return static_cast<int>(cudaGetLastError());
}
