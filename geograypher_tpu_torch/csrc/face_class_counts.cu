// Per-face per-class pixel counts: (pix2face, class image) -> int32 (F, C).
//
// Replaces the TPU face-block folds geograypher_tpu/ops/agg_tiled.py
// face_counts_from_tiles (B3, bin_block == 1) and _face_counts_units (B2,
// bin_block % 8 == 0), together with the per-tile count entries the TPU
// raster kernel emits for them.  The tile entries, the face-block
// windows and the base-128 digit planes are TPU workarounds for slow
// scatters that also corrupt Mosaic outputs (agg_tiled.py:5-10); on the
// H100 an atomic add into device memory is the native tool.
//
// A pixel that shows face 0 <= f < F and carries class 0 <= c < C adds 1
// to counts[f * C + c].  A face covers a handful of neighbouring pixels,
// and a segmentation gives neighbours the same class, so one atomic per
// pixel sends the same address from many lanes of a warp, and the L2
// serializes them.  The kernel therefore merges before it adds: a warp
// takes a compact 8 x 4 pixel patch (four 32-byte sectors of each input),
// one pixel a lane; __match_any_sync groups the lanes that hold the same
// key f * C + c; the lowest lane of each group adds the group's size.
// Integer adds commute, so the counts are exact and identical run to run
// whatever the grouping.  A warp trip loads four patches side by side
// (32 x 4 pixels, eight loads in flight a lane) before it merges any, and
// the warps walk the trips grid-stride.  The key is 32 bits wide while
// F * C fits (the 64-bit match is slower where the labels leave little
// to merge); a larger table takes the 64-bit instance.
//
// What bounds it on the H100: bytes, and the L2's atomic rate where the
// labels leave nothing to merge.  The caller's zero fill writes the table
// (40 MB at 1M faces x 10 classes), the kernel reads 8 bytes a pixel
// (66 MB for a 4K view), and the table goes to device memory once more
// when the L2 lets go of it.  On piecewise-constant labels a patch holds
// a fifth as many keys as pixels and the kernel without its atomics
// takes most of the kernel's time, the match none that shows; labels
// drawn independently per pixel keep most of their adds, and these set
// the time there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPatchW = 8;  // 32 bytes of a row
constexpr int kPatchH = 4;
constexpr int kTripPatches = 4;  // side by side: a trip is 32 x 4 pixels
constexpr int kTripW = kPatchW * kTripPatches;
constexpr int kMaxBlocks = 132 * 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename Key>
__global__ void __launch_bounds__(kThreads)
    face_class_counts_kernel(const int* __restrict__ p2f,
                             const int* __restrict__ cls,
                             int* __restrict__ counts, int height, int width,
                             int64_t n_faces, int n_classes, int trips_x,
                             int64_t n_trips) {
  constexpr Key kNone = static_cast<Key>(-1);
  const int lane = threadIdx.x & 31;
  const int px = lane % kPatchW, py = lane / kPatchW;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       t < n_trips; t += n_warps) {
    const int y = static_cast<int>(t / trips_x) * kPatchH + py;
    const int x0 = static_cast<int>(t % trips_x) * kTripW + px;
    Key key[kTripPatches];
#pragma unroll
    for (int k = 0; k < kTripPatches; ++k) {
      const int x = x0 + kPatchW * k;
      key[k] = kNone;
      if (x < width && y < height) {  // ragged right and bottom edges
        const int64_t i = static_cast<int64_t>(y) * width + x;
        const int f = p2f[i];
        const int c = cls[i];
        if (f >= 0 && f < n_faces && c >= 0 && c < n_classes) {
          key[k] = static_cast<Key>(static_cast<int64_t>(f) * n_classes + c);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kTripPatches; ++k) {
      const bool live = key[k] != kNone;
      if (!__any_sync(kFull, live)) continue;  // a patch of background
      const unsigned peers = __match_any_sync(kFull, key[k]);
      if (live && lane == __ffs(peers) - 1) {
        atomicAdd(counts + static_cast<int64_t>(key[k]), __popc(peers));
      }
    }
  }
}

}  // namespace

// counts: (n_faces, n_classes) int32, zeroed by the caller on the stream.
extern "C" int gg_face_class_counts(const void* pix2face,
                                    const void* class_image, void* counts,
                                    int height, int width, int64_t n_faces,
                                    int n_classes, void* stream) {
  const int64_t table = n_faces * n_classes;
  if (height > 0 && width > 0 && table > 0) {
    const int trips_x = (width + kTripW - 1) / kTripW;
    const int64_t n_trips =
        static_cast<int64_t>(trips_x) * ((height + kPatchH - 1) / kPatchH);
    const int64_t want = (n_trips + kWarps - 1) / kWarps;
    const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
    auto kernel = table <= INT32_MAX ? face_class_counts_kernel<int>
                                     : face_class_counts_kernel<long long>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pix2face), static_cast<const int*>(class_image),
        static_cast<int*>(counts), height, width, n_faces, n_classes, trips_x,
        n_trips);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
