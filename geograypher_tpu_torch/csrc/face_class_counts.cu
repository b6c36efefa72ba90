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
// One thread per pixel (grid-stride): when the pixel shows face f >= 0
// and carries class 0 <= c < C it adds 1 to counts[f * C + c], the
// offset computed in 64 bits.  int32 atomics make the counts exact and
// identical run to run, whatever order the adds land in.
//
// What bounds it on the H100: memory traffic and atomic throughput.  It
// reads 8 bytes per pixel (66 MB for a 4K view) and issues one atomic per
// labelled mesh pixel into an (F, C) table (40 MB at 1M faces x 10
// classes) that fits the 50 MB L2, where the atomics resolve.
// Neighbouring pixels mostly hit the same face, so same-address atomics
// inside a warp serialize; a warp-level pre-aggregation is left for a
// later change.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    face_class_counts_kernel(const int* __restrict__ p2f,
                             const int* __restrict__ cls,
                             int* __restrict__ counts, int64_t n_pix,
                             int64_t n_faces, int n_classes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_pix; i += stride) {
    const int f = p2f[i];
    const int c = cls[i];
    if (f >= 0 && f < n_faces && c >= 0 && c < n_classes) {
      atomicAdd(counts + static_cast<int64_t>(f) * n_classes + c, 1);
    }
  }
}

}  // namespace

extern "C" int gg_face_class_counts(const void* pix2face,
                                    const void* class_image, void* counts,
                                    int64_t n_pix, int64_t n_faces,
                                    int n_classes, void* stream) {
  if (n_pix > 0) {
    const int64_t want = (n_pix + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
    face_class_counts_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pix2face), static_cast<const int*>(class_image),
        static_cast<int*>(counts), n_pix, n_faces, n_classes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
