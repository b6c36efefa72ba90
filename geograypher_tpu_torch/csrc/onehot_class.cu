// One-hot label scan: image (H, W, C) float32 or float64 -> class image
// int32 (H, W) and one int32 count of pixels that break the one-hot rule.
//
// Replaces no TPU kernel: both packages ran this scan on the host in
// numpy (TexturedMesh._as_class_image,
// geograypher_tpu/meshes/mesh.py:1015), about ten passes over the 332 MB
// float32 one-hot stack of a 4K view.  Per pixel: all C values non-finite
// -> class -1 (unlabeled); all finite, every value 0 or 1 (-0.0 passes)
// and exactly one 1 -> its index; anything else (finite mixed with
// non-finite, a value that is neither 0 nor 1, no 1 or several) -> class
// -1 and one violation.  Ones are counted in integers, which equals
// numpy's float row sum == 1 because every addend is 0 or 1.  The image
// is an exact one-hot stack iff violations == 0.
//
// What bounds it on the H100: bytes.  Every value is read once (332 MB
// for a float32 4K view of 10 classes, twice that in float64) and 4 bytes
// a pixel are written; the arithmetic is a few compares a value.  So the
// design only has to keep the loads wide and contiguous: a warp takes 32
// consecutive pixels, whose 32 * C values are one contiguous run that
// starts on a 128-byte boundary, copies it to its own slice of shared
// memory with 16-byte streaming loads (scalar loads when the base
// pointer is not 16-byte aligned, and for a ragged tail), and then each
// lane scans the C values of its pixel from shared memory, starting at
// channel lane % C so that the lanes spread over the banks whatever C
// is.  Violations are rare: one ballot per warp trip, and an atomic only
// when a lane of the warp found one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpPixels = 32;
constexpr int kMaxWarps = 8;
constexpr size_t kStaticSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void onehot_class_kernel(const T* __restrict__ image,
                                    int* __restrict__ cls,
                                    int* __restrict__ violations,
                                    int64_t n_pix, int n_classes,
                                    int aligned16) {
  extern __shared__ int4 smem16[];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  T* tile = reinterpret_cast<T*>(smem16) +
            static_cast<size_t>(threadIdx.x >> 5) * kWarpPixels * n_classes;
  const int64_t n_tiles = (n_pix + kWarpPixels - 1) / kWarpPixels;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * warps;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * warps + (threadIdx.x >> 5);
       t < n_tiles; t += n_warps) {
    const int64_t p0 = t * kWarpPixels;
    const int n_here = n_pix - p0 < kWarpPixels ? static_cast<int>(n_pix - p0)
                                                : kWarpPixels;
    const T* src = image + p0 * n_classes;
    const int n_values = n_here * n_classes;
    int copied = 0;
    if (aligned16) {
      const int n16 = static_cast<int>(n_values * sizeof(T) / 16);
      const int4* src16 = reinterpret_cast<const int4*>(src);
      int4* dst16 = reinterpret_cast<int4*>(tile);
      for (int i = lane; i < n16; i += 32) dst16[i] = __ldcs(src16 + i);
      copied = n16 * static_cast<int>(16 / sizeof(T));
    }
    for (int i = copied + lane; i < n_values; i += 32) tile[i] = src[i];
    __syncwarp();
    bool bad = false;
    if (lane < n_here) {
      const T* row = tile + lane * n_classes;
      int n_finite = 0, n_ones = 0, one_at = -1;
      bool other = false;
      int k = lane % n_classes;
      for (int j = 0; j < n_classes; ++j) {
        const T v = row[k];
        if (isfinite(v)) {
          ++n_finite;
          if (v == static_cast<T>(1)) {
            ++n_ones;
            one_at = k;
          } else if (v != static_cast<T>(0)) {
            other = true;
          }
        }
        if (++k == n_classes) k = 0;
      }
      const bool onehot = n_finite == n_classes && !other && n_ones == 1;
      bad = !onehot && n_finite != 0;
      cls[p0 + lane] = onehot ? one_at : -1;
    }
    const unsigned found = __ballot_sync(kFull, bad);
    if (lane == 0 && found) atomicAdd(violations, __popc(found));
    __syncwarp();  // every lane has read its row before the next copy
  }
}

template <typename T>
cudaError_t launch(const void* image, void* cls, void* violations,
                   int64_t n_pix, int n_classes, cudaStream_t stream) {
  const size_t per_warp = sizeof(T) * kWarpPixels * n_classes;
  int warps = static_cast<int>(kStaticSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_class_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t n_tiles = (n_pix + kWarpPixels - 1) / kWarpPixels;
  const int64_t want = (n_tiles + warps - 1) / warps;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  const int aligned16 = reinterpret_cast<uintptr_t>(image) % 16 == 0;
  onehot_class_kernel<T><<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(image), static_cast<int*>(cls),
      static_cast<int*>(violations), n_pix, n_classes, aligned16);
  return cudaGetLastError();
}

}  // namespace

// image: n_pix * n_classes values, float64 when is_double else float32;
// cls: n_pix int32; violations: one int32, zeroed here on the stream.
extern "C" int gg_onehot_class(const void* image, void* cls, void* violations,
                               int64_t n_pix, int n_classes, int is_double,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(violations, 0, sizeof(int), s);
  if (err == cudaSuccess && n_pix > 0) {
    err = is_double
              ? launch<double>(image, cls, violations, n_pix, n_classes, s)
              : launch<float>(image, cls, violations, n_pix, n_classes, s);
  }
  return static_cast<int>(err);
}
