// The plane evaluation shared by the raster kernels.
#pragma once

#include <cuda_runtime.h>

// (a*x + b*y) + c, each operation rounded separately (no FMA contraction):
// the plain PyTorch versions round the same way, so the kernels agree with
// them bit for bit on coverage and depth.
__device__ __forceinline__ float eval_plane(float a, float b, float c, float x,
                                            float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}
