// The plane evaluation and the face cull shared by the raster kernels.
#pragma once

#include <cuda_runtime.h>

// (a*x + b*y) + c, each operation rounded separately (no FMA contraction):
// the plain PyTorch versions round the same way, so the kernels agree with
// them bit for bit on coverage and depth.
__device__ __forceinline__ float eval_plane(float a, float b, float c, float x,
                                            float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// The cull rule (mirrored op for op by ops/raster_tiles.py cull_rule).
//
// A face's box (setup.bbox) holds its vertices' pixel centres, but
// coverage is the rounded test of the rounded planes.  Rounding moves each
// edge line by at most delta_k = err_k / |n_k| px, where err_k bounds the
// error of the computed coefficients and of their evaluation over the
// image: err_k <= 4u (|a_k| (2W + extent_x) + |b_k| (2H + extent_y)), u =
// 2^-24, since the vertices of a face whose box meets the image lie within
// its extent of it.  Moving the edges moves a vertex of interior angle
// theta by at most (delta_i + delta_j) / sin(theta), and sin(theta) =
// area2 / (|n_i| |n_j|).  For on-screen faces at 4K delta is under 3e-3
// px, so a margin of 1 px covers every vertex whose sine exceeds ~6e-3
// (the rule below asks four times that); a sliver sharper than that can
// carry coverage past any fixed margin, so it is never culled.  kCull:
//   kCullBox    - covers no pixel outside its box widened by kCullMargin:
//                 every |a_k|, |b_k| <= 2^18 and, at each vertex,
//                 2 * 2 * 4u (err_i |n_j| + err_j |n_i|) <= area2 (twice
//                 the margin needed, and err bounded with 8u, not 4u);
//   kCullExempt - may cover anything in the image (a long edge, from a
//                 vertex near the camera plane, or a sharp sliver);
//   kCullNever  - covers nothing: a constant-negative edge plane (the
//                 sentinel row of an invalid face).
enum CullKind { kCullNever = 0, kCullBox = 1, kCullExempt = 2 };
constexpr int kCullMargin = 1;
constexpr float kCullMaxCoef = 262144.f;                // 2^18
constexpr float kCullTwoGamma = 9.5367431640625e-07f;  // 2 * 2^-21

__device__ __forceinline__ int cull_rule(float a0, float b0, float c0,
                                         float a1, float b1, float c1,
                                         float a2, float b2, float c2, int W,
                                         int H) {
  if ((a0 == 0.f && b0 == 0.f && c0 < 0.f) ||
      (a1 == 0.f && b1 == 0.f && c1 < 0.f) ||
      (a2 == 0.f && b2 == 0.f && c2 < 0.f))
    return kCullNever;
  const float ha0 = fabsf(a0), ha1 = fabsf(a1), ha2 = fabsf(a2);
  const float hb0 = fabsf(b0), hb1 = fabsf(b1), hb2 = fabsf(b2);
  const float ext_x = fmaxf(fmaxf(hb0, hb1), hb2);
  const float ext_y = fmaxf(fmaxf(ha0, ha1), ha2);
  if (fmaxf(ext_x, ext_y) > kCullMaxCoef) return kCullExempt;
  const float X = __fadd_rn(static_cast<float>(2 * (W + 1)), ext_x);
  const float Y = __fadd_rn(static_cast<float>(2 * (H + 1)), ext_y);
  const float e0 = __fadd_rn(__fmul_rn(ha0, X), __fmul_rn(hb0, Y));
  const float e1 = __fadd_rn(__fmul_rn(ha1, X), __fmul_rn(hb1, Y));
  const float e2 = __fadd_rn(__fmul_rn(ha2, X), __fmul_rn(hb2, Y));
  const float n0 = __fsqrt_rn(__fadd_rn(__fmul_rn(a0, a0), __fmul_rn(b0, b0)));
  const float n1 = __fsqrt_rn(__fadd_rn(__fmul_rn(a1, a1), __fmul_rn(b1, b1)));
  const float n2 = __fsqrt_rn(__fadd_rn(__fmul_rn(a2, a2), __fmul_rn(b2, b2)));
  const float area2 = fabsf(__fsub_rn(__fmul_rn(a0, b1), __fmul_rn(a1, b0)));
  const float t01 = __fadd_rn(__fmul_rn(e0, n1), __fmul_rn(e1, n0));
  const float t12 = __fadd_rn(__fmul_rn(e1, n2), __fmul_rn(e2, n1));
  const float t02 = __fadd_rn(__fmul_rn(e0, n2), __fmul_rn(e2, n0));
  if (__fmul_rn(kCullTwoGamma, t01) > area2 ||
      __fmul_rn(kCullTwoGamma, t12) > area2 ||
      __fmul_rn(kCullTwoGamma, t02) > area2)
    return kCullExempt;
  return kCullBox;
}
