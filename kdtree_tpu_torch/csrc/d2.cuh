// Squared distances in the arithmetic of the JAX package's jitted sums.
//
// Shared by the port's CUDA kernels (scan_knn.cu, verb_fold.cu, pair_d2.cu):
// the JAX package writes a squared distance as jnp.sum(diff * diff, -1), and
// XLA:CPU contracts each step of that sum up to 32 axes into one fused
// multiply-add, acc = fma(diff, diff, acc) for d = 0..D-1 from acc = 0, with
// diff = q_d - p_d rounded once. Above 32 axes it rounds each square and sums
// the row in windows of 32 (window_sum). The plain PyTorch versions compute
// the same in kdtree_tpu_torch/ops/_arith.py (sq_dist, sq_sum_windows,
// sq_dist_to_box), bit for bit. Every step is written with an intrinsic
// (__fsub_rn, __fmaf_rn, __fmul_rn, __fadd_rn), so nvcc can neither contract
// nor reorder it.
#pragma once

namespace kdt {

// Above 32 axes: the rounded squares of term(0..D-1), summed as XLA:CPU sums
// them (kdtree_tpu_torch/ops/_arith.py::sq_sum_windows). The row is padded
// with f1 zeros in front to w1 windows of 32, each window is added in order,
// and the window sums are reduced the same way: in order when w1 <= 32,
// else padded with f2 zeros to w2 windows of their own (D <= 32,768). A
// padding zero never changes a sum, so only the window boundaries matter,
// and every level is summed while the axes stream past.
template <typename Term>
__device__ __forceinline__ float window_sum(int D, Term term) {
  const int w1 = (D + 31) >> 5;
  const int f1 = (32 * w1 - D) >> 1;
  const int w2 = (w1 + 31) >> 5;
  const int f2 = (32 * w2 - w1) >> 1;
  float s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int d = 0; d < D; ++d) {
    const float x = term(d);
    s1 = __fadd_rn(s1, __fmul_rn(x, x));
    const int p1 = d + f1;
    const bool last = d == D - 1;
    if ((p1 & 31) == 31 || last) {
      s2 = __fadd_rn(s2, s1);
      s1 = 0.f;
      if (w1 > 32 && ((((p1 >> 5) + f2) & 31) == 31 || last)) {
        s3 = __fadd_rn(s3, s2);
        s2 = 0.f;
      }
    }
  }
  return w1 > 32 ? s3 : s2;
}

// The gap from q to [lo, hi] on one axis: fsub(lo - q) or fsub(q - hi), 0
// inside.
__device__ __forceinline__ float box_gap(float q, float lo, float hi) {
  if (q < lo) return __fsub_rn(lo, q);
  if (q > hi) return __fsub_rn(q, hi);
  return 0.f;
}

// Squared distance from the query to the box [lo, hi]: the per-axis gaps
// folded as point_d2 folds its differences (the FMA chain, or window_sum
// above 32 axes), so the bound is never above a point inside the box.
template <int DC>
__device__ __forceinline__ float box_bound(const float* lo, const float* hi,
                                           const float* qv, const float* qrow, int D) {
  float acc = 0.f;
  if (DC > 0) {
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      const float g = box_gap(qv[d], lo[d], hi[d]);
      acc = __fmaf_rn(g, g, acc);
    }
  } else if (D > 32) {
    acc = window_sum(D, [&](int d) { return box_gap(qrow[d], lo[d], hi[d]); });
  } else {
    for (int d = 0; d < D; ++d) {
      const float g = box_gap(qrow[d], lo[d], hi[d]);
      acc = __fmaf_rn(g, g, acc);
    }
  }
  return acc;
}

// Squared distance from the query to the point p: qv holds the query in
// registers when DC > 0 (D == DC), else qrow points at it (shared or device
// memory).
template <int DC>
__device__ __forceinline__ float point_d2(const float* p, const float* qv, const float* qrow,
                                          int D) {
  float acc = 0.f;
  if (DC > 0) {
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      const float diff = __fsub_rn(qv[d], p[d]);
      acc = __fmaf_rn(diff, diff, acc);
    }
  } else if (D > 32) {
    acc = window_sum(D, [&](int d) { return __fsub_rn(qrow[d], p[d]); });
  } else {
    for (int d = 0; d < D; ++d) {
      const float diff = __fsub_rn(qrow[d], p[d]);
      acc = __fmaf_rn(diff, diff, acc);
    }
  }
  return acc;
}

// point_d2 at D = 3 with the point's coordinates in registers.
__device__ __forceinline__ float d2_3(const float* qv, float x, float y, float z) {
  float acc = 0.f;
  float diff = __fsub_rn(qv[0], x);
  acc = __fmaf_rn(diff, diff, acc);
  diff = __fsub_rn(qv[1], y);
  acc = __fmaf_rn(diff, diff, acc);
  diff = __fsub_rn(qv[2], z);
  return __fmaf_rn(diff, diff, acc);
}

}  // namespace kdt
