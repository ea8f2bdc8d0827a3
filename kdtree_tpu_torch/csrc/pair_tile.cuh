// Register-tiled squared distances between a tile of query rows and a tile
// of point rows, shared by pair_d2.cu (the oracle's distance block) and
// knn_scan.cu (the fused exact k-NN).
//
// A block is 8 warps. Warp w owns RQ query rows (w RQ .. w RQ + RQ - 1) and
// lane l owns RP point rows (l, l + 32, ..), so a thread holds RQ x RP
// running sums. The rows are staged in shared memory transposed, an axis a
// row of the stage (stage_rows), in slices of up to kSlice axes: per axis a
// thread reads its RQ query values as 16-byte broadcasts (every lane of the
// warp reads the same words) and its RP point values from 32 banks,
// then does RQ x RP subtract-and-accumulate steps. So one shared-memory read
// feeds RQ or RP arithmetic steps, not one as in a thread-a-pair design.
//
// The arithmetic is d2.cuh's, bit for bit, whatever the tiling: up to 32
// axes the FMA chain acc = fma(diff, diff, acc) from 0 over d = 0..D-1
// (kFma); above, the rounded squares summed in XLA:CPU's windows of 32
// (window_sum), each window sum added to the running total when the axis
// that closes it streams past (kWin; kWin2 adds the second level of
// windows past 1,024 axes). The slices run in axis order, so a sum that
// spans slices stays in its registers.
#pragma once

#include <stdint.h>

#include "sm90_async.cuh"

namespace kdt {

constexpr int kTileWarps = 8;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kSlice = 32;  // axes a stage

enum SumMode { kFma = 0, kWin = 1, kWin2 = 2 };

inline int sum_mode(int D) { return D <= 32 ? kFma : (D <= 32 * 32 ? kWin : kWin2); }

// dst[c * ld + r] = src[min(row0 + r, last) * D + d0 + c] for r < rows,
// c < ds, as 4-byte cp.async copies (the caller commits and waits). Rows
// past `last` repeat it: their sums are never used. A warp's copies read
// neighbouring words of a row (a whole tile is contiguous when ds == D).
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           long long row0, long long last, int rows, int D,
                                           int d0, int ds) {
  const int tid = threadIdx.x;
  const int n = rows * ds;
  int r = tid / ds;
  int c = tid - r * ds;
  const int dr = kTileThreads / ds;
  const int dc = kTileThreads - dr * ds;
  for (int e = tid; e < n; e += kTileThreads) {
    long long g = row0 + r;
    if (g > last) g = last;
    sm90::cp_async4(dst + c * ld + r, src + g * D + d0 + c);
    r += dr;
    c += dc;
    if (c >= ds) {
      c -= ds;
      ++r;
    }
  }
}

// The window bookkeeping of d2.cuh::window_sum for an axis count D, done
// once per axis for all of a thread's sums.
struct Windows {
  int f1, f2, w1;
  __device__ __forceinline__ explicit Windows(int D) {
    w1 = (D + 31) >> 5;
    f1 = (32 * w1 - D) >> 1;
    const int w2 = (w1 + 31) >> 5;
    f2 = (32 * w2 - w1) >> 1;
  }
};

template <int RQ, int RP>
struct Sums {
  float s1[RQ][RP];
  float s2[RQ][RP];  // kWin, kWin2
  float s3[RQ][RP];  // kWin2

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < RP; ++j) s1[i][j] = s2[i][j] = s3[i][j] = 0.f;
    }
  }

  template <int MODE>
  __device__ __forceinline__ float result(int i, int j) const {
    return MODE == kFma ? s1[i][j] : (MODE == kWin ? s2[i][j] : s3[i][j]);
  }
};

// v[0 .. N) = p[0 .. N) as 16-byte loads (p 16-byte aligned, N % 4 == 0).
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  static_assert(N % 4 == 0, "whole float4s");
#pragma unroll
  for (int m = 0; m < N / 4; ++m) {
    const float4 t = reinterpret_cast<const float4*>(p)[m];
    v[4 * m] = t.x;
    v[4 * m + 1] = t.y;
    v[4 * m + 2] = t.z;
    v[4 * m + 3] = t.w;
  }
}

// One axis d of every (query, point) sum of the thread.
template <int MODE, int RQ, int RP>
__device__ __forceinline__ void add_axis(Sums<RQ, RP>& s, const float (&qv)[RQ],
                                         const float (&pv)[RP], int d, int D,
                                         const Windows& w) {
  if (MODE == kFma) {
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const float diff = __fsub_rn(qv[i], pv[j]);
        s.s1[i][j] = __fmaf_rn(diff, diff, s.s1[i][j]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const float x = __fsub_rn(qv[i], pv[j]);
      s.s1[i][j] = __fadd_rn(s.s1[i][j], __fmul_rn(x, x));
    }
  }
  const int p1 = d + w.f1;
  const bool last = d == D - 1;
  if ((p1 & 31) == 31 || last) {
    const bool up = MODE == kWin2 && w.w1 > 32 && ((((p1 >> 5) + w.f2) & 31) == 31 || last);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        s.s2[i][j] = __fadd_rn(s.s2[i][j], s.s1[i][j]);
        s.s1[i][j] = 0.f;
        if (up) {
          s.s3[i][j] = __fadd_rn(s.s3[i][j], s.s2[i][j]);
          s.s2[i][j] = 0.f;
        }
      }
    }
  }
}

// Adds axes d0 .. d0 + ds - 1 of the staged slice to the thread's sums:
// its query values at sq[c * ldq + qoff ..] (16-byte aligned), its point
// values at sp[c * ldp + lane + 32 j].
template <int MODE, int RQ, int RP>
__device__ __forceinline__ void accumulate(Sums<RQ, RP>& s, const float* sq, int ldq,
                                           const float* sp, int ldp, int qoff, int d0, int ds,
                                           int D, const Windows& w) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < ds; ++c) {
    float qv[RQ], pv[RP];
    load_vec(qv, sq + c * ldq + qoff);
#pragma unroll
    for (int j = 0; j < RP; ++j) pv[j] = sp[c * ldp + lane + 32 * j];
    add_axis<MODE>(s, qv, pv, d0 + c, D, w);
  }
}

}  // namespace kdt
