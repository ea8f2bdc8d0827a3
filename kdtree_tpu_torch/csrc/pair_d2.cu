// The exact brute-force oracle's distance block: every squared distance
// between Q query rows and T point rows.
//
// Replaces no TPU kernel: the JAX package's oracle computes this block as the
// jitted XLA fusion kdtree_tpu/ops/bruteforce.py::_block_d2_exact (:44). Its
// plain PyTorch version is kdtree_tpu_torch/ops/_arith.py::sq_dist over the
// broadcast rows (kdtree_tpu_torch/kernels/pair_d2.py::pair_d2_plain), which
// this kernel matches bit for bit: the FMA chain of d2.cuh up to 32 axes, the
// rounded squares summed in windows of 32 above.
//
// Design for Hopper: a block owns kPoints points and kQueries queries, a
// thread one point. Both tiles are staged in shared memory (the points' rows
// at an odd stride, so a warp's reads of one axis hit 32 banks). Up to 32
// axes each thread keeps kBatch running sums in registers and walks the axes
// once per batch of queries: an axis costs one read of its point, and for
// each query of the batch one broadcast read, a subtract and an FMA. Above
// 32 axes each (query, point) sum is taken on its own (window_sum). A warp
// writes 32 neighbouring outputs of one query row at a time.
//
// What bounds it on the card: the output's bytes (4 a pair) at the oracle's
// low dimensions, the FP32 pipe (3 D flops a pair) from about 27 axes on.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d2.cuh"

namespace {

using namespace kdt;

constexpr int kPoints = 256;     // points a block, one a thread
constexpr int kQueries = 32;     // queries a block
constexpr int kBatch = 8;        // running sums a thread holds
constexpr int kStageBytes = 96 * 1024;  // staged tiles past this are read in place
constexpr int kMaxGridY = 65535;

struct PairArgs {
  const float* q;   // [Q, D]
  const float* p;   // [T, D]
  float* out;       // [Q, T]
  long long T;
  int Q, D;
  int stride;       // staged point row stride (D rounded up to odd)
  int staged;       // the tiles sit in shared memory
};

__global__ void __launch_bounds__(kPoints) pair_d2_kernel(const PairArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D;
  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * kPoints;
  const long long q0 = static_cast<long long>(blockIdx.y) * kQueries;
  const int np = static_cast<int>(min(static_cast<long long>(kPoints), a.T - t0));
  const int nq = static_cast<int>(min(static_cast<long long>(kQueries), a.Q - q0));

  const float* prow;
  const float* qbase;
  if (a.staged) {
    float* sp = reinterpret_cast<float*>(smem_raw);
    float* sq = sp + kPoints * a.stride;
    for (int e = tid; e < np * D; e += blockDim.x) {
      const int r = e / D;
      sp[r * a.stride + (e - r * D)] = a.p[t0 * D + e];
    }
    for (int e = tid; e < nq * D; e += blockDim.x) sq[e] = a.q[q0 * D + e];
    __syncthreads();
    prow = sp + tid * a.stride;
    qbase = sq;
  } else {
    prow = a.p + (t0 + min(tid, max(np - 1, 0))) * D;
    qbase = a.q + q0 * D;
  }
  if (tid >= np) return;
  float* out = a.out + q0 * a.T + t0 + tid;

  if (D <= 32) {
    for (int b = 0; b < nq; b += kBatch) {
      float acc[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) acc[u] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float x = prow[d];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int qi = min(b + u, nq - 1);
          const float diff = __fsub_rn(qbase[qi * D + d], x);
          acc[u] = __fmaf_rn(diff, diff, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (b + u < nq) out[static_cast<long long>(b + u) * a.T] = acc[u];
      }
    }
  } else {
    for (int qi = 0; qi < nq; ++qi) {
      const float* qrow = qbase + static_cast<long long>(qi) * D;
      out[static_cast<long long>(qi) * a.T] = point_d2<0>(prow, nullptr, qrow, D);
    }
  }
}

}  // namespace

// queries f32[Q, D], ptile f32[T, D] -> out f32[Q, T]; contiguous device
// memory, D >= 1. Launches one grid per 65,535 x 32 query rows. Returns the
// first failed launch's CUDA error (0 = cudaSuccess; nothing is launched when
// Q or T is 0).
extern "C" int pair_d2_launch(const void* queries, const void* ptile, void* out, long long Q,
                              long long T, int D, void* stream) {
  if (Q <= 0 || T <= 0) return 0;
  PairArgs a;
  a.p = static_cast<const float*>(ptile);
  a.T = T;
  a.D = D;
  a.stride = D | 1;
  const size_t staged = (static_cast<size_t>(kPoints) * a.stride +
                         static_cast<size_t>(kQueries) * D) * 4;
  a.staged = staged <= static_cast<size_t>(kStageBytes);
  const size_t smem = a.staged ? staged : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_d2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per = static_cast<long long>(kMaxGridY) * kQueries;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (long long s = 0; s < Q; s += per) {
    const long long n = Q - s < per ? Q - s : per;
    a.q = static_cast<const float*>(queries) + s * D;
    a.out = static_cast<float*>(out) + s * T;
    a.Q = static_cast<int>(n);
    const dim3 grid(static_cast<unsigned>((T + kPoints - 1) / kPoints),
                    static_cast<unsigned>((n + kQueries - 1) / kQueries));
    pair_d2_kernel<<<grid, kPoints, smem, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
