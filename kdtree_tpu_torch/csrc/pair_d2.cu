// The exact brute-force oracle's distance block: every squared distance
// between Q query rows and T point rows.
//
// Replaces no TPU kernel: the JAX package's oracle computes this block as the
// jitted XLA fusion kdtree_tpu/ops/bruteforce.py::_block_d2_exact (:44). Its
// plain PyTorch version is kdtree_tpu_torch/ops/_arith.py::sq_dist over the
// broadcast rows (kdtree_tpu_torch/kernels/pair_d2.py::pair_d2_plain), which
// this kernel matches bit for bit: the FMA chain of d2.cuh up to 32 axes, the
// rounded squares summed in windows of 32 above. Its callers are the verb
// oracle's blocks (kdtree_tpu_torch/verbs/oracle.py) and the D-sharded
// partial sums (kdtree_tpu_torch/parallel/dsharded.py); the exact k-NN
// oracle runs the fused knn_scan.cu instead, which never writes this block.
//
// What bounds it on the card: the output's bytes (4 a pair) at low D, the
// FP32 pipe (3 D flops a pair; a subtract and an FMA, or a subtract, a
// multiply and an add above 32 axes, as instructions) from about 8 axes on.
//
// Design for Hopper (pair_tile.cuh): a block of 8 warps owns an 8 RQ x 32 RP
// tile of the block, a thread RQ queries x RP points in registers (8 x 4,
// or 4 x 8 up to 4 axes, where the output bounds it), so each
// shared-memory read of an axis value feeds RP or RQ arithmetic steps (the
// design before this one read a query value from shared memory for every
// FMA, and walked the point row again per query above 32 axes). Both
// tiles are staged transposed in slices of 32 axes by 4-byte cp.async,
// double-buffered when the row has more than one slice. A warp writes 32
// neighbouring floats of an output row per store (128 bytes, whatever T's
// alignment).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tile.cuh"

namespace {

using namespace kdt;

constexpr int kMaxGridY = 65535;

struct PairArgs {
  const float* q;  // [Q, D]
  const float* p;  // [T, D]
  float* out;      // [Q, T]
  long long T;
  int Q, D;
};

template <int RQ>
__host__ __device__ constexpr int ldq() {
  return kTileWarps * RQ + 4;  // keeps a warp's RQ values 16-byte aligned
}

template <int MODE, int RQ, int RP>
__global__ void __launch_bounds__(kTileThreads, MODE == kFma ? 3 : 2)
    pair_d2_kernel(const PairArgs a) {
  constexpr int BQ = kTileWarps * RQ;
  constexpr int LDQ = ldq<RQ>();
  constexpr int kBP = 32 * RP;    // points a block
  constexpr int kLdp = kBP + 1;   // staged point stride: 32 banks for a warp's writes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D;
  const int ds0 = D < kSlice ? D : kSlice;
  const int nsl = (D + kSlice - 1) / kSlice;
  float* sq = reinterpret_cast<float*>(smem_raw);        // [nbuf][ds0][LDQ]
  float* sp = sq + (nsl > 1 ? 2 : 1) * ds0 * LDQ;        // [nbuf][ds0][kLdp]
  const long long t0 = static_cast<long long>(blockIdx.x) * kBP;
  const long long q0 = static_cast<long long>(blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Windows win(D);

  Sums<RQ, RP> s;
  s.clear();
  stage_rows(sq, LDQ, a.q, q0, a.Q - 1, BQ, D, 0, ds0);
  stage_rows(sp, kLdp, a.p, t0, a.T - 1, kBP, D, 0, ds0);
  sm90::cp_async_commit();
  for (int j = 0; j < nsl; ++j) {
    const int b = j & 1;
    if (j + 1 < nsl) {  // the next slice into the other buffer
      const int d1 = (j + 1) * kSlice;
      const int ds1 = D - d1 < kSlice ? D - d1 : kSlice;
      stage_rows(sq + (b ^ 1) * ds0 * LDQ, LDQ, a.q, q0, a.Q - 1, BQ, D, d1, ds1);
      stage_rows(sp + (b ^ 1) * ds0 * kLdp, kLdp, a.p, t0, a.T - 1, kBP, D, d1, ds1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int d0 = j * kSlice;
    const int ds = D - d0 < kSlice ? D - d0 : kSlice;
    accumulate<MODE>(s, sq + b * ds0 * LDQ, LDQ, sp + b * ds0 * kLdp, kLdp, warp * RQ, d0, ds,
                     D, win);
    if (j + 1 < nsl) __syncthreads();  // read before the slice after next overwrites it
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const long long qi = q0 + warp * RQ + i;
    if (qi >= a.Q) break;
    float* row = a.out + qi * a.T + t0 + lane;
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      if (t0 + lane + 32 * j < a.T) row[32 * j] = s.template result<MODE>(i, j);
    }
  }
}

template <int MODE, int RQ, int RP>
int launch(PairArgs a, long long Q, int D, cudaStream_t st) {
  constexpr int BQ = kTileWarps * RQ;
  constexpr int kBP = 32 * RP;
  constexpr int kLdp = kBP + 1;
  const int ds0 = D < kSlice ? D : kSlice;
  const int nbuf = D > kSlice ? 2 : 1;
  const size_t smem = static_cast<size_t>(nbuf) * ds0 * (ldq<RQ>() + kLdp) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_d2_kernel<MODE, RQ, RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float* queries = a.q;
  float* out = a.out;
  const long long per = static_cast<long long>(kMaxGridY) * BQ;
  for (long long s = 0; s < Q; s += per) {
    const long long n = Q - s < per ? Q - s : per;
    a.q = queries + s * D;
    a.out = out + s * a.T;
    a.Q = static_cast<int>(n);
    const dim3 grid(static_cast<unsigned>((a.T + kBP - 1) / kBP),
                    static_cast<unsigned>((n + BQ - 1) / BQ));
    pair_d2_kernel<MODE, RQ, RP><<<grid, kTileThreads, smem, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// queries f32[Q, D], ptile f32[T, D] -> out f32[Q, T]; contiguous device
// memory, D >= 1. Launches one grid per 65,535 query tiles. Returns the
// first failed launch's CUDA error (0 = cudaSuccess; nothing is launched when
// Q or T is 0).
extern "C" int pair_d2_launch(const void* queries, const void* ptile, void* out, long long Q,
                              long long T, int D, void* stream) {
  if (Q <= 0 || T <= 0) return 0;
  PairArgs a;
  a.q = static_cast<const float*>(queries);
  a.p = static_cast<const float*>(ptile);
  a.out = static_cast<float*>(out);
  a.T = T;
  a.D = D;
  a.Q = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // up to 4 axes the output's bytes bound it, and 4 x 8 tiles (rows of 256
  // points a block) write it fastest; above, 8 x 4 tiles read the fewest
  // shared-memory words an FMA (chip_smoke.py phase 3b times both shapes'
  // dimensions)
  switch (sum_mode(D)) {
    case kFma:
      return D <= 4 ? launch<kFma, 4, 8>(a, Q, D, st) : launch<kFma, 8, 4>(a, Q, D, st);
    case kWin:
      return launch<kWin, 8, 4>(a, Q, D, st);
    default:
      return launch<kWin2, 4, 4>(a, Q, D, st);
  }
}
