// The query verbs' folds: radius and box containment over each query tile's
// candidate buckets, with exact per-query hit counts and an m-slot buffer.
//
// Replaces no TPU kernel: the JAX package runs these folds as fused XLA
// programs, the lax.scan over candidate chunks of
// kdtree_tpu/verbs/device.py::_radius_tiles (:172) and ::_range_tiles (:219).
// Their plain PyTorch versions are kdtree_tpu_torch/verbs/device.py::
// _radius_fold_plain and ::_range_fold_plain; the counts agree exactly and
// the kept rows, in canonical order, bit for bit.
//
// What it computes. Tile t holds TQ queries and a list of candidate buckets
// cand[t, :] (-1 padding anywhere). For every (query, point) pair of a
// candidate bucket the radius fold tests gid >= 0 && d2 <= r2 (d2 in
// d2.cuh's arithmetic, which the plain version's sq_dist reproduces; a
// negative r2 marks a padding row, which never hits), the range fold
// gid >= 0 && lo <= p <= hi on every axis (an empty box, lo = +inf and
// hi = -inf, marks a padding row). Only the gid test excludes a bucket's
// padding slots, whatever their coordinates. Each hit adds one to its
// query's count and takes the count before it as its slot: while the slot
// is < m it writes (d2, gid), or gid, there. So the counts are exact, and a
// query whose count is <= m holds every hit in its buffer, in arrival order;
// the caller retries whenever a count exceeds m and puts the rows it keeps in
// canonical order (verbs/device.py::canonical_radius_rows,
// canonical_range_rows). m = 0 is the count form: no buffer at all.
//
// Design for Hopper:
// 1. Grid (tile, chunk): block s walks a contiguous range of the tile's
//    candidate positions, so a request of one tile spreads over the SMs (the
//    caller sizes the chunks as it sizes the scan kernel's split).
// 2. Staged points. The range's buckets stream through two shared-memory
//    stages (whole buckets, or row parts of a bucket wider than a stage),
//    filled with 4-byte cp.async while the block tests the other stage.
// 3. A thread per point, the tile's queries in turn: the queries sit in
//    shared memory (every lane of a warp reads the same one, a broadcast),
//    and at D = 3 each thread holds its 4 points in registers. A warp's hits
//    for one query are counted with one ballot and one atomicAdd, which also
//    hands out their slots; the count form adds into shared counters and
//    flushes them once a block.
//
// What bounds it on the card: the FP32 pipe at the verbs' shapes (a subtract
// and an FMA per axis for each radius pair, two compares per axis for a box),
// then the candidate buckets' bytes; hits are few, and their atomics cheap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "d2.cuh"
#include "sm90_async.cuh"

namespace {

using namespace kdt;

constexpr int kThreads = 256;
constexpr int kMaxTQ = 256;               // queries per tile (the shared counters)
constexpr int kPPT = 4;                   // points a thread at D = 3
constexpr int kStageRows3 = kPPT * kThreads;
constexpr int kStageRowsMax = 256;        // rows a stage at other D
constexpr int kStagesBytes = 96 * 1024;   // both stages' budget at other D
constexpr int kQueryBytes = 96 * 1024;    // queries past this stay in device memory
constexpr unsigned kFull = 0xffffffffu;

struct FoldArgs {
  const float* qa;   // radius: tq [T, TQ, D]; range: lo [T, TQ, D]
  const float* qb;   // radius: r2 [T, TQ]; range: hi [T, TQ, D]
  const int* cand;   // [T, C]
  const float* pts;  // [NB, B, D]
  const int* gid;    // [NB, B]
  int* counts;       // [T, TQ], zeroed by the caller
  float* out_d;      // [T, TQ, m], +inf filled, or null (range; m == 0)
  int* out_i;        // [T, TQ, m], -1 filled, or null (m == 0)
  int TQ, D, C, B, m, chunk;
  int rows;          // rows a unit (a bucket, or a row part of one)
  int parts;         // units a bucket
  int units;         // units a stage
  int srows;         // a stage's row capacity (>= units * rows)
  int qsmem;         // the queries are staged in shared memory
  int qfloats;       // floats of the staged queries (a multiple of 4)
};

// One warp's hits for query q: one atomicAdd per warp counts them (shared
// counters in the count form) and hands out their slots.
template <bool RANGE>
__device__ __forceinline__ void record(const FoldArgs& a, int* scnt, long long row, int q,
                                       bool hit, float d, int g, int lane) {
  const unsigned mask = __ballot_sync(kFull, hit);
  if (mask == 0) return;
  const int leader = __ffs(mask) - 1;
  if (a.m == 0) {
    if (lane == leader) atomicAdd(scnt + q, __popc(mask));
    return;
  }
  int base = 0;
  if (lane == leader) base = atomicAdd(a.counts + row, __popc(mask));
  base = __shfl_sync(kFull, base, leader);
  if (hit) {
    const int slot = base + __popc(mask & ((1u << lane) - 1u));
    if (slot < a.m) {
      const long long o = row * a.m + slot;
      if (!RANGE) a.out_d[o] = d;
      a.out_i[o] = (RANGE || d < INFINITY) ? g : -1;  // an id beside a finite d2 only
    }
  }
}

// Start filling stage buffer (sp, sg) with units [u0, u0 + a.units) of the
// block's range [c0, c1): a unit's rows go to a fixed stride of a.rows, and
// a slot with no real row gets gid -1.
__device__ __forceinline__ void fill(const FoldArgs& a, const int* tcand, int c0, int nunits,
                                     int u0, float* sp, int* sg) {
  const int D = a.D;
  for (int g = 0; g < a.units; ++g) {
    const int u = u0 + g;
    int b = -1, n = 0;
    long long src = 0;
    if (u < nunits) {
      const int c = c0 + u / a.parts;
      const int r = u - (u / a.parts) * a.parts;
      b = tcand[c];
      n = min(a.rows, a.B - r * a.rows);
      src = static_cast<long long>(b) * a.B + static_cast<long long>(r) * a.rows;
    }
    float* dst = sp + static_cast<long long>(g) * a.rows * D;
    int* gdst = sg + g * a.rows;
    if (b >= 0) {
      const float* s = a.pts + src * D;
      for (int e = threadIdx.x; e < n * D; e += blockDim.x) sm90::cp_async4(dst + e, s + e);
    }
    for (int e = threadIdx.x; e < a.rows; e += blockDim.x) {
      if (b >= 0 && e < n) {
        sm90::cp_async4(gdst + e, a.gid + src + e);
      } else {
        gdst[e] = -1;
      }
    }
  }
}

// One block of either fold. DC == 3: D = 3, the queries staged as float4s
// (radius: x, y, z, r2; range: lo then hi) and each thread's kPPT points in
// registers. DC == 0: any D, a thread's points read from the stage, the
// queries from shared memory or, when they do not fit, from device memory.
template <int DC, bool RANGE>
__device__ __forceinline__ void fold_block(const FoldArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int scnt[kMaxTQ];

  const int D = DC > 0 ? DC : a.D;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int TQ = a.TQ;
  const long long row0 = static_cast<long long>(t) * TQ;

  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sp0 = sq + a.qfloats;
  int* sg0 = reinterpret_cast<int*>(sp0 + 2 * a.srows * D);

  // the tile's queries into shared memory
  if (DC == 3) {
    for (int e = tid; e < TQ * 4; e += blockDim.x) {
      const int q = e >> 2, d = e & 3;
      if (RANGE) {
        sq[q * 8 + d] = d < 3 ? a.qa[(row0 + q) * 3 + d] : 0.f;
        sq[q * 8 + 4 + d] = d < 3 ? a.qb[(row0 + q) * 3 + d] : 0.f;
      } else {
        sq[e] = d < 3 ? a.qa[(row0 + q) * 3 + d] : a.qb[row0 + q];
      }
    }
  } else if (RANGE) {
    if (a.qsmem) {
      for (int e = tid; e < TQ * D; e += blockDim.x) {
        sq[e] = a.qa[row0 * D + e];
        sq[TQ * D + e] = a.qb[row0 * D + e];
      }
    }
  } else {
    for (int e = tid; e < TQ; e += blockDim.x) sq[e] = a.qb[row0 + e];
    if (a.qsmem) {
      for (int e = tid; e < TQ * D; e += blockDim.x) sq[TQ + e] = a.qa[row0 * D + e];
    }
  }
  for (int e = tid; e < TQ; e += blockDim.x) scnt[e] = 0;

  // DC == 0: where the tile's rows of qa and qb live (shared or device
  // memory; r2 always shared)
  const float* ra;
  const float* rb;
  if (RANGE) {
    ra = a.qsmem ? sq : a.qa + row0 * D;
    rb = a.qsmem ? sq + TQ * D : a.qb + row0 * D;
  } else {
    ra = a.qsmem ? sq + TQ : a.qa + row0 * D;
    rb = sq;
  }

  const int* tcand = a.cand + static_cast<long long>(t) * a.C;
  const int c0 = blockIdx.y * a.chunk;
  const int c1 = min(c0 + a.chunk, a.C);
  const int nunits = max(c1 - c0, 0) * a.parts;
  const int nstages = (nunits + a.units - 1) / a.units;
  const int slots = a.units * a.rows;

  if (nstages > 0) fill(a, tcand, c0, nunits, 0, sp0, sg0);
  sm90::cp_async_commit();
  for (int i = 0; i < nstages; ++i) {
    const int buf = i & 1;
    if (i + 1 < nstages) {
      fill(a, tcand, c0, nunits, (i + 1) * a.units, sp0 + (buf ^ 1) * a.srows * D,
           sg0 + (buf ^ 1) * a.srows);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();  // stage i (and, the first time, the queries) visible
    const float* sp = sp0 + buf * a.srows * D;
    const int* sg = sg0 + buf * a.srows;

    if (DC == 3) {
      float px[kPPT], py[kPPT], pz[kPPT];
      int pg[kPPT];
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int j = tid + k * kThreads;
        const bool ok = j < slots;
        pg[k] = ok ? sg[j] : -1;
        px[k] = ok ? sp[3 * j] : 0.f;
        py[k] = ok ? sp[3 * j + 1] : 0.f;
        pz[k] = ok ? sp[3 * j + 2] : 0.f;
      }
      const float4* q4 = reinterpret_cast<const float4*>(sq);
      for (int q = 0; q < TQ; ++q) {
        bool hit[kPPT];
        float d[kPPT];
        bool any = false;
        if (RANGE) {
          const float4 lo = q4[2 * q];
          const float4 hi = q4[2 * q + 1];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            d[k] = 0.f;
            hit[k] = pg[k] >= 0 && px[k] >= lo.x && px[k] <= hi.x && py[k] >= lo.y &&
                     py[k] <= hi.y && pz[k] >= lo.z && pz[k] <= hi.z;
            any = any || hit[k];
          }
        } else {
          const float4 qq = q4[q];
          const float qv[3] = {qq.x, qq.y, qq.z};
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            d[k] = d2_3(qv, px[k], py[k], pz[k]);
            hit[k] = pg[k] >= 0 && d[k] <= qq.w;
            any = any || hit[k];
          }
        }
        if (__any_sync(kFull, any)) {
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            record<RANGE>(a, scnt, row0 + q, q, hit[k], d[k], pg[k], lane);
          }
        }
      }
    } else {
      const int per = (slots + kThreads - 1) / kThreads;
      for (int k = 0; k < per; ++k) {
        const int j = tid + k * kThreads;
        const int g = j < slots ? sg[j] : -1;
        const float* p = sp + static_cast<long long>(j) * D;
        for (int q = 0; q < TQ; ++q) {
          bool hit = false;
          float d = 0.f;
          if (g >= 0) {
            if (RANGE) {
              const float* lo = ra + static_cast<long long>(q) * D;
              const float* hi = rb + static_cast<long long>(q) * D;
              hit = true;
              for (int x = 0; x < D && hit; ++x) hit = p[x] >= lo[x] && p[x] <= hi[x];
            } else {
              d = point_d2<0>(p, nullptr, ra + static_cast<long long>(q) * D, D);
              hit = d <= rb[q];
            }
          }
          if (__any_sync(kFull, hit)) record<RANGE>(a, scnt, row0 + q, q, hit, d, g, lane);
        }
      }
    }
    __syncthreads();  // every reader of this stage is done before it refills
  }
  sm90::cp_async_wait_all();
  if (a.m == 0) {
    for (int q = tid; q < TQ; q += blockDim.x) {
      if (scnt[q] != 0) atomicAdd(a.counts + row0 + q, scnt[q]);
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kThreads) verb_radius_fold_kernel(const FoldArgs a) {
  fold_block<DC, false>(a);
}

template <int DC>
__global__ void __launch_bounds__(kThreads) verb_range_fold_kernel(const FoldArgs a) {
  fold_block<DC, true>(a);
}

template <int DC, bool RANGE>
int launch(const FoldArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  void (*kernel)(const FoldArgs) = RANGE ? verb_range_fold_kernel<DC> : verb_radius_fold_kernel<DC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int fold_launch(bool range, const void* qa, const void* qb, const void* cand, const void* pts,
                const void* gid, void* counts, void* out_d, void* out_i, int T, int TQ, int D,
                int C, int B, int m, int S, void* stream) {
  if (T <= 0 || C <= 0) return 0;
  FoldArgs a;
  a.qa = static_cast<const float*>(qa);
  a.qb = static_cast<const float*>(qb);
  a.cand = static_cast<const int*>(cand);
  a.pts = static_cast<const float*>(pts);
  a.gid = static_cast<const int*>(gid);
  a.counts = static_cast<int*>(counts);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.TQ = TQ;
  a.D = D;
  a.C = C;
  a.B = B;
  a.m = m;
  a.chunk = (C + S - 1) / S;
  const bool d3 = D == 3;
  int srows = d3 ? kStageRows3 : kStagesBytes / (2 * (D + 1) * 4);
  if (!d3 && srows > kStageRowsMax) srows = kStageRowsMax;
  if (srows < 1) srows = 1;
  a.rows = B < srows ? B : srows;
  a.parts = (B + a.rows - 1) / a.rows;
  a.units = srows / a.rows;
  a.srows = srows;
  size_t qbytes;
  if (d3) {
    qbytes = static_cast<size_t>(TQ) * (range ? 8 : 4) * 4;
    a.qsmem = 1;
  } else {
    const size_t rows_bytes = static_cast<size_t>(TQ) * D * 4 * (range ? 2 : 1);
    a.qsmem = rows_bytes <= static_cast<size_t>(kQueryBytes);
    qbytes = (a.qsmem ? rows_bytes : 0) + (range ? 0 : static_cast<size_t>(TQ) * 4);
  }
  qbytes = (qbytes + 15) & ~static_cast<size_t>(15);
  a.qfloats = static_cast<int>(qbytes / 4);
  const size_t smem = qbytes + static_cast<size_t>(2) * srows * (D + 1) * 4;
  const dim3 grid(T, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (range) {
    return d3 ? launch<3, true>(a, grid, smem, st) : launch<0, true>(a, grid, smem, st);
  }
  return d3 ? launch<3, false>(a, grid, smem, st) : launch<0, false>(a, grid, smem, st);
}

}  // namespace

// tq f32[T, TQ, D], r2 f32[T, TQ] (< 0: a padding row), cand i32[T, C] (-1
// padding), pts f32[NB, B, D], gid i32[NB, B] -> counts i32[T, TQ] (zeroed by
// the caller, added into), and for m > 0 out_d f32[T, TQ, m] / out_i
// i32[T, TQ, m] (filled +inf / -1 by the caller; null when m == 0). The grid
// is (T, S), each block ceil(C / S) positions. 1 <= TQ <= 256, 1 <= S <=
// 65535, 2 (D + 1) 4 <= 96 KB, every cand entry -1 or a bucket < NB; every
// pointer is device memory, contiguous. Returns the launch's CUDA error
// (0 = cudaSuccess; nothing is launched for T == 0 or C == 0).
extern "C" int verb_radius_fold_launch(const void* tq, const void* r2, const void* cand,
                                       const void* pts, const void* gid, void* counts,
                                       void* out_d, void* out_i, int T, int TQ, int D, int C,
                                       int B, int m, int S, void* stream) {
  return fold_launch(false, tq, r2, cand, pts, gid, counts, out_d, out_i, T, TQ, D, C, B, m, S,
                     stream);
}

// The range fold: lo / hi f32[T, TQ, D] per-query boxes (inclusive faces;
// an empty box marks a padding row), out_i i32[T, TQ, m] (-1 filled, null
// when m == 0); the rest as the radius fold.
extern "C" int verb_range_fold_launch(const void* lo, const void* hi, const void* cand,
                                      const void* pts, const void* gid, void* counts,
                                      void* out_i, int T, int TQ, int D, int C, int B, int m,
                                      int S, void* stream) {
  return fold_launch(true, lo, hi, cand, pts, gid, counts, nullptr, out_i, T, TQ, D, C, B, m, S,
                     stream);
}
