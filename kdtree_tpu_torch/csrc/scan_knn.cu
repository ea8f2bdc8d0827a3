// Fused bucket scan + per-query top-k fold for the tiled k-NN engine.
//
// Replaces the TPU kernel kdtree_tpu/pallas/scan_knn.py::_scan_kernel
// (launched by _scan_tiles_fused_impl, kdtree_tpu/pallas/scan_knn.py:216).
// Its plain PyTorch version is kdtree_tpu_torch/ops/tile_query.py::_scan_tiles;
// the two agree bit for bit on distances and ids.
//
// What it computes. One CTA per query tile t, one thread per query. The
// tile's candidate buckets cand[t, :] arrive lb-ascending (the collect
// frontier's order, -1 padding). Before bucket c the block takes the max
// over its queries of the current k-th distance and stops once
// !(lb[t, c] < max): no point of that bucket or of any later one can beat
// a held neighbour (lb <= d2 holds in float arithmetic too). Otherwise the
// block stages the bucket's B x D coordinates and B ids in shared memory and
// every thread folds the B squared distances into its ascending k-buffer.
//
// Arithmetic and ties. d2 is accumulated axis by axis, d = 0..D-1, as
// acc = fma(diff, diff, acc) with diff = q_d - p_d (__fsub_rn / __fmaf_rn):
// one rounding per step, the contraction XLA:CPU applies to the JAX scan
// and that the plain version reproduces exactly. A candidate enters only
// if d2 < k-th (strict) and is placed after held entries of equal
// distance: the incumbent wins, so the result does not depend on where
// the early exit stopped. +inf padding rows and -1 buckets never enter.
//
// What bounds it on the card. It reads each visited bucket's B * D
// coordinates and B ids (B * (D + 1) * 4 bytes) plus the tile's queries,
// once per CTA, and does ~3 * D flops per (query, point) pair (a subtract
// and a fused multiply-add per axis). Every staged bucket feeds all TQ
// queries of the tile, so at the main path's shape (TQ = 128, B = 256,
// D = 3) that is ~72 flops per byte read, above the card's ~20 flop/byte
// FP32 ridge: the FP32 rate bounds it, then the per-pair compare/insert.
//
// Simple design, left for later: no cp.async/TMA double-buffering (a
// bucket is loaded, then consumed, behind two __syncthreads), one tile per
// CTA (a 128-query tile fills four warps), register k-buffers only for
// k <= 32 (k is rounded up to a power of two; larger k keeps the buffer in
// the thread's own output row in device memory). Buckets are staged in row
// chunks of at most 32 KB, so shared memory never needs the opt-in above
// 48 KB whatever D * B is.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;    // queries per tile (one thread each)
constexpr int kStageBytes = 32 * 1024;  // bucket row-chunk staging budget
constexpr int kRegDims = 8;             // query coords held in registers up to this D

__device__ __forceinline__ float block_max(float v, float* red) {
  __syncthreads();  // red[] is reused: every reader of the last round is done
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float m = red[0];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
  return m;
}

// KB > 0: the k-buffer lives in registers, KB >= k slots of which the
// first k are used. KB == 0: it lives in the thread's output row.
// DQ > 0: query coordinates in registers (D <= DQ). DQ == 0: read from
// the query row in device memory.
template <int KB, int DQ>
__global__ void __launch_bounds__(kMaxThreads)
scan_knn_kernel(const float* __restrict__ tq, const int* __restrict__ cand,
                const float* __restrict__ lb, const float* __restrict__ pts,
                const int* __restrict__ gid, float* __restrict__ out_d,
                int* __restrict__ out_i, int* __restrict__ visited, int TQ,
                int D, int C, int B, int k, int rows_per_stage) {
  extern __shared__ float smem[];
  float* sp = smem;                                            // [rows * D]
  int* sg = reinterpret_cast<int*>(smem + rows_per_stage * D);  // [rows]
  __shared__ float red[kMaxThreads / 32];

  const long long t = blockIdx.x;
  const int q = threadIdx.x;
  const bool active = q < TQ;
  const long long row = t * TQ + (active ? q : 0);
  const float* qrow = tq + row * D;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;

  constexpr int NQ = DQ > 0 ? DQ : 1;
  float qv[NQ];
#pragma unroll
  for (int d = 0; d < NQ; ++d) qv[d] = (DQ > 0 && active && d < D) ? qrow[d] : 0.f;

  constexpr int NB = KB > 0 ? KB : 1;
  float bd[NB];
  int bi[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }
  if (KB == 0 && active) {
    for (int s = 0; s < k; ++s) {
      od[s] = INFINITY;
      oi[s] = -1;
    }
  }
  float kth = INFINITY;

  const int* tcand = cand + t * C;
  const float* tlb = lb + t * C;
  int nvis = 0;
  for (int c = 0; c < C; ++c) {
    // inactive threads are masked out of the reduction with -inf
    const float worst = block_max(active ? kth : -INFINITY, red);
    if (!(tlb[c] < worst)) break;  // uniform: every thread reads the same
    const int b = tcand[c];
    if (b < 0) continue;
    ++nvis;
    const float* bp = pts + static_cast<long long>(b) * B * D;
    const int* bg = gid + static_cast<long long>(b) * B;
    for (int r0 = 0; r0 < B; r0 += rows_per_stage) {
      const int rows = min(rows_per_stage, B - r0);
      __syncthreads();  // the previous chunk's readers are done
      for (int e = threadIdx.x; e < rows * D; e += blockDim.x) sp[e] = bp[r0 * D + e];
      for (int e = threadIdx.x; e < rows; e += blockDim.x) sg[e] = bg[r0 + e];
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < rows; ++j) {
        const float* p = sp + j * D;
        float acc = 0.f;
        if (DQ > 0) {
#pragma unroll
          for (int d = 0; d < NQ; ++d) {
            if (d < D) {
              const float diff = __fsub_rn(qv[d], p[d]);
              acc = __fmaf_rn(diff, diff, acc);
            }
          }
        } else {
          for (int d = 0; d < D; ++d) {
            const float diff = __fsub_rn(qrow[d], p[d]);
            acc = __fmaf_rn(diff, diff, acc);
          }
        }
        if (!(acc < kth)) continue;
        const int g = sg[j];
        if (KB > 0) {
          bool placed = false;
#pragma unroll
          for (int s = NB - 1; s > 0; --s) {
            if (s < k && !placed) {
              if (bd[s - 1] > acc) {
                bd[s] = bd[s - 1];
                bi[s] = bi[s - 1];
              } else {
                bd[s] = acc;
                bi[s] = g;
                placed = true;
              }
            }
          }
          if (!placed) {
            bd[0] = acc;
            bi[0] = g;
          }
#pragma unroll
          for (int s = 0; s < NB; ++s) {
            if (s == k - 1) kth = bd[s];
          }
        } else {
          int s = k - 1;
          while (s > 0 && od[s - 1] > acc) {
            od[s] = od[s - 1];
            oi[s] = oi[s - 1];
            --s;
          }
          od[s] = acc;
          oi[s] = g;
          kth = od[k - 1];
        }
      }
    }
  }
  if (KB > 0 && active) {
#pragma unroll
    for (int s = 0; s < NB; ++s) {
      if (s < k) {
        od[s] = bd[s];
        oi[s] = bi[s];
      }
    }
  }
  if (visited != nullptr && threadIdx.x == 0) visited[t] = nvis;
}

template <int KB>
void launch_kb(dim3 grid, int threads, size_t smem, cudaStream_t stream,
               const float* tq, const int* cand, const float* lb,
               const float* pts, const int* gid, float* out_d, int* out_i,
               int* visited, int TQ, int D, int C, int B, int k, int rows) {
  if (D <= kRegDims) {
    scan_knn_kernel<KB, kRegDims><<<grid, threads, smem, stream>>>(
        tq, cand, lb, pts, gid, out_d, out_i, visited, TQ, D, C, B, k, rows);
  } else {
    scan_knn_kernel<KB, 0><<<grid, threads, smem, stream>>>(
        tq, cand, lb, pts, gid, out_d, out_i, visited, TQ, D, C, B, k, rows);
  }
}

}  // namespace

// tq f32[T, TQ, D], cand i32[T, C], lb f32[T, C], pts f32[NBP, B, D],
// gid i32[NBP, B] -> out_d f32[T, TQ, k], out_i i32[T, TQ, k], ascending;
// visited i32[T] (may be null) gets each tile's count of scanned buckets.
// Every pointer is device memory, contiguous. 1 <= TQ <= 256, k >= 1,
// (D + 1) * 4 <= 48 KB, and every cand entry is -1 or a bucket < NBP.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int scan_knn_launch(const void* tq, const void* cand, const void* lb,
                               const void* pts, const void* gid, void* out_d,
                               void* out_i, void* visited, int T, int TQ, int D,
                               int C, int B, int k, void* stream) {
  if (T <= 0) return 0;
  const int threads = ((TQ + 31) / 32) * 32;
  int rows = kStageBytes / ((D + 1) * 4);
  if (rows > B) rows = B;
  if (rows < 1) rows = 1;
  const size_t smem = static_cast<size_t>(rows) * (D + 1) * sizeof(float);
  const dim3 grid(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(tq);
  const int* c = static_cast<const int*>(cand);
  const float* l = static_cast<const float*>(lb);
  const float* p = static_cast<const float*>(pts);
  const int* g = static_cast<const int*>(gid);
  float* o = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  int* v = static_cast<int*>(visited);
  if (k <= 1) {
    launch_kb<1>(grid, threads, smem, s, a, c, l, p, g, o, oi, v, TQ, D, C, B, k, rows);
  } else if (k <= 2) {
    launch_kb<2>(grid, threads, smem, s, a, c, l, p, g, o, oi, v, TQ, D, C, B, k, rows);
  } else if (k <= 4) {
    launch_kb<4>(grid, threads, smem, s, a, c, l, p, g, o, oi, v, TQ, D, C, B, k, rows);
  } else if (k <= 8) {
    launch_kb<8>(grid, threads, smem, s, a, c, l, p, g, o, oi, v, TQ, D, C, B, k, rows);
  } else if (k <= 16) {
    launch_kb<16>(grid, threads, smem, s, a, c, l, p, g, o, oi, v, TQ, D, C, B, k, rows);
  } else if (k <= 32) {
    launch_kb<32>(grid, threads, smem, s, a, c, l, p, g, o, oi, v, TQ, D, C, B, k, rows);
  } else {
    launch_kb<0>(grid, threads, smem, s, a, c, l, p, g, o, oi, v, TQ, D, C, B, k, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
