// Fused bucket scan + per-query top-k fold for the tiled k-NN engine.
//
// Replaces the TPU kernel kdtree_tpu/pallas/scan_knn.py::_scan_kernel
// (launched by _scan_tiles_fused_impl, kdtree_tpu/pallas/scan_knn.py:216).
// Its plain PyTorch version is kdtree_tpu_torch/ops/tile_query.py::_scan_tiles
// (and merge_partials for the second kernel here); they agree bit for bit
// on distances and ids.
//
// What it computes. Each query tile t has candidate buckets cand[t, :],
// lb-ascending (the collect frontier's order, -1 padding), and every query
// of the tile folds the squared distances to those buckets' points into an
// ascending k-buffer. A walk may stop once no later bucket can beat a held
// neighbour (lb <= d2 holds in float arithmetic too).
//
// Arithmetic and ties. d2 is accumulated axis by axis, d = 0..D-1, as
// acc = fma(diff, diff, acc) with diff = q_d - p_d (__fsub_rn / __fmaf_rn):
// the contraction XLA:CPU applies to the JAX scan, which the plain version
// reproduces exactly. Above 32 axes XLA:CPU rounds each square and sums the
// row in windows of 32 instead (window_sum in d2.cuh; the plain version's
// _arith.sq_sum_windows), and so does this kernel, box bounds included. A candidate enters only if d2 < k-th (strict) and is
// placed after held entries of equal distance, so a buffer is the top k by
// (d2, position in the walk), wherever the walk stopped.
//
// Design for Hopper:
//
// 1. Split walk, exact merge. The grid is (tile, chunk): chunk s walks a
//    contiguous range of the tile's candidate list into a partial top-k
//    per query. scan_knn_merge_kernel then keeps, per query, the k
//    smallest partial entries by (d2, chunk), which is (d2, position): the
//    sequential walk's answer, through a threshold from the chunks' k-th
//    entries and a block-parallel select (the merge's own note below). The
//    chunks of a tile share a per-query bound q_worst[t, q] (float bits,
//    lowered with atomicMin): once chunk s' holds k entries <= w for query
//    q, no point with d2 > w can enter q's answer, whatever its position.
//    A chunk therefore skips a bucket for q when its bound is >= q's own
//    k-th or > q_worst (strictly: an equal point in an earlier chunk would
//    win the tie), and stops when that holds for every query at the next
//    lb. The answer does not depend on timing; how far each chunk gets does.
// 2. Staged buckets. A ring of kStages stages in shared memory, each one
//    bucket (or a row chunk of one, when B * (D + 1) * 4 exceeds the stage
//    budget). One thread issues each stage as two 1-D bulk copies
//    (cp.async.bulk, completing on the stage's mbarrier), kStages - 1
//    buckets ahead of the scan; shapes whose rows are not 16-byte multiples
//    use 4-byte cp.async from every thread instead. The candidate ids,
//    lbs and leaf boxes come in windows of kWindow positions. One
//    __syncthreads per stage releases the stage and publishes each warp's
//    flags; the exit test reads flags one stage old (a stale k-th is only
//    larger, so the walk exits later, never wrongly).
// 3. ILP. Each thread computes d2 for a group of 4 points (3 LDS.128 at
//    D = 3) before one compare of the group's minimum with its k-th; the
//    insert path runs only when some point of the group beats it, and then
//    in position order, so the tie rule holds.
// 4. Per-warp bucket skip. Before a bucket, each query bounds its squared
//    distance to the bucket's box with the same arithmetic as a point's
//    (gap 0 inside); the warp skips the bucket when no lane's bound beats its
//    k-th. Rounding is monotone, so the bound is <= every point's d2, and
//    under the strict insert no point of a skipped bucket could enter. The
//    same test, kStages - 1 stages ahead and OR-ed over the warps, decides
//    whether a bucket is loaded at all.
//
// What bounds it on the card: the FP32 pipe (a subtract and an FMA per axis
// per (query, point) pair) at the main path's shapes, and the bytes of the
// buckets at sparse serving shapes; the skip lets it undercut both counts,
// which assume every query meets every bucket its tile must visit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "d2.cuh"
#include "sm90_async.cuh"

namespace {

using namespace kdt;

constexpr int kMaxThreads = 256;  // queries per tile (one thread each)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStages = 4;               // ring depth (a power of two)
constexpr int kStageBytes = 8 * 1024;    // one stage's budget: B rows of D + 1 words
constexpr int kWindow = 128;             // candidate positions per window load
constexpr int kWinSlots = kWindow + kStages;
constexpr int kWorstEvery = 4;           // positions between reads of q_worst
constexpr int kInfBits = 0x7f800000;     // +inf as int bits
constexpr unsigned kFull = 0xffffffffu;

struct ScanArgs {
  const float* tq;       // [T, TQ, D]
  const int* cand;       // [T, C]
  const float* lb;       // [T, C]
  const float* pts;      // [NBP, B, D]
  const int* gid;        // [NBP, B]
  const float* node_lo;  // [2 NBP - 1, D]; leaf of bucket b is NBP - 1 + b
  const float* node_hi;
  float* out_d;          // [T, S, TQ, k]
  int* out_i;
  int* visited;          // [T] or null, summed over chunks
  int* q_worst;          // [T, TQ] float bits, or null when S == 1
  int TQ, D, C, B, k, S, chunk, nbp, rows, bulk;
};

// Strict insert into an ascending register buffer of KB >= k slots, held
// in the top k slots (the lower KB - k hold -inf and never move), so the
// k-th is always bd[KB - 1]: every index is a constant and the buffer stays
// in registers.
template <int KB>
__device__ __forceinline__ void insert_reg(float (&bd)[KB], int (&bi)[KB], float d, int g) {
  bool placed = false;
#pragma unroll
  for (int s = KB - 1; s > 0; --s) {
    if (!placed) {
      if (bd[s - 1] > d) {
        bd[s] = bd[s - 1];
        bi[s] = bi[s - 1];
      } else {
        bd[s] = d;
        bi[s] = g;
        placed = true;
      }
    }
  }
  if (!placed) {
    bd[0] = d;
    bi[0] = g;
  }
}

// The same insert into a buffer in device memory (k > 32).
__device__ __forceinline__ void insert_mem(float* od, int* oi, float& kth, int k, float d,
                                           int g) {
  int s = k - 1;
  while (s > 0 && od[s - 1] > d) {
    od[s] = od[s - 1];
    oi[s] = oi[s - 1];
    --s;
  }
  od[s] = d;
  oi[s] = g;
  kth = od[k - 1];
}

// Shared-memory views of one block: kStages stages of bucket rows and ids,
// the window of candidate ids, lbs and leaf boxes, the stages' mbarriers.
struct Smem {
  float* pts;      // [kStages][rows * D]
  int* gid;        // [kStages][rows]
  int* cand;       // [kWinSlots]
  float* lb;       // [kWinSlots]
  float* box;      // [kWinSlots][2 D] (lo then hi), DC > 0 only
  uint64_t* bar;   // [kStages]
};

// Window of positions [base, base + kWinSlots) of the block's range
// (ending at c1): candidate ids, lbs and, for DC > 0, the leaf boxes.
template <int DC>
__device__ __forceinline__ void win_load(const ScanArgs& a, const Smem& sm, const int* tcand,
                                         const float* tlb, int base, int c1, int D) {
  for (int e = threadIdx.x; e < kWinSlots; e += blockDim.x) {
    const int p = base + e;
    sm.cand[e] = p < c1 ? tcand[p] : -1;
    sm.lb[e] = p < c1 ? tlb[p] : INFINITY;
  }
  if (DC > 0) {
    const int bw = 2 * D;
    for (int e2 = threadIdx.x; e2 < kWinSlots * bw; e2 += blockDim.x) {
      const int e = e2 / bw;
      const int j = e2 - e * bw;
      const int p = base + e;
      const int b = p < c1 ? tcand[p] : -1;
      float v = 0.f;
      if (b >= 0) {
        const long long leaf = static_cast<long long>(a.nbp) - 1 + b;
        v = j < D ? a.node_lo[leaf * D + j] : a.node_hi[leaf * D + j - D];
      }
      sm.box[e2] = v;
    }
  }
}

// Whether this lane can take a point of bucket b (window slot e): its box
// bound beats the lane's k-th and is not above the shared bound gq.
template <int DC>
__device__ __forceinline__ bool lane_needs(const ScanArgs& a, const Smem& sm, int e, int b,
                                           const float* qv, const float* qrow, int D,
                                           bool active, float kth, float gq) {
  if (!active) return false;
  const float* lo;
  const float* hi;
  if (DC > 0) {
    lo = sm.box + e * 2 * D;
    hi = lo + D;
  } else {
    const long long leaf = static_cast<long long>(a.nbp) - 1 + b;
    lo = a.node_lo + leaf * D;
    hi = a.node_hi + leaf * D;
  }
  const float bnd = box_bound<DC>(lo, hi, qv, qrow, D);
  return bnd < kth && !(bnd > gq);
}

// Start filling stage st with row chunk r of bucket b.
__device__ __forceinline__ void fill(const ScanArgs& a, const Smem& sm, int st, int b, int r,
                                     int D) {
  const int rows = a.rows;
  const int n = min(rows, a.B - r * rows);
  const float* src = a.pts + (static_cast<long long>(b) * a.B + r * rows) * D;
  const int* gsrc = a.gid + static_cast<long long>(b) * a.B + r * rows;
  float* dst = sm.pts + st * rows * D;
  int* gdst = sm.gid + st * rows;
  if (a.bulk) {
    if (threadIdx.x == 0) {
      const uint32_t pb = static_cast<uint32_t>(n) * D * 4;
      const uint32_t gb = static_cast<uint32_t>(n) * 4;
      sm90::mbar_arrive_expect_tx(&sm.bar[st], pb + gb);
      sm90::bulk_copy_g2s(dst, src, pb, &sm.bar[st]);
      sm90::bulk_copy_g2s(gdst, gsrc, gb, &sm.bar[st]);
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += blockDim.x) sm90::cp_async4(dst + e, src + e);
    for (int e = threadIdx.x; e < n; e += blockDim.x) sm90::cp_async4(gdst + e, gsrc + e);
  }
}

// Bulk path, thread 0: ``pend`` marks stages whose last fill (of parity
// ``pend_par``) no wait of thread 0 has seen complete. Such a fill is waited
// for before its stage is re-armed and before the block exits, even when
// every warp skipped it.
__device__ __forceinline__ void settle(const Smem& sm, uint32_t& pend, uint32_t pend_par,
                                       int i) {
  if ((pend >> i) & 1u) {
    sm90::mbar_wait(&sm.bar[i], (pend_par >> i) & 1u);
    pend &= ~(1u << i);
  }
}

__device__ __forceinline__ void issue(const ScanArgs& a, const Smem& sm, int i, int b, int r,
                                      int D, uint32_t phase, uint32_t& loaded, uint32_t& pend,
                                      uint32_t& pend_par) {
  if (a.bulk && threadIdx.x == 0) {
    settle(sm, pend, pend_par, i);
    pend |= 1u << i;
    pend_par = (pend_par & ~(1u << i)) | (((phase >> i) & 1u) << i);
  }
  fill(a, sm, i, b, r, D);
  loaded |= 1u << i;
}

template <int KB, int NB>
__device__ __forceinline__ void consider(float (&bd)[NB], int (&bi)[NB], float* od, int* oi,
                                         float& kth, int k, float d, int g) {
  if (d < kth) {
    if (KB > 0) {
      insert_reg<NB>(bd, bi, d, g);
      kth = bd[NB - 1];
    } else {
      insert_mem(od, oi, kth, k, d, g);
    }
  }
}

// KB > 0: the k-buffer lives in registers (KB >= k slots). KB == 0: it lives
// in the thread's output row. DC > 0: D == DC, the query in registers and
// the leaf boxes in the window (built for DC = 3, the main path's D). DC ==
// 0: any D, query and boxes read from device memory. (ptxas 12.9 crashes on
// some instantiations that hold a runtime D <= 8 in a guarded register
// array, so other D take the DC = 0 kernel.)
template <int KB, int DC>
__global__ void __launch_bounds__(kMaxThreads) scan_knn_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  // per warp, double-buffered by stage parity: bit 0 = the warp needs the
  // bucket kStages ahead, bit 1 = the warp may stop before the next position
  __shared__ uint32_t wflag[2][kMaxWarps];

  const int D = DC > 0 ? DC : a.D;
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool active = tid < a.TQ;
  const long long row = static_cast<long long>(t) * a.TQ + (active ? tid : 0);
  const float* qrow = a.tq + row * D;
  const long long orow = (static_cast<long long>(t) * a.S + s) * a.TQ + (active ? tid : 0);
  float* od = a.out_d + orow * a.k;
  int* oi = a.out_i + orow * a.k;
  int* qw = a.q_worst == nullptr ? nullptr : a.q_worst + row;
  const int k = a.k;
  const int B = a.B;
  const int rows = a.rows;

  Smem sm;
  sm.pts = reinterpret_cast<float*>(smem_raw);
  sm.gid = reinterpret_cast<int*>(sm.pts + kStages * rows * D);
  sm.cand = sm.gid + kStages * rows;
  sm.lb = reinterpret_cast<float*>(sm.cand + kWinSlots);
  sm.box = sm.lb + kWinSlots;
  sm.bar = full_bar;

  constexpr int NQ = DC > 0 ? DC : 1;
  float qv[NQ];
#pragma unroll
  for (int d = 0; d < NQ; ++d) qv[d] = (DC > 0 && active) ? qrow[d] : 0.f;

  constexpr int NB = KB > 0 ? KB : 1;
  float bd[NB];
  int bi[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    bd[j] = j < NB - k ? -INFINITY : INFINITY;  // see insert_reg
    bi[j] = -1;
  }
  if (KB == 0 && active) {
    for (int j = 0; j < k; ++j) {
      od[j] = INFINITY;
      oi[j] = -1;
    }
  }
  // inactive lanes hold -inf: they never insert and never hold a walk back
  float kth = active ? INFINITY : -INFINITY;
  float gq = INFINITY;  // this lane's latest view of q_worst
  int gq_next = kInfBits;

  const int* tcand = a.cand + static_cast<long long>(t) * a.C;
  const float* tlb = a.lb + static_cast<long long>(t) * a.C;
  const int c0 = s * a.chunk;
  const int c1 = min(c0 + a.chunk, a.C);
  const int R = (B + rows - 1) / rows;  // row chunks per bucket
  const int U = max(c1 - c0, 0) * R;    // stages this chunk walks at most

  // ---- prologue: barriers, first window, first kStages stages in flight
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) sm90::mbar_init(&full_bar[i], 1);
    sm90::fence_mbar_init();
  }
  if (tid < kMaxWarps) {
    wflag[0][tid] = 1u;
    wflag[1][tid] = 1u;
  }
  win_load<DC>(a, sm, tcand, tlb, c0, c1, D);
  int wbase = c0;
  __syncthreads();

  uint32_t loaded = 0;  // stage i holds an issued, unconsumed fill
  uint32_t phase = 0;   // parity of each stage's next fill
  uint32_t pend = 0, pend_par = 0;  // see settle()
  int pa = c0, ra = 0;  // position and row chunk of the next stage to issue
  for (int i = 0; i < kStages; ++i) {
    if (i < U && sm.cand[pa - wbase] >= 0) {
      issue(a, sm, i, sm.cand[pa - wbase], ra, D, phase, loaded, pend, pend_par);
    }
    if (!a.bulk) sm90::cp_async_commit();
    if (++ra == R) {
      ra = 0;
      ++pa;
    }
  }
  if (!a.bulk) sm90::cp_async_wait<kStages - 1>();
  __syncthreads();

  // ---- the walk, one stage at a time
  int p = c0, r = 0, par = 0, nvis = 0, b = -1;
  bool warp_need = false;
  for (int u = 0; u < U; ++u) {
    const int st = u & (kStages - 1);
    if (r == 0) {
      if (p != c0 && (p - c0) % kWindow == 0) {
        __syncthreads();  // every reader of the old window is done
        win_load<DC>(a, sm, tcand, tlb, p, c1, D);
        wbase = p;
        __syncthreads();
      }
      bool stop = true;
      for (int w = 0; w < nwarps; ++w) stop = stop && ((wflag[par][w] >> 1) & 1u);
      if (stop) break;
      b = sm.cand[p - wbase];
      warp_need = false;
      if (b >= 0) {
        if (tid == 0) ++nvis;
        if (qw != nullptr && (p - c0) % kWorstEvery == 0) {
          gq_next = active ? sm90::ld_relaxed(qw) : kInfBits;
        }
        warp_need = __any_sync(
            kFull, lane_needs<DC>(a, sm, p - wbase, b, qv, qrow, D, active, kth, gq));
      }
    }
    if (b >= 0 && ((loaded >> st) & 1u)) {
      if (warp_need) {
        if (a.bulk) {
          sm90::mbar_wait(&full_bar[st], (phase >> st) & 1u);
          if (tid == 0) pend &= ~(1u << st);
        }
        const float* sp = sm.pts + st * rows * D;
        const int* sg = sm.gid + st * rows;
        const int n = min(rows, B - r * rows);
        int j = 0;
        if (DC == 3 && (rows & 3) == 0) {
          const float4* s4 = reinterpret_cast<const float4*>(sp);
          for (; j + 4 <= n; j += 4) {
            const float4 x = s4[(j >> 2) * 3];
            const float4 y = s4[(j >> 2) * 3 + 1];
            const float4 z = s4[(j >> 2) * 3 + 2];
            const float e0 = d2_3(qv, x.x, x.y, x.z);
            const float e1 = d2_3(qv, x.w, y.x, y.y);
            const float e2 = d2_3(qv, y.z, y.w, z.x);
            const float e3 = d2_3(qv, z.y, z.z, z.w);
            if (fminf(fminf(e0, e1), fminf(e2, e3)) < kth) {
              consider<KB>(bd, bi, od, oi, kth, k, e0, sg[j]);
              consider<KB>(bd, bi, od, oi, kth, k, e1, sg[j + 1]);
              consider<KB>(bd, bi, od, oi, kth, k, e2, sg[j + 2]);
              consider<KB>(bd, bi, od, oi, kth, k, e3, sg[j + 3]);
            }
          }
        }
        for (; j + 4 <= n; j += 4) {
          const float e0 = point_d2<DC>(sp + j * D, qv, qrow, D);
          const float e1 = point_d2<DC>(sp + (j + 1) * D, qv, qrow, D);
          const float e2 = point_d2<DC>(sp + (j + 2) * D, qv, qrow, D);
          const float e3 = point_d2<DC>(sp + (j + 3) * D, qv, qrow, D);
          if (fminf(fminf(e0, e1), fminf(e2, e3)) < kth) {
            consider<KB>(bd, bi, od, oi, kth, k, e0, sg[j]);
            consider<KB>(bd, bi, od, oi, kth, k, e1, sg[j + 1]);
            consider<KB>(bd, bi, od, oi, kth, k, e2, sg[j + 2]);
            consider<KB>(bd, bi, od, oi, kth, k, e3, sg[j + 3]);
          }
        }
        for (; j < n; ++j) {
          consider<KB>(bd, bi, od, oi, kth, k, point_d2<DC>(sp + j * D, qv, qrow, D), sg[j]);
        }
      }
      phase ^= 1u << st;
    }

    // flags for the stage kStages ahead and for the next position
    const bool last_r = r == R - 1;
    if (last_r && qw != nullptr) {
      gq = fminf(gq, __int_as_float(gq_next));
      if (active && kth < gq) {
        atomicMin(qw, __float_as_int(kth));
        gq = kth;
      }
    }
    uint32_t flag = 0;
    if (u + kStages < U) {
      const int bn = sm.cand[pa - wbase];
      if (bn >= 0 && __any_sync(kFull, lane_needs<DC>(a, sm, pa - wbase, bn, qv, qrow, D,
                                                            active, kth, gq))) {
        flag |= 1u;
      }
    }
    if (last_r && p + 1 < c1) {
      const float l = sm.lb[p + 1 - wbase];
      const bool ok = !(l < kth) || l > gq;  // inactive lanes: kth = -inf
      if (__all_sync(kFull, ok)) flag |= 2u;
    }
    if (lane == 0) wflag[par ^ 1][warp] = flag;
    if (!a.bulk) sm90::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st is free; the flags are visible

    loaded &= ~(1u << st);
    if (u + kStages < U) {
      bool any = false;
      for (int w = 0; w < nwarps; ++w) any = any || (wflag[par ^ 1][w] & 1u);
      const int bn = sm.cand[pa - wbase];
      if (any && bn >= 0) issue(a, sm, st, bn, ra, D, phase, loaded, pend, pend_par);
    }
    if (!a.bulk) sm90::cp_async_commit();
    if (++ra == R) {
      ra = 0;
      ++pa;
    }
    par ^= 1;
    if (++r == R) {
      r = 0;
      ++p;
    }
  }

  // no copy may land in shared memory after the block has left
  if (a.bulk) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) settle(sm, pend, pend_par, i);
    }
  } else {
    sm90::cp_async_wait_all();
  }
  if (KB > 0 && active) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j >= NB - k) {
        od[j - (NB - k)] = bd[j];
        oi[j - (NB - k)] = bi[j];
      }
    }
  }
  if (a.visited != nullptr && tid == 0 && nvis > 0) atomicAdd(a.visited + t, nvis);
}

// ---- the merge: one block per (tile, query) row ----
//
// The k smallest entries of the row's S partial buffers by (d2, chunk, rank
// in chunk), which is the order of one walk over the whole list. Each entry
// is one 64-bit key, (float bits of d2) << 32 | (s k + e): d2 >= 0 (or +inf),
// so its bits order as unsigned ints, the position part breaks ties as the
// stable sort does, and the keys of a row are distinct. Within a chunk the
// keys ascend (its buffer is ascending), so a walk that passes a bound stops.
//
// 1. Threshold. w = the least k-th entry over the chunks. The chunk that holds
//    it has k entries <= w, so the row's k-th smallest d2 is <= w and no entry
//    with d2 > w can be in the answer; an entry equal to w can (the position
//    breaks the tie), so it is kept. If no chunk is full, w = +inf and the
//    candidates are the finite entries; an unfilled slot of a partial buffer
//    is (+inf, -1), and the answer's unfilled slots are (+inf, -1) too.
// 2. Survivors. The block's threads walk the chunks (chunk s by thread
//    s mod blockDim), each ascending until its key passes the bound, and
//    append the keys to shared memory through a block counter, one atomic
//    per warp and step. Chunks that stopped early on the shared bound hold
//    +inf beyond their first entries, so few keys survive.
// 3. Select. The rank of each survivor among the others (a thread a key,
//    when they are no more than the threads), else a bitonic sort of them
//    in shared memory; ranks below k are the answer. The ids are read back
//    from the winners' positions.
// 4. Exact overflow. When more keys survive than shared memory holds (cap),
//    a radix select over the keys, 8 bits a pass from the top, each pass a
//    walk bounded by the digits fixed so far, finds the key of rank
//    min(k, cap); the keys up to it are collected and sorted. For k > cap
//    the answer is taken in slabs of cap keys, each above the last.
//
// What bounds it: the loads. Pass 1 reads one word of every chunk (S
// scattered words a row), pass 2 a chunk's entries up to the bound, mostly
// one. The bound counts what the data needs: the S k-th words, the
// survivors' d2, the winners' ids and the answer, over the device memory
// rate; reading every partial buffer once would be far more.
// The blocks are one per row, of the chunks' count in threads (a power of
// two, 32..1,024), halved while the rows' threads would not all fit on the
// card at once: the 7-row serve shape (8 rows, S = 1,024) runs 8 blocks of
// 1,024 threads, the 1,000-row one (1,024 rows, S = 512) 1,024 blocks of
// 256.
constexpr int kMergeMaxThreads = 1024;
constexpr unsigned kInfU = 0x7f800000u;

struct MergeSmem {
  unsigned long long* keys;  // [cap rounded up to a power of two]
  unsigned* hist;            // [256]
  unsigned* word;            // [4]: w bits, counter, digit, rank
};

__device__ __forceinline__ unsigned long long merge_key(float v, unsigned pos) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) | pos;
}

// The walk over the row's entries: chunk s by thread s mod blockDim, each
// chunk ascending until its key passes hi. The lanes of a warp step
// together, so f(key, ok) is called by the whole warp at each step, ok for
// a lane whose entry lies in [lo, hi]; a warp stops when all its chunks
// have. Every thread calls it.
template <typename F>
__device__ __forceinline__ void merge_walk(const float* rd, long long cstride, int S, int k,
                                           unsigned long long lo, unsigned long long hi, F f) {
  for (int s0 = 0; s0 < S; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const float* c = rd + s * cstride;  // read only while s < S
    const unsigned base = static_cast<unsigned>(s) * static_cast<unsigned>(k);
    bool alive = s < S;
    for (int e = 0; e < k; ++e) {
      unsigned long long key = 0;
      if (alive) {
        key = merge_key(c[e], base + static_cast<unsigned>(e));
        alive = key <= hi;
      }
      if (!__any_sync(kFull, alive)) break;
      f(key, alive && key >= lo);
    }
  }
}

// The keys with lo <= key <= hi into sm.keys (the first cap of them), one
// counter atomic per warp and step; returns how many there are. Every
// thread calls it.
__device__ __forceinline__ unsigned merge_collect(const MergeSmem& sm, const float* rd,
                                                  long long cstride, int S, int k, int cap,
                                                  unsigned long long lo, unsigned long long hi) {
  const unsigned lane = threadIdx.x & 31;
  if (threadIdx.x == 0) sm.word[1] = 0;
  __syncthreads();
  merge_walk(rd, cstride, S, k, lo, hi, [&](unsigned long long key, bool ok) {
    const unsigned m = __ballot_sync(kFull, ok);
    if (m == 0) return;
    const int lead = __ffs(m) - 1;
    unsigned i = 0;
    if (lane == static_cast<unsigned>(lead)) i = atomicAdd(&sm.word[1], __popc(m));
    i = __shfl_sync(kFull, i, lead) + __popc(m & ((1u << lane) - 1));
    if (ok && i < static_cast<unsigned>(cap)) sm.keys[i] = key;
  });
  __syncthreads();
  return sm.word[1];
}

// The key of rank r (1-based) among the keys in [lo, hi] (r <= their count).
__device__ unsigned long long merge_radix_select(const MergeSmem& sm, const float* rd,
                                                 long long cstride, int S, int k,
                                                 unsigned long long lo, unsigned long long hi,
                                                 unsigned r) {
  const int tid = threadIdx.x;
  unsigned long long prefix = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    // the keys whose bits above shift + 8 equal the prefix's
    const unsigned long long below = shift == 56 ? ~0ull : (1ull << (shift + 8)) - 1;
    const unsigned long long plo = max(lo, prefix & ~below);
    const unsigned long long phi = min(hi, prefix | below);
    for (int i = tid; i < 256; i += blockDim.x) sm.hist[i] = 0;
    __syncthreads();
    merge_walk(rd, cstride, S, k, plo, phi, [&](unsigned long long key, bool ok) {
      if (ok) atomicAdd(&sm.hist[(key >> shift) & 255u], 1u);
    });
    __syncthreads();
    if (tid < 32) {  // warp 0: the digit where the running count reaches r
      unsigned part[8];
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        part[j] = sm.hist[tid * 8 + j];
        sum += part[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, incl, off);
        if (tid >= off) incl += o;
      }
      const unsigned hit = __ballot_sync(kFull, incl >= r);
      if (tid == __ffs(hit) - 1) {
        unsigned cum = incl - sum;
        int j = 0;
        while (j < 7 && cum + part[j] < r) cum += part[j++];
        sm.word[2] = static_cast<unsigned>(tid * 8 + j);
        sm.word[3] = r - cum;
      }
    }
    __syncthreads();
    prefix |= static_cast<unsigned long long>(sm.word[2]) << shift;
    r = sm.word[3];
  }
  return prefix;
}

// Ascending bitonic sort of sm.keys[0, n), padded to a power of two.
__device__ __forceinline__ void merge_sort(const MergeSmem& sm, unsigned n) {
  unsigned P = 1;
  while (P < n) P <<= 1;
  for (unsigned i = n + threadIdx.x; i < P; i += blockDim.x) sm.keys[i] = ~0ull;
  __syncthreads();
  for (unsigned size = 2; size <= P; size <<= 1) {
    for (unsigned stride = size >> 1; stride > 0; stride >>= 1) {
      for (unsigned i = threadIdx.x; i < P / 2; i += blockDim.x) {
        const unsigned a = 2 * i - (i & (stride - 1));
        const unsigned b = a + stride;
        const unsigned long long x = sm.keys[a];
        const unsigned long long y = sm.keys[b];
        if ((x > y) == ((a & size) == 0)) {
          sm.keys[a] = y;
          sm.keys[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMergeMaxThreads)
    scan_knn_merge_kernel(const float* __restrict__ pd, const int* __restrict__ pi,
                          float* __restrict__ out_d, int* __restrict__ out_i, int S, int TQ,
                          int k, int cap) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  __shared__ unsigned hist[256];
  __shared__ unsigned word[4];
  MergeSmem sm;
  sm.keys = reinterpret_cast<unsigned long long*>(merge_smem);
  sm.hist = hist;
  sm.word = word;

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long t = row / TQ;
  const long long q = row - t * TQ;
  const long long cstride = static_cast<long long>(TQ) * k;  // chunk s+1 minus chunk s
  const float* rd = pd + (t * S * TQ + q) * k;
  const int* ri = pi + (t * S * TQ + q) * k;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;

  // 1. the threshold w: the least k-th entry
  if (tid == 0) word[0] = kInfU;
  __syncthreads();
  unsigned m = kInfU;
  for (int s = tid; s < S; s += blockDim.x) m = min(m, __float_as_uint(rd[s * cstride + k - 1]));
  m = __reduce_min_sync(kFull, m);
  if ((tid & 31) == 0) atomicMin(&word[0], m);
  __syncthreads();
  const unsigned wb = word[0];
  const unsigned long long hi = wb < kInfU ? (static_cast<unsigned long long>(wb) << 32) | 0xffffffffull
                                           : (static_cast<unsigned long long>(kInfU) << 32) - 1;

  // 2-4. survivors, select; slabs of at most cap keys while k > cap
  int done = 0;
  unsigned long long lo = 0;
  while (done < k) {
    unsigned n = merge_collect(sm, rd, cstride, S, k, cap, lo, hi);
    const bool over = n > static_cast<unsigned>(cap);
    unsigned long long top = hi;
    if (over) {
      const unsigned want = static_cast<unsigned>(min(k - done, cap));
      top = merge_radix_select(sm, rd, cstride, S, k, lo, hi, want);
      n = merge_collect(sm, rd, cstride, S, k, cap, lo, top);  // exactly want keys
    }
    if (n == 0) break;
    const unsigned take = min(n, static_cast<unsigned>(k - done));
    // slot j of the slab gets the key of rank j: the d2 from its bits, the
    // id read back from its position
    auto put = [&](unsigned j, unsigned long long key) {
      const unsigned pos = static_cast<unsigned>(key);
      const unsigned s = pos / static_cast<unsigned>(k);
      const unsigned e = pos - s * static_cast<unsigned>(k);
      od[done + j] = __uint_as_float(static_cast<unsigned>(key >> 32));
      oi[done + j] = ri[s * cstride + e];
    };
    if (n <= blockDim.x) {
      // a key a thread: its rank is the count of smaller keys (the keys
      // are distinct), read as one broadcast per key, with no barrier
      if (static_cast<unsigned>(tid) < n) {
        const unsigned long long key = sm.keys[tid];
        unsigned r = 0;
        for (unsigned j = 0; j < n; ++j) r += sm.keys[j] < key;
        if (r < take) put(r, key);
      }
    } else {
      merge_sort(sm, n);
      for (unsigned j = tid; j < take; j += blockDim.x) put(j, sm.keys[j]);
    }
    done += static_cast<int>(take);
    __syncthreads();  // the keys are read before the next slab rewrites them
    if (!over) break;  // every candidate was taken, or k reached
    lo = top + 1;
  }
  for (int j = done + tid; j < k; j += blockDim.x) {
    od[j] = INFINITY;
    oi[j] = -1;
  }
}

template <int KB, int DC>
int launch_scan(const ScanArgs& a, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_knn_kernel<KB, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scan_knn_kernel<KB, DC><<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DC>
int launch_scan_dc(const ScanArgs& a, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream) {
  const int k = a.k;
  if (k <= 1) return launch_scan<1, DC>(a, grid, threads, smem, stream);
  if (k <= 2) return launch_scan<2, DC>(a, grid, threads, smem, stream);
  if (k <= 4) return launch_scan<4, DC>(a, grid, threads, smem, stream);
  if (k <= 8) return launch_scan<8, DC>(a, grid, threads, smem, stream);
  if (k <= 16) return launch_scan<16, DC>(a, grid, threads, smem, stream);
  if (k <= 32) return launch_scan<32, DC>(a, grid, threads, smem, stream);
  return launch_scan<0, 0>(a, grid, threads, smem, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// The threads of a merge block before the card's limit halves them: the
// chunks, rounded up to a power of two, 32..1,024.
int merge_threads(int S) {
  int threads = 32;
  while (threads < S && threads < kMergeMaxThreads) threads <<= 1;
  return threads;
}

}  // namespace

// tq f32[T, TQ, D], cand i32[T, C], lb f32[T, C], pts f32[NBP, B, D],
// gid i32[NBP, B], node_lo/node_hi f32[2 NBP - 1, D] -> out_d f32[T, S, TQ, k],
// out_i i32[T, S, TQ, k]: chunk s's ascending partial buffers (the answer
// itself when S == 1). visited i32[T] (may be null, zeroed by the caller)
// gets each tile's count of candidate buckets reached before its chunks
// stopped. q_worst i32[T, TQ] (+inf bits, null when S == 1) is the
// chunks' shared bound. Every pointer is device memory, contiguous.
// 1 <= TQ <= 256, k >= 1, 1 <= S <= 65535, (D + 1) * 4 <= 48 KB, and every
// cand entry is -1 or a bucket < NBP. Returns the CUDA error of the launch
// (0 = cudaSuccess).
extern "C" int scan_knn_launch(const void* tq, const void* cand, const void* lb,
                               const void* pts, const void* gid, const void* node_lo,
                               const void* node_hi, void* out_d, void* out_i, void* visited,
                               void* q_worst, int T, int TQ, int D, int C, int B, int k,
                               int S, int nbp, void* stream) {
  if (T <= 0) return 0;
  ScanArgs a;
  a.tq = static_cast<const float*>(tq);
  a.cand = static_cast<const int*>(cand);
  a.lb = static_cast<const float*>(lb);
  a.pts = static_cast<const float*>(pts);
  a.gid = static_cast<const int*>(gid);
  a.node_lo = static_cast<const float*>(node_lo);
  a.node_hi = static_cast<const float*>(node_hi);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.visited = static_cast<int*>(visited);
  a.q_worst = static_cast<int*>(q_worst);
  a.TQ = TQ;
  a.D = D;
  a.C = C;
  a.B = B;
  a.k = k;
  a.S = S;
  a.chunk = C > 0 ? (C + S - 1) / S : 0;
  a.nbp = nbp;
  int rows = kStageBytes / ((D + 1) * 4);
  if (rows > B) rows = B;
  if (rows >= 4 && rows < B) rows &= ~3;
  if (rows < 1) rows = 1;
  a.rows = rows;
  a.bulk = (B % 4 == 0) && (rows % 4 == 0) && aligned16(pts) && aligned16(gid);
  // k > 32 keeps its buffer in device memory and takes the DC = 0 kernel
  const int dc = (k <= 32 && D == 3) ? 3 : 0;
  size_t smem = static_cast<size_t>(kStages) * rows * (D + 1) * 4 + kWinSlots * 8;
  if (dc > 0) smem += static_cast<size_t>(kWinSlots) * 2 * D * 4;
  const int threads = ((TQ + 31) / 32) * 32;
  const dim3 grid(T, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dc == 3) return launch_scan_dc<3>(a, grid, threads, smem, st);
  return launch_scan_dc<0>(a, grid, threads, smem, st);
}

// The merge's shared capacity in keys for S chunks: 4 a thread of the
// unhalved block, at least 1,024. More survivors take the radix select,
// and k above it the slabs.
extern "C" int scan_knn_merge_capacity(int S) { return max(1024, 4 * merge_threads(S)); }

// pd f32[T, S, TQ, k], pi i32[T, S, TQ, k] ascending partials ->
// out_d f32[T, TQ, k], out_i i32[T, TQ, k]. S k <= 2^32 (the keys' position
// part), T TQ < 2^31 (one block per row). Returns the launch's CUDA error.
extern "C" int scan_knn_merge_launch(const void* pd, const void* pi, void* out_d, void* out_i,
                                     int T, int S, int TQ, int k, void* stream) {
  const long long rows = static_cast<long long>(T) * TQ;
  if (rows <= 0) return 0;
  // halved while the grid's threads exceed what the card holds at once
  int threads = merge_threads(S);
  const int cap = scan_knn_merge_capacity(S);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  while (threads > 32 && rows * threads > static_cast<long long>(sms) * per_sm) threads >>= 1;
  size_t keys = 1;
  while (keys < static_cast<size_t>(cap)) keys <<= 1;
  const size_t smem = keys * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(scan_knn_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scan_knn_merge_kernel<<<static_cast<unsigned>(rows), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pd), static_cast<const int*>(pi), static_cast<float*>(out_d),
      static_cast<int*>(out_i), S, TQ, k, cap);
  return static_cast<int>(cudaGetLastError());
}
