// The query verbs' folds: radius and box containment over each query tile's
// candidate buckets, with exact per-query hit counts and an m-slot buffer.
//
// Replaces no TPU kernel: the JAX package runs these folds as fused XLA
// programs, the lax.scan over candidate chunks of
// kdtree_tpu/verbs/device.py::_radius_tiles (:172) and ::_range_tiles (:219).
// Their plain PyTorch versions are kdtree_tpu_torch/kernels/verb_fold.py::
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
// What bounds it. A tile's candidates are pruned by the union box of its
// queries, so most (query, bucket) pairs of a tile cannot hold a hit: at the
// verbs' 3-D serving shapes a query meets a handful of its tile's thousands
// of leaf boxes. What the inputs need is then one box test per (query,
// candidate), the candidates' ids and boxes, and the bytes of the buckets
// some query's box test passes: latency and launch, tens of microseconds.
// At wide D (47 axes) the leaf boxes span most axes and most pairs survive,
// and the FP32 pipe (a subtract, a multiply and an add an axis per radius
// pair, two compares per box axis) bounds it.
//
// Design for Hopper:
// 1. Grid (tile, chunk): block s takes a contiguous range of the tile's
//    candidate positions, so a request of one tile spreads over the SMs (the
//    caller sizes the chunks: at D = 3 as the scan kernel's split, at other
//    D 8 positions, each a bucket of work, so the blocks come out even).
// 2. Phase A, the cull. The range's ids (and at D = 3 the leaf boxes) come
//    in windows; lanes run over queries, each (candidate, query) tested by
//    box_bound's arithmetic (radius: the bound is never above the d2 of a
//    point inside the box, so bound > r2 skips exactly) or by disjointness
//    (range; every compare written !(x > y), so a NaN face never skips).
//    One ballot per 32 queries gives each candidate a TQ-bit mask; the
//    candidates whose mask is empty drop out, the rest are compacted in
//    candidate order into a shared list of (bucket, mask). An empty leaf
//    (lo = +inf > hi = -inf) never enters it.
// 3. Phase B, the survivors only. Each listed bucket streams through a ring
//    of stages as two 1-D bulk copies (cp.async.bulk on the stage's
//    mbarrier), the ring's depth ahead of the test (4 stages at D = 3; at
//    other D 2, or 1 where a second would keep a second block off the SM,
//    whose warps then hide the copy); rows that are not 16-byte multiples
//    take 4-byte cp.async. The block's threads take the
//    bucket's points and loop over the set bits of its mask, the same loop
//    for every thread, so nothing diverges. A warp's hits for one query are
//    counted with one ballot and one atomicAdd, which also hands out their
//    slots; the count form adds into shared counters flushed once a block.
//    A list longer than its capacity is folded in rounds.
// 4. Register blocking. At D = 3 a thread holds its 4 points in registers
//    and reads each query as one 128-bit broadcast. At other D the queries
//    are staged once per launch as windows of 32 positions, window_sum's
//    windows above 32 axes, each holding its axes from position 0 and zeros
//    after (a zero changes no sum and fails no compare); a thread holds its
//    point's windows in registers (two at most; wider points reload a window
//    at a time) and reads each query 128 bits at a time. A held window
//    tests a compile-time number of 4-position chunks straight through, so
//    no branch and no early exit sits in the pair loop. No tensor cores: the
//    contract is the FMA chain's bits (or window_sum's), which a
//    tensor-core product does not give, and the box test has no product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "d2.cuh"
#include "sm90_async.cuh"

namespace {

using namespace kdt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTQ = 256;              // queries per tile (the shared counters)
constexpr int kPPT = 4;                  // points a thread at D = 3
constexpr int kRows3 = kPPT * kThreads;  // a stage's rows at D = 3
constexpr int kStageBytes = 48 * 1024;   // a stage's budget at other D
constexpr int kQueryBytes = 96 * 1024;   // staged queries a launch at most
constexpr int kWindow = 256;             // candidate positions culled at once (<= kThreads)
constexpr int kListMax = 512;            // survivors listed before they are folded
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 227 * 1024 - 2048;  // dynamic shared memory, the static part aside
constexpr unsigned kFull = 0xffffffffu;

struct FoldArgs {
  const float* qa;       // radius: tq [T, TQ, D]; range: lo [T, TQ, D]
  const float* qb;       // radius: r2 [T, TQ]; range: hi [T, TQ, D]
  const int* cand;       // [T, C]
  const float* pts;      // [NBP, B, D]
  const int* gid;        // [NBP, B]
  const float* node_lo;  // [2 NBP - 1, D]; the leaf of bucket b is NBP - 1 + b
  const float* node_hi;
  int* counts;           // [T, TQ], zeroed by the caller
  float* out_d;          // [T, TQ, m], +inf filled, or null (range; m == 0)
  int* out_i;            // [T, TQ, m], -1 filled, or null (m == 0)
  int TQ, q0, nq;        // this launch folds queries [q0, q0 + nq) of each tile
  int D, C, B, m, chunk, nbp;
  int nwin;              // DC == 0: a staged query row's windows of 32 positions
  int off;               // DC == 0: the position of axis 0 (window_sum's front padding)
  int f2;                // DC == 0: window_sum's second-level front padding
  int QS;                // DC == 0: floats between staged query rows (32 nwin + 4)
  int rows, parts, nst, bulk;  // a stage's rows, stages a bucket, ring depth, bulk copies
  int win, lcap;         // cull window positions; survivor list capacity
  // byte offsets into dynamic shared memory (the stages' points start at 0)
  int o_gid, o_q, o_r2, o_lid, o_lmask, o_sid, o_smask, o_box;
};

// One warp's hits for query q (row `row`): one atomicAdd per warp counts
// them (shared counters in the count form) and hands out their slots.
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

// ---- the staged-window arithmetic (DC == 0)
//
// A staged row has nwin windows of 32 positions. Window 0 holds axes
// [0, 32 - off), window w > 0 axes [32 w - off, 32 w - off + 32), each from
// its position 0 and zeros after: for a radius above 32 axes these are
// window_sum's windows (off its front padding), so every window is a prefix
// of whole 4-position chunks.

// The axis at position pos, or -1.
__device__ __forceinline__ int axis_at(const FoldArgs& a, int pos) {
  const int w = pos >> 5, i = pos & 31;
  const int first = w == 0 ? 0 : 32 * w - a.off;
  const int n = min(w == 0 ? 32 - a.off : 32, a.D - first);
  return i < n ? first + i : -1;
}

// The 4-position chunks of window w that hold an axis.
__device__ __forceinline__ int span(const FoldArgs& a, int w) {
  const int first = w == 0 ? 0 : 32 * w - a.off;
  return (min(w == 0 ? 32 - a.off : 32, a.D - first) + 3) >> 2;
}

// Whether window w closes a group of 32 window sums (window_sum's second
// level, above 1,024 axes).
__device__ __forceinline__ bool closes(const FoldArgs& a, int w) {
  return (((w + a.f2) & 31) == 31) || w == a.nwin - 1;
}

template <bool CHAIN>
__device__ __forceinline__ float acc_sq(float acc, float x) {
  return CHAIN ? __fmaf_rn(x, x, acc) : __fadd_rn(acc, __fmul_rn(x, x));
}

// Window w of the point row `prow` into registers (zero off the axes);
// `ok` false gives zeros.
__device__ __forceinline__ void load_window(float (&p)[32], const float* prow, const FoldArgs& a,
                                            int w, bool ok) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = axis_at(a, 32 * w + i);
    const float v = prow[max(d, 0)];
    p[i] = (ok && d >= 0) ? v : 0.f;
  }
}

// One window of a point's squared distance to the staged query window q4:
// its first CH chunks straight through (CH > 0; a zero position changes no
// sum), or its first `hi` chunks (CH == 0).
template <bool CHAIN, int CH>
__device__ __forceinline__ float win_d2(float acc, const float (&p)[32], const float4* q4,
                                        int hi) {
#pragma unroll
  for (int k = 0; k < (CH > 0 ? CH : 8); ++k) {
    if (CH > 0 || k < hi) {
      const float4 v = q4[k];
      acc = acc_sq<CHAIN>(acc, __fsub_rn(v.x, p[4 * k]));
      acc = acc_sq<CHAIN>(acc, __fsub_rn(v.y, p[4 * k + 1]));
      acc = acc_sq<CHAIN>(acc, __fsub_rn(v.z, p[4 * k + 2]));
      acc = acc_sq<CHAIN>(acc, __fsub_rn(v.w, p[4 * k + 3]));
    }
  }
  return acc;
}

// One window of the containment test against the staged box windows (CH
// as win_d2's: a zero position lies inside the zero faces staged there).
template <int CH>
__device__ __forceinline__ bool win_inside(const float (&p)[32], const float4* lo4,
                                           const float4* hi4, int hi) {
  bool ox = true, oy = true, oz = true, ow = true;  // four chains, not one
#pragma unroll
  for (int k = 0; k < (CH > 0 ? CH : 8); ++k) {
    if (CH > 0 || k < hi) {
      const float4 l = lo4[k];
      const float4 h = hi4[k];
      ox = ox & (p[4 * k] >= l.x) & (p[4 * k] <= h.x);
      oy = oy & (p[4 * k + 1] >= l.y) & (p[4 * k + 1] <= h.y);
      oz = oz & (p[4 * k + 2] >= l.z) & (p[4 * k + 2] <= h.z);
      ow = ow & (p[4 * k + 3] >= l.w) & (p[4 * k + 3] <= h.w);
    }
  }
  return ox & oy & oz & ow;
}

// The leaf box's coordinate at position pos (0 off the axes).
__device__ __forceinline__ float box_at(const float* row, const FoldArgs& a, int pos) {
  const int d = axis_at(a, pos);
  const float v = __ldg(row + max(d, 0));
  return d >= 0 ? v : 0.f;
}

// Phase A at DC == 0, radius: box_bound's arithmetic from the staged query
// row q4 to the leaf box (lo, hi) in device memory.
__device__ __forceinline__ float box_bound_g(const FoldArgs& a, const float4* q4,
                                             const float* lo, const float* hi) {
  const bool chain = a.D <= 32;  // the FMA chain (window sums above 32 axes)
  float s2 = 0.f, s3 = 0.f;
  for (int w = 0; w < a.nwin; ++w) {
    const int khi = span(a, w);
    float s1 = 0.f;
    for (int k = 0; k < khi; ++k) {
      const float4 v = q4[8 * w + k];
      const float qv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pos = 32 * w + 4 * k + c;
        const float g = box_gap(qv[c], box_at(lo, a, pos), box_at(hi, a, pos));
        s1 = chain ? __fmaf_rn(g, g, s1) : __fadd_rn(s1, __fmul_rn(g, g));
      }
    }
    if (chain) return s1;
    s2 = __fadd_rn(s2, s1);
    if (a.nwin > 32 && closes(a, w)) {
      s3 = __fadd_rn(s3, s2);
      s2 = 0.f;
    }
  }
  return a.nwin > 32 ? s3 : s2;
}

// Phase A at DC == 0, range: the query box (staged lo / hi rows) is not
// disjoint from the leaf box on any axis, and not inverted.
__device__ __forceinline__ bool box_meets_g(const FoldArgs& a, const float4* ql4,
                                            const float4* qh4, const float* lo,
                                            const float* hi) {
  bool ok = true;
  for (int w = 0; w < a.nwin; ++w) {
    const int khi = span(a, w);
    for (int k = 0; k < khi; ++k) {
      const float4 l4 = ql4[8 * w + k];
      const float4 h4 = qh4[8 * w + k];
      const float ql[4] = {l4.x, l4.y, l4.z, l4.w};
      const float qh[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pos = 32 * w + 4 * k + c;
        const float L = box_at(lo, a, pos), H = box_at(hi, a, pos);
        ok = ok & !(L > qh[c]) & !(H < ql[c]) & !(ql[c] > qh[c]);
      }
    }
  }
  return ok;
}

// Phase A at D = 3 (the leaf box staged as two float4s).
__device__ __forceinline__ float box_bound3(float4 q, float4 lo, float4 hi) {
  float g = box_gap(q.x, lo.x, hi.x);
  float acc = __fmaf_rn(g, g, 0.f);
  g = box_gap(q.y, lo.y, hi.y);
  acc = __fmaf_rn(g, g, acc);
  g = box_gap(q.z, lo.z, hi.z);
  return __fmaf_rn(g, g, acc);
}

__device__ __forceinline__ bool box_meets3(float4 ql, float4 qh, float4 lo, float4 hi) {
  return !(lo.x > qh.x) & !(hi.x < ql.x) & !(ql.x > qh.x) & !(lo.y > qh.y) & !(hi.y < ql.y) &
         !(ql.y > qh.y) & !(lo.z > qh.z) & !(hi.z < ql.z) & !(ql.z > qh.z);
}

// ---- phase B

struct Smem {
  float* sp;         // [nst][rows * D]
  int* sg;           // [nst][rows]
  float* sq;         // the staged queries
  float* sr2;        // [nq] (radius, DC == 0)
  int* lid;          // [lcap] listed buckets
  unsigned* lmask;   // [lcap][ng] their query masks
  int* sid;          // [win] the window's buckets (-1: none, or an empty leaf)
  unsigned* smask;   // [win][ng]
  float4* box;       // [win][2] (DC == 3)
  uint64_t* bar;     // [kMaxStages]
};

// Start filling stage st with unit u (listed bucket u / parts, row part
// u % parts).
__device__ __forceinline__ void issue(const FoldArgs& a, const Smem& sm, int st, int u, int D) {
  const int i = u / a.parts;
  const int r = u - i * a.parts;
  const int n = min(a.rows, a.B - r * a.rows);
  const long long src =
      static_cast<long long>(sm.lid[i]) * a.B + static_cast<long long>(r) * a.rows;
  float* dst = sm.sp + static_cast<long long>(st) * a.rows * D;
  int* gdst = sm.sg + st * a.rows;
  if (a.bulk) {
    if (threadIdx.x == 0) {
      const uint32_t pb = static_cast<uint32_t>(n) * D * 4;
      const uint32_t gb = static_cast<uint32_t>(n) * 4;
      sm90::mbar_arrive_expect_tx(&sm.bar[st], pb + gb);
      sm90::bulk_copy_g2s(dst, a.pts + src * D, pb, &sm.bar[st]);
      sm90::bulk_copy_g2s(gdst, a.gid + src, gb, &sm.bar[st]);
    }
  } else {
    const float* s = a.pts + src * D;
    for (int e = threadIdx.x; e < n * D; e += blockDim.x) sm90::cp_async4(dst + e, s + e);
    for (int e = threadIdx.x; e < n; e += blockDim.x) sm90::cp_async4(gdst + e, a.gid + src + e);
    sm90::cp_async_commit();
  }
}

// The test of one staged unit (n rows at sp / sg) against the queries of
// its mask mk.
template <int DC, int NWR, int CH, bool RANGE>
__device__ __forceinline__ void fold_unit(const FoldArgs& a, const Smem& sm, int* scnt,
                                          long long row0, const float* sp, const int* sg,
                                          int n, const unsigned* mk, int ng, int D) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if constexpr (DC == 3) {
    const int ppt = (n + kThreads - 1) / kThreads;
    float px[kPPT], py[kPPT], pz[kPPT];
    int pg[kPPT];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
      const int j = tid + k * kThreads;
      const bool ok = k < ppt && j < n;
      pg[k] = ok ? sg[j] : -1;
      px[k] = ok ? sp[3 * j] : 0.f;
      py[k] = ok ? sp[3 * j + 1] : 0.f;
      pz[k] = ok ? sp[3 * j + 2] : 0.f;
    }
    const float4* q4 = reinterpret_cast<const float4*>(sm.sq);
    for (int w = 0; w < ng; ++w) {
      unsigned bits = mk[w];
      while (bits != 0) {
        const int q = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
        bool hit[kPPT];
        float d[kPPT];
        bool any = false;
        if (RANGE) {
          const float4 lo = q4[2 * q];
          const float4 hi = q4[2 * q + 1];
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            d[k] = 0.f;
            hit[k] = k < ppt && pg[k] >= 0 && px[k] >= lo.x && px[k] <= hi.x &&
                     py[k] >= lo.y && py[k] <= hi.y && pz[k] >= lo.z && pz[k] <= hi.z;
            any = any || hit[k];
          }
        } else {
          const float4 qq = q4[q];
          const float qv[3] = {qq.x, qq.y, qq.z};
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            d[k] = k < ppt ? d2_3(qv, px[k], py[k], pz[k]) : 0.f;
            hit[k] = k < ppt && pg[k] >= 0 && d[k] <= qq.w;
            any = any || hit[k];
          }
        }
        if (__any_sync(kFull, any)) {
#pragma unroll
          for (int k = 0; k < kPPT; ++k) {
            if (k < ppt) record<RANGE>(a, scnt, row0 + q, q, hit[k], d[k], pg[k], lane);
          }
        }
      }
    }
  } else {
    // one point a thread (rows <= kThreads), its windows in registers
    constexpr int NR = NWR > 0 ? NWR : 1;
    const bool ok = tid < n;
    const int g = ok ? sg[tid] : -1;
    const float* prow = sp + static_cast<long long>(min(tid, a.rows - 1)) * D;
    float pr[NR][32];
#pragma unroll
    for (int w = 0; w < NR; ++w) {
      if (NWR > 0) load_window(pr[w], prow, a, w, ok);
    }
    for (int wd = 0; wd < ng; ++wd) {
      unsigned bits = mk[wd];
      while (bits != 0) {
        const int q = (wd << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
        bool hit;
        float d = 0.f;
        if (RANGE) {
          const float4* lo4 = reinterpret_cast<const float4*>(sm.sq + q * a.QS);
          const float4* hi4 = reinterpret_cast<const float4*>(sm.sq + (a.nq + q) * a.QS);
          bool in = true;
          if (NWR > 0) {
#pragma unroll
            for (int w = 0; w < NR; ++w) {
              in = in & win_inside<CH>(pr[w], lo4 + 8 * w, hi4 + 8 * w, CH);
            }
          } else {
            for (int w = 0; w < a.nwin; ++w) {
              load_window(pr[0], prow, a, w, ok);
              in = in & win_inside<0>(pr[0], lo4 + 8 * w, hi4 + 8 * w, span(a, w));
            }
          }
          hit = g >= 0 && in;
        } else {
          const float4* q4 = reinterpret_cast<const float4*>(sm.sq + q * a.QS);
          if (NWR == 1) {
            d = win_d2<true, CH>(0.f, pr[0], q4, CH);  // D <= 32: the FMA chain
          } else if (NWR == 2) {
            // window_sum's 0 + s1a + s1b (0 + s1a is s1a)
            d = __fadd_rn(win_d2<false, CH>(0.f, pr[0], q4, CH),
                          win_d2<false, CH>(0.f, pr[NR - 1], q4 + 8, CH));
          } else {
            float s2 = 0.f, s3 = 0.f;
            for (int w = 0; w < a.nwin; ++w) {
              load_window(pr[0], prow, a, w, ok);
              s2 = __fadd_rn(s2, win_d2<false, 0>(0.f, pr[0], q4 + 8 * w, span(a, w)));
              if (a.nwin > 32 && closes(a, w)) {
                s3 = __fadd_rn(s3, s2);
                s2 = 0.f;
              }
            }
            d = a.nwin > 32 ? s3 : s2;
          }
          hit = g >= 0 && d <= sm.sr2[q];
        }
        if (__any_sync(kFull, hit)) record<RANGE>(a, scnt, row0 + q, q, hit, d, g, lane);
      }
    }
  }
}

// Phase B over the n listed buckets: the ring of stages, each unit tested
// against its bucket's mask. `ph` holds each stage's completion parity.
template <int DC, int NWR, int CH, bool RANGE>
__device__ __forceinline__ void fold_list(const FoldArgs& a, const Smem& sm, int* scnt,
                                          long long row0, int n, int ng, uint32_t& ph, int D) {
  const int U = n * a.parts;
  for (int u = 0; u < a.nst && u < U; ++u) issue(a, sm, u, u, D);
  for (int u = 0; u < U; ++u) {
    const int st = u % a.nst;
    if (a.bulk) {
      sm90::mbar_wait(&sm.bar[st], (ph >> st) & 1u);
      ph ^= 1u << st;
    } else {
      sm90::cp_async_wait_all();
      __syncthreads();
    }
    const int i = u / a.parts;
    const int r = u - i * a.parts;
    const int rows = min(a.rows, a.B - r * a.rows);
    fold_unit<DC, NWR, CH, RANGE>(a, sm, scnt, row0,
                                  sm.sp + static_cast<long long>(st) * a.rows * D,
                                  sm.sg + st * a.rows, rows, sm.lmask + i * ng, ng, D);
    __syncthreads();  // every reader of stage st is done before it refills
    if (u + a.nst < U) issue(a, sm, st, u + a.nst, D);
  }
}

// One block of either fold. DC == 3: D = 3, queries and leaf boxes as
// float4s. DC == 0: any D, the queries staged as windows of 32 positions;
// NWR windows of a point in registers, their first CH chunks tested (0:
// reloaded a window at a time, the chunks that hold an axis tested).
template <int DC, int NWR, int CH, bool RANGE>
__device__ __forceinline__ void fold_block(const FoldArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int scnt[kMaxTQ];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  __shared__ int wtot[kWarps];

  const int D = DC > 0 ? DC : a.D;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = a.nq;
  const int ng = (nq + 31) >> 5;
  const long long row0 = static_cast<long long>(t) * a.TQ + a.q0;

  Smem sm;
  sm.sp = reinterpret_cast<float*>(smem_raw);
  sm.sg = reinterpret_cast<int*>(smem_raw + a.o_gid);
  sm.sq = reinterpret_cast<float*>(smem_raw + a.o_q);
  sm.sr2 = reinterpret_cast<float*>(smem_raw + a.o_r2);
  sm.lid = reinterpret_cast<int*>(smem_raw + a.o_lid);
  sm.lmask = reinterpret_cast<unsigned*>(smem_raw + a.o_lmask);
  sm.sid = reinterpret_cast<int*>(smem_raw + a.o_sid);
  sm.smask = reinterpret_cast<unsigned*>(smem_raw + a.o_smask);
  sm.box = reinterpret_cast<float4*>(smem_raw + a.o_box);
  sm.bar = bars;

  // this launch's queries of the tile into shared memory
  if constexpr (DC == 3) {
    for (int e = tid; e < nq * 4; e += kThreads) {
      const int q = e >> 2, d = e & 3;
      if (RANGE) {
        sm.sq[q * 8 + d] = d < 3 ? a.qa[(row0 + q) * 3 + d] : 0.f;
        sm.sq[q * 8 + 4 + d] = d < 3 ? a.qb[(row0 + q) * 3 + d] : 0.f;
      } else {
        sm.sq[e] = d < 3 ? a.qa[(row0 + q) * 3 + d] : a.qb[row0 + q];
      }
    }
  } else {
    const int P = 32 * a.nwin;
    for (int e = tid; e < nq * P; e += kThreads) {
      const int q = e / P;
      const int pos = e - q * P;
      const int d = axis_at(a, pos);
      const bool on = d >= 0;
      const long long src = (row0 + q) * D + d;
      sm.sq[q * a.QS + pos] = on ? a.qa[src] : 0.f;
      if (RANGE) sm.sq[(nq + q) * a.QS + pos] = on ? a.qb[src] : 0.f;
    }
    if (!RANGE) {
      for (int e = tid; e < nq; e += kThreads) sm.sr2[e] = a.qb[row0 + e];
    }
  }
  for (int e = tid; e < nq; e += kThreads) scnt[e] = 0;
  if (a.bulk && tid == 0) {
    for (int i = 0; i < a.nst; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // phase A's lanes: warp w tests query group w % ng, every (kWarps / ng)-th
  // candidate of a window
  const int wpg = kWarps / ng;
  const bool aw = warp < wpg * ng;
  const int grp = warp % ng;
  const int qi = grp * 32 + lane;
  const bool qv = aw && qi < nq;
  float4 qA = make_float4(0.f, 0.f, 0.f, 0.f), qB = qA;
  if (DC == 3 && qv) {
    const float4* q4 = reinterpret_cast<const float4*>(sm.sq);
    qA = RANGE ? q4[2 * qi] : q4[qi];
    if (RANGE) qB = q4[2 * qi + 1];
  }

  const int* tcand = a.cand + static_cast<long long>(t) * a.C;
  const int c0 = blockIdx.y * a.chunk;
  const int c1 = min(c0 + a.chunk, a.C);
  uint32_t ph = 0;
  int n = 0;
  for (int p0 = c0; p0 < c1; p0 += a.win) {
    const int nw = min(a.win, c1 - p0);
    // the window's ids (and at D = 3 leaf boxes); an empty leaf drops out
    if (tid < nw) {
      int b = tcand[p0 + tid];
      if (b >= 0) {
        const long long leaf = static_cast<long long>(a.nbp) - 1 + b;
        const float* lo = a.node_lo + leaf * D;
        const float* hi = a.node_hi + leaf * D;
        if (lo[0] > hi[0]) {
          b = -1;
        } else if (DC == 3) {
          sm.box[2 * tid] = make_float4(lo[0], lo[1], lo[2], 0.f);
          sm.box[2 * tid + 1] = make_float4(hi[0], hi[1], hi[2], 0.f);
        }
      }
      sm.sid[tid] = b;
    }
    __syncthreads();
    // the cull: one ballot per (candidate, 32 queries)
    if (aw) {
      for (int e = warp / ng; e < nw; e += wpg) {
        const int b = sm.sid[e];
        bool pass = false;
        if (b >= 0 && qv) {
          if constexpr (DC == 3) {
            const float4 lo = sm.box[2 * e], hi = sm.box[2 * e + 1];
            pass = RANGE ? box_meets3(qA, qB, lo, hi) : box_bound3(qA, lo, hi) <= qA.w;
          } else {
            const long long leaf = static_cast<long long>(a.nbp) - 1 + b;
            const float* lo = a.node_lo + leaf * D;
            const float* hi = a.node_hi + leaf * D;
            if (RANGE) {
              pass = box_meets_g(a, reinterpret_cast<const float4*>(sm.sq + qi * a.QS),
                                 reinterpret_cast<const float4*>(sm.sq + (nq + qi) * a.QS), lo,
                                 hi);
            } else {
              pass = box_bound_g(a, reinterpret_cast<const float4*>(sm.sq + qi * a.QS), lo, hi) <=
                     sm.sr2[qi];
            }
          }
        }
        const unsigned word = __ballot_sync(kFull, pass);
        if (lane == 0) sm.smask[e * ng + grp] = word;
      }
    }
    __syncthreads();
    // the survivors, compacted in candidate order onto the list
    bool keep = false;
    if (tid < nw) {
      for (int j = 0; j < ng; ++j) keep = keep || sm.smask[tid * ng + j] != 0u;
    }
    const unsigned kb = __ballot_sync(kFull, keep);
    if (lane == 0) wtot[warp] = __popc(kb);
    __syncthreads();
    int base = n, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      base += w < warp ? wtot[w] : 0;
      total += wtot[w];
    }
    if (keep) {
      const int i = base + __popc(kb & ((1u << lane) - 1u));
      sm.lid[i] = sm.sid[tid];
      for (int j = 0; j < ng; ++j) sm.lmask[i * ng + j] = sm.smask[tid * ng + j];
    }
    n += total;
    __syncthreads();  // the list is whole; the window's buffers are free
    if (n > 0 && (n > a.lcap - a.win || p0 + a.win >= c1)) {
      fold_list<DC, NWR, CH, RANGE>(a, sm, scnt, row0, n, ng, ph, D);
      n = 0;
    }
  }
  if (a.m == 0) {
    __syncthreads();
    for (int q = tid; q < nq; q += kThreads) {
      if (scnt[q] != 0) atomicAdd(a.counts + row0 + q, scnt[q]);
    }
  }
}

template <int DC, int NWR, int CH>
__global__ void __launch_bounds__(kThreads) verb_radius_fold_kernel(const FoldArgs a) {
  fold_block<DC, NWR, CH, false>(a);
}

template <int DC, int NWR, int CH>
__global__ void __launch_bounds__(kThreads) verb_range_fold_kernel(const FoldArgs a) {
  fold_block<DC, NWR, CH, true>(a);
}

template <int DC, int NWR, int CH, bool RANGE>
int launch(const FoldArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  void (*kernel)(const FoldArgs) =
      RANGE ? verb_range_fold_kernel<DC, NWR, CH> : verb_radius_fold_kernel<DC, NWR, CH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for D: D = 3; one window, 8, 16 or 32 positions tested; two
// windows, 4 CH positions of each (their longer one rounded up to a chunk);
// or wider, a window at a time.
template <bool RANGE>
int launch_d(const FoldArgs& a, dim3 grid, size_t smem, cudaStream_t st) {
  if (a.D == 3) return launch<3, 0, 0, RANGE>(a, grid, smem, st);
  if (a.nwin == 1) {
    if (a.D <= 8) return launch<0, 1, 2, RANGE>(a, grid, smem, st);
    if (a.D <= 16) return launch<0, 1, 4, RANGE>(a, grid, smem, st);
    return launch<0, 1, 8, RANGE>(a, grid, smem, st);
  }
  if (a.nwin == 2) {
    switch ((max(32 - a.off, a.D - 32 + a.off) + 3) >> 2) {  // 5..8
      case 5: return launch<0, 2, 5, RANGE>(a, grid, smem, st);
      case 6: return launch<0, 2, 6, RANGE>(a, grid, smem, st);
      case 7: return launch<0, 2, 7, RANGE>(a, grid, smem, st);
      default: return launch<0, 2, 8, RANGE>(a, grid, smem, st);
    }
  }
  return launch<0, 0, 0, RANGE>(a, grid, smem, st);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

size_t up16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

int fold_launch(bool range, const void* qa, const void* qb, const void* cand, const void* pts,
                const void* gid, const void* node_lo, const void* node_hi, void* counts,
                void* out_d, void* out_i, int T, int TQ, int D, int C, int B, int nbp, int m,
                int S, void* stream) {
  if (T <= 0 || C <= 0) return 0;
  if (TQ < 1 || TQ > kMaxTQ || D < 1 || B < 1 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FoldArgs a;
  a.qa = static_cast<const float*>(qa);
  a.qb = static_cast<const float*>(qb);
  a.cand = static_cast<const int*>(cand);
  a.pts = static_cast<const float*>(pts);
  a.gid = static_cast<const int*>(gid);
  a.node_lo = static_cast<const float*>(node_lo);
  a.node_hi = static_cast<const float*>(node_hi);
  a.counts = static_cast<int*>(counts);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.TQ = TQ;
  a.D = D;
  a.C = C;
  a.B = B;
  a.m = m;
  a.nbp = nbp;
  a.chunk = (C + S - 1) / S;
  const bool d3 = D == 3;
  // the staged rows' windows (axis_at): above 32 axes window_sum's, window
  // 0 holding 32 - off axes, for both folds (the range test needs no order,
  // and two windows of about D / 2 axes test fewer zeros than a full one
  // and a short one)
  const int w1 = (D + 31) >> 5;
  const int w2 = (w1 + 31) >> 5;
  a.nwin = w1;
  a.off = D > 32 ? (32 * w1 - D) >> 1 : 0;
  a.f2 = (32 * w2 - w1) >> 1;
  a.QS = 32 * a.nwin + 4;  // 128-bit loads of 8 lanes' rows hit 8 distinct bank quads
  // the stages: whole buckets where they fit, bulk-copied where the rows
  // are 16-byte multiples
  int rows = d3 ? min(B, kRows3) : min(min(B, kThreads), kStageBytes / ((D + 1) * 4));
  if (rows < 1) rows = 1;
  if (B % 4 == 0 && rows >= 4) rows &= ~3;
  a.rows = rows;
  a.parts = (B + rows - 1) / rows;
  a.bulk = (B % 4 == 0) && (rows % 4 == 0) && aligned16(pts) && aligned16(gid);
  // the ring: 4 stages at D = 3; at other D 2, or 1 where two would keep
  // a second block off the SM (the wide-D test is bound by the FP32 pipe,
  // and a second block's warps hide a lone stage's copy)
  const size_t stage = static_cast<size_t>(rows) * (D + 1) * 4;
  a.nst = d3 ? 4 : (stage <= 24 * 1024 ? 2 : 1);
  // queries a launch: as many as the staging budget holds
  const size_t qper = d3 ? (range ? 32 : 16)
                         : static_cast<size_t>(a.QS) * 4 * (range ? 2 : 1) + (range ? 0 : 4);
  int nqmax = static_cast<int>(kQueryBytes / qper);
  if (nqmax < 1) nqmax = 1;
  if (nqmax > TQ) nqmax = TQ;
  const int ngmax = (nqmax + 31) >> 5;
  a.win = min(kWindow, a.chunk);
  a.lcap = max(a.win, min(kListMax, a.chunk));
  size_t o = up16(static_cast<size_t>(a.nst) * rows * D * 4);
  a.o_gid = static_cast<int>(o);
  o += up16(static_cast<size_t>(a.nst) * rows * 4);
  a.o_q = static_cast<int>(o);
  o += up16(static_cast<size_t>(nqmax) * (qper - (!d3 && !range ? 4 : 0)));
  a.o_r2 = static_cast<int>(o);
  if (!d3 && !range) o += up16(static_cast<size_t>(nqmax) * 4);
  a.o_lid = static_cast<int>(o);
  o += up16(static_cast<size_t>(a.lcap) * 4);
  a.o_lmask = static_cast<int>(o);
  o += up16(static_cast<size_t>(a.lcap) * ngmax * 4);
  a.o_sid = static_cast<int>(o);
  o += up16(static_cast<size_t>(a.win) * 4);
  a.o_smask = static_cast<int>(o);
  o += up16(static_cast<size_t>(a.win) * ngmax * 4);
  a.o_box = static_cast<int>(o);
  if (d3) o += static_cast<size_t>(a.win) * 32;
  const size_t smem = o;
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int q0 = 0; q0 < TQ; q0 += nqmax) {
    a.q0 = q0;
    a.nq = min(nqmax, TQ - q0);
    const int err = range ? launch_d<true>(a, grid, smem, st) : launch_d<false>(a, grid, smem, st);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// tq f32[T, TQ, D], r2 f32[T, TQ] (< 0: a padding row), cand i32[T, C] (-1
// padding), pts f32[NBP, B, D], gid i32[NBP, B], node_lo / node_hi
// f32[2 NBP - 1, D] (the heap's boxes; bucket b's leaf is NBP - 1 + b) ->
// counts i32[T, TQ] (zeroed by the caller, added into), and for m > 0 out_d
// f32[T, TQ, m] / out_i i32[T, TQ, m] (filled +inf / -1 by the caller; null
// when m == 0). The grid is (T, S), each block ceil(C / S) positions; a
// tile's queries past the staging budget (wide D) take further launches on
// the same stream. 1 <= TQ <= 256, 1 <= S <= 65535, (D + 1) 4 <= 48 KB,
// every cand entry -1 or a bucket < NBP; every pointer is device memory,
// contiguous. Returns the first failed launch's CUDA error (0 = cudaSuccess;
// nothing is launched for T == 0 or C == 0).
extern "C" int verb_radius_fold_launch(const void* tq, const void* r2, const void* cand,
                                       const void* pts, const void* gid, const void* node_lo,
                                       const void* node_hi, void* counts, void* out_d,
                                       void* out_i, int T, int TQ, int D, int C, int B, int nbp,
                                       int m, int S, void* stream) {
  return fold_launch(false, tq, r2, cand, pts, gid, node_lo, node_hi, counts, out_d, out_i, T,
                     TQ, D, C, B, nbp, m, S, stream);
}

// The range fold: lo / hi f32[T, TQ, D] per-query boxes (inclusive faces;
// an empty box marks a padding row), out_i i32[T, TQ, m] (-1 filled, null
// when m == 0); the rest as the radius fold.
extern "C" int verb_range_fold_launch(const void* lo, const void* hi, const void* cand,
                                      const void* pts, const void* gid, const void* node_lo,
                                      const void* node_hi, void* counts, void* out_i, int T,
                                      int TQ, int D, int C, int B, int nbp, int m, int S,
                                      void* stream) {
  return fold_launch(true, lo, hi, cand, pts, gid, node_lo, node_hi, counts, nullptr, out_i, T,
                     TQ, D, C, B, nbp, m, S, stream);
}
