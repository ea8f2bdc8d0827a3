// The exact brute-force k-NN oracle as one fused kernel: the squared
// distances and the k smallest (d2, point index) per query, without the
// [Q, T] distance block ever reaching device memory.
//
// Replaces no TPU kernel: the JAX package's oracle is the jitted XLA program
// kdtree_tpu/ops/bruteforce.py::_knn_scan (:59), a lax.scan over point tiles
// carrying a running lax.top_k. Its plain PyTorch version is
// kdtree_tpu_torch/kernels/knn_scan.py::knn_scan_plain (the distance block
// of each point tile, then int64 (d2, index) keys and torch.topk), which
// this kernel matches bit for bit: d2 in pair_d2's arithmetic (d2.cuh, by
// way of pair_tile.cuh), the k smallest by (d2, index), the lowest index
// first on equal distances, and a slot at +inf (a masked row's distance)
// with id -1, as the reference's running top-k, which starts from (+inf,
// -1) entries that win every tie at +inf, gives it.
//
// What bounds it on the card: issue slots. Every (query, point) pair costs
// a subtract and an FMA an axis and one compare against the query's running
// k-th (7 instructions at D = 3, 3 D flops); the points, read once, are a
// small fraction of that (the fallback's 1,000 x 2^24 x 3-D: 1.2e11
// instructions, ~3.5 ms on 132 SMs, against 0.06 ms for the points) unless
// a batch is small or most of the points can be skipped. Where they are
// skipped, the k-best bookkeeping of the pairs near each query is what is
// left.
//
// knn_scan3_kernel (after knn_boxes_kernel) takes D = 3, the serving
// storage's width; knn_scan_kernel takes every other D. Both keep the k
// best per query the same way:
// - The grid is (query tile) x (S point chunks, each an ascending index
//   range). A thread holds an 8 x 4 register tile of d2, 8 queries of its
//   warp against 4 points (pair_tile.cuh), and compares each pair's
//   distance bits with its query's running k-th (one compare rejects almost
//   every pair; the warp votes once a tile of 128 points). The rest go out
//   of line (admit): the key (d2 bits << 32 | index) against the full
//   threshold, and the survivors of two 32-point columns at a time into
//   the query's buffer of kCap keys in shared memory, at slots from the
//   columns' ballots.
// - A query's keys come only from its own warp, so each warp selects for
//   its queries alone, with no block barrier: when two columns would
//   overflow the buffer, and at the end of the chunk. A select sorts the buffer
//   across the warp (bitonic, kPer keys a lane) and merges it into the
//   query's sorted k-list by ranks (each key's new place is its rank in its
//   own list plus its rank in the other, by binary search), cut at k. The
//   k-th key is the new threshold.
// - The k-lists of up to kSmemK entries live in shared memory and are
//   written out at the end; longer lists live in the partial buffers in
//   device memory from the start, the same code through generic pointers.
// - The lists are written with id -1 at +inf, the reference's pad. The
//   chunks' lists, pd/pi f32/i32[T, S, TQ, k], are joined by the merge
//   kernel of scan_knn.cu (kernels/scan_knn.py::merge_partials): it keeps
//   the k smallest by (d2, chunk, rank in chunk) and pads with (+inf, -1).
//   The chunks are ascending index ranges and each list is in (d2, index)
//   order, so that order is (d2, index).
//
// knn_scan3_kernel, the design for Hopper at D = 3:
// 1. A layout for small batches. A block is one producer warp and W query
//    warps of 8 queries each, W <= 7 (eight warps, two blocks an SM at 128
//    registers), the ceil(Q / 8) warps shared out evenly over as few tiles
//    as hold them: an 8-row batch is one query warp, not 64 rows, 64 rows
//    two tiles of 4 warps, and the plan fills the wave with point chunks
//    instead (kernels/knn_scan.py::plan_splits). A query warp keeps its 8
//    queries in registers for the whole block.
// 2. An exact cull on the box of each stage of kStage3 rows. knn_boxes_kernel
//    first takes every chunk's stages' boxes into a table (each stage
//    staged in shared memory by a bulk copy and min/max-reduced there; a
//    row whose first coordinate is +inf, a pad or masked row, is left out
//    of hi). A query's bound to a box is its squared distance to it in d2's
//    arithmetic: per axis the gap lo - q or q - hi (__fsub_rn), 0 inside,
//    folded by the same FMA chain (d2.cuh::box_bound). A stage is skipped
//    for a query when the bound's bits are strictly above its threshold:
//    the smaller of its chunk list's k-th and a per-query word in device
//    memory that every chunk lowers (atomicMin) to its k-th's distance bits
//    whenever its list is full (a select). Exact:
//    - A row inside the box has lo <= p <= hi on every axis, so |fl(q - p)|
//      >= the gap (rounding is monotone and symmetric), and fma(x, x, acc)
//      is monotone in x >= 0 and acc >= 0: its d2 bits are >= the bound's.
//    - A row left out of hi has d2 = +inf or NaN (an infinite coordinate),
//      bits >= +inf's >= any bound's; fminf and fmaxf pass over NaN
//      coordinates, whose d2 is NaN the same way.
//    - Any chunk's k-th is >= the whole answer's k-th, so a row whose d2 is
//      strictly above it is in no answer; a tie at the threshold is not
//      skipped (the lower index may win it). A chunk's list may then hold
//      fewer than k rows; it is padded with (+inf, -1), which the merge
//      handles, and every row of the answer is still in its chunk's list.
//    The same threshold tightens the per-pair compare. On points in random
//    order a stage's box spans the domain and nothing is skipped; on the
//    serving callers' Morton-ordered storage a stage is four neighbouring
//    buckets and almost every stage is.
// 3. A TMA ring with no block barrier a stage, only for stages some query
//    needs. The producer warp walks the chunk's stages, tests each box
//    against all the block's queries (a lane holds two) and publishes only
//    a stage some query may need: lane 0 writes the stage's index and box
//    into the next ring slot and copies its rows in with one 1-D bulk copy
//    (cp.async.bulk) of the 16-byte-aligned span around them (a few bytes
//    of the neighbouring rows, inside the tensor; only the tensor's own
//    first and last bytes outside it come by plain loads), so any chunk
//    start and any 4-byte-aligned base work. A slot has a "full" barrier
//    (the copy's bytes) and an "empty" one (an arrival a query warp); a
//    stage index of -1 ends the chunk. Query warps wait on full, test their
//    own queries, compute or skip, and arrive on empty: the loop has no
//    __syncthreads, a stage no query needs is never copied in, and the
//    warps' slack in the ring is counted in needed stages only. Every stage
//    the producer also copies the block's shared thresholds into shared
//    memory, where the query warps read them, by asynchronous copies it
//    never waits for.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d2.cuh"
#include "pair_tile.cuh"

namespace {

using namespace kdt;

constexpr int kRQ = 8;                 // queries a thread
constexpr int kRP = 4;                 // points a thread, lane + 32 j
constexpr int kTQ = kTileWarps * kRQ;  // queries a block of knn_scan_kernel
constexpr int kSubP = 32 * kRP;        // points a tile of sums
constexpr int kSub = 8;                // tiles of sums a stage at most: a barrier a stage
constexpr int kLdq = kTQ + 4;          // staged query stride (16-byte rows)
constexpr int kCap = 64;               // buffered keys a query: 2 a lane in the select
constexpr int kPer = kCap / 32;
constexpr int kSmemK = 64;             // k-lists up to this length in shared memory
constexpr int kRing = 3;               // point stages in knn_scan_kernel's ring
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kStage3 = 1024;  // rows a stage of knn_scan3_kernel
constexpr int kRing3 = 5;      // its ring slots

constexpr int kWarps3 = 7;  // query warps a block at most: 8 warps, two blocks an SM
// a slot: the stage's rows and up to 15 bytes of the 16-byte span on each side
constexpr int kSlot3 = (kStage3 * 12 + 30 + 15) / 16 * 16;
static_assert(kStage3 % kSubP == 0, "a stage is whole tiles of sums");
static_assert(kRing3 >= 2, "a ring of at least two slots");

// Tiles of sums a stage: one above 32 axes (a stage is a slice of one
// tile), else as many as keep a stage's staged axes within 32 rows of 128
// points.
__host__ __device__ constexpr int subtiles(int D) {
  return D > kSlice ? 1 : (kSlice / D < kSub ? kSlice / D : kSub);
}

__device__ __forceinline__ unsigned long long make_key(float d2, unsigned idx) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | idx;
}

__device__ __forceinline__ unsigned long long list_key(const float* ld, const int* li, int i) {
  return make_key(ld[i], static_cast<unsigned>(li[i]));
}

// How many of the first n entries of the sorted list are below x.
__device__ __forceinline__ int rank_in_list(const float* ld, const int* li, int n,
                                            unsigned long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list_key(ld, li, mid) < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int rank_in_keys(const unsigned long long* b, int n,
                                            unsigned long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ unsigned long long shfl_xor64(unsigned long long v, int m) {
  const unsigned lo = __shfl_xor_sync(kFull, static_cast<unsigned>(v), m);
  const unsigned hi = __shfl_xor_sync(kFull, static_cast<unsigned>(v >> 32), m);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Ascending bitonic sort of the warp's 32 kPer keys, key e = lane kPer + m
// in v[m] of that lane.
__device__ __forceinline__ void warp_sort(unsigned long long (&v)[kPer], int lane) {
#pragma unroll
  for (int size = 2; size <= kCap; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kPer) {
        const int m = stride / kPer;  // the partner lane: lane ^ m
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const unsigned long long other = shfl_xor64(v[j], m);
          const bool asc = ((lane * kPer + j) & size) == 0;
          // the lower element of an ascending pair keeps the smaller key
          const bool keep_small = lower == asc;
          v[j] = keep_small ? (other < v[j] ? other : v[j]) : (other > v[j] ? other : v[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if ((j & stride) == 0) {
            const bool asc = ((lane * kPer + j) & size) == 0;
            const unsigned long long x = v[j], y = v[j + stride];
            if ((x > y) == asc) {
              v[j] = y;
              v[j + stride] = x;
            }
          }
        }
      }
    }
  }
}

// A block's lists, in shared memory (kernels pass a pointer, so that the
// fields stay out of the distance loop's registers).
struct Lists {
  unsigned long long* buf;  // [TQ][kCap]
  unsigned long long* thr;  // [TQ]: the k-th key, kNoKey while a list is short
  int* cnt;                 // [TQ]: keys in the buffer
  int* len;                 // [TQ]: entries in the k-list
  float* ld;                // the k-lists: shared [TQ][k], or the block's partials
  int* li;
  unsigned* gthr;           // per query row, the chunks' shared threshold bits, or null
  long long row0, last;     // local query q is row min(row0 + q, last)
};

// One warp merges query q's buffer into its k-list (see the note above) and
// empties the buffer; a full list's k-th goes to the shared threshold. Out
// of line: it runs rarely, and its registers stay out of the distance
// loop's.
__device__ __noinline__ void select_query(const Lists* L, int q, int k) {
  const int lane = threadIdx.x & 31;
  const int b = L->cnt[q];
  if (b == 0) return;
  unsigned long long* buf = L->buf + static_cast<long long>(q) * kCap;
  float* ld = L->ld + static_cast<long long>(q) * k;
  int* li = L->li + static_cast<long long>(q) * k;
  const int len = L->len[q];

  unsigned long long v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = lane * kPer + j < b ? buf[lane * kPer + j] : kNoKey;
  warp_sort(v, lane);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (lane * kPer + j < b) buf[lane * kPer + j] = v[j];
  }
  // the buffer's places in the merged list, from the list before it moves
  int pos[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = lane * kPer + j;
    pos[j] = e < b && e < k ? e + rank_in_list(ld, li, len, v[j]) : k;
  }
  __syncwarp();
  // the list's entries move up by their rank in the buffer: 32 at a time
  // from the top, all read before any is written, so none is overwritten
  // before it is read
  for (int base = ((len - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int i = base + lane;
    float d = 0.f;
    int id = 0;
    int np = k;
    if (i < len) {
      d = ld[i];
      id = li[i];
      np = i + rank_in_keys(buf, b, make_key(d, static_cast<unsigned>(id)));
    }
    __syncwarp();
    if (np < k) {
      ld[np] = d;
      li[np] = id;
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (pos[j] < k) {
      ld[pos[j]] = __uint_as_float(static_cast<unsigned>(v[j] >> 32));
      li[pos[j]] = static_cast<int>(static_cast<unsigned>(v[j]));
    }
  }
  __syncwarp();
  const int nl = len + b < k ? len + b : k;
  if (lane == 0) {
    L->len[q] = nl;
    L->cnt[q] = 0;
    const unsigned long long t = nl == k ? list_key(ld, li, k - 1) : kNoKey;
    L->thr[q] = t;
    if (L->gthr != nullptr && nl == k) {
      const long long row = L->row0 + q < L->last ? L->row0 + q : L->last;
      atomicMin(L->gthr + row, static_cast<unsigned>(t >> 32));
    }
  }
  __syncwarp();
}

// The rare path of test_append: the tile's pairs (d2[i kRP + j] for query
// qb + i and point base + lane + 32 j; points at or past `end` are not the
// chunk's) against the thresholds' bits thi[i], and for each query some
// lane's pair passes, the keys below its full threshold key appended to
// its buffer, two 32-point columns at a time: slots from the columns'
// ballots, the query's threshold key and buffer count held in registers
// meanwhile. A pair of columns that would overflow the buffer selects
// first (an empty buffer holds both). A query's keys come only from its
// warp's lanes, so the warp does this alone, with no block barrier. Out of
// line, and with the comparisons made again here, so that the distance
// loop keeps its registers and its compare chain.
__device__ __noinline__ void admit(const float* d2, const unsigned* thi, const Lists* L, int k,
                                   long long base, long long end, int qb) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  unsigned near = 0;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRP; ++j) any |= __float_as_uint(d2[i * kRP + j]) <= thi[i];
    near |= static_cast<unsigned>(any) << i;
  }
  near = __reduce_or_sync(kFull, near);
#pragma unroll 1
  for (int i = 0; i < kRQ; ++i) {
    if (!(near >> i & 1)) continue;
    const int q = qb + i;
    unsigned long long t = L->thr[q];
    int c = L->cnt[q];
#pragma unroll
    for (int j = 0; j < kRP; j += 2) {
      const long long i0 = base + lane + 32 * j, i1 = i0 + 32;
      const unsigned long long key0 = make_key(d2[i * kRP + j], static_cast<unsigned>(i0));
      const unsigned long long key1 = make_key(d2[i * kRP + j + 1], static_cast<unsigned>(i1));
      bool p0 = i0 < end && key0 < t, p1 = i1 < end && key1 < t;
      unsigned m0 = __ballot_sync(kFull, p0), m1 = __ballot_sync(kFull, p1);
      if ((m0 | m1) == 0) continue;
      if (c + __popc(m0) + __popc(m1) > kCap) {
        if (lane == 0) L->cnt[q] = c;
        __syncwarp();
        select_query(L, q, k);
        t = L->thr[q];
        c = 0;
        p0 = i0 < end && key0 < t;
        p1 = i1 < end && key1 < t;
        m0 = __ballot_sync(kFull, p0);
        m1 = __ballot_sync(kFull, p1);
      }
      unsigned long long* buf = L->buf + static_cast<long long>(q) * kCap + c;
      if (p0) buf[__popc(m0 & below)] = key0;
      if (p1) buf[__popc(m0) + __popc(m1 & below)] = key1;
      c += __popc(m0) + __popc(m1);
    }
    __syncwarp();
    if (lane == 0) L->cnt[q] = c;
  }
  __syncwarp();
}

// The tile's pairs (points base + lane + 32 j) against thi[i], query qb +
// i's threshold bits: one vote rejects almost every tile, and admit takes
// the rest to the lists; points at or past `end` are not the chunk's. Lane
// i < 8 of `gq` holds the shared threshold of query qb + i (all ones when
// there is none), which bounds thi again after that.
template <int MODE>
__device__ __forceinline__ void test_append(const Sums<kRQ, kRP>& acc, const Lists* L, int k,
                                            unsigned (&thi)[kRQ], unsigned gq, long long base,
                                            long long end, int qb) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int j = 0; j < kRP; ++j) {
      any |= __float_as_uint(acc.template result<MODE>(i, j)) <= thi[i];
    }
  }
  if (!__any_sync(kFull, any)) return;
  float d2[kRQ * kRP];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int j = 0; j < kRP; ++j) d2[i * kRP + j] = acc.template result<MODE>(i, j);
  }
  admit(d2, thi, L, k, base, end, qb);
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const unsigned own = static_cast<unsigned>(L->thr[qb + i] >> 32);
    const unsigned g = __shfl_sync(kFull, gq, i);
    thi[i] = own < g ? own : g;
  }
}

// The warp's k-lists out, rows qb .. qb + 7 of the block's partials at
// pd/pi + out0: (+inf, -1) past a list's length (a culled chunk may hold
// fewer than k rows, an idle warp none) and id -1 at +inf.
__device__ __forceinline__ void write_lists(const Lists* L, float* pd, int* pi, long long out0,
                                            int qb, int k, bool smem_lists, bool active) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < kRQ * k; e += 32) {
    const int i = e / k;
    const long long o = static_cast<long long>(qb) * k + e;
    const bool have = active && e - i * k < L->len[qb + i];
    const float d = have ? L->ld[o] : __int_as_float(0x7f800000);
    if (smem_lists || !have) pd[out0 + o] = d;
    if (smem_lists || !have || isinf(d)) pi[out0 + o] = isinf(d) ? -1 : L->li[o];
  }
}

// ---- knn_scan_kernel: every D but 3 -----------------------------------

struct KnnArgs {
  const float* q;  // [Q, D]
  const float* p;  // [N, D]
  float* pd;       // [T, S, kTQ, k]
  int* pi;         // [T, S, kTQ, k]
  long long Q, N, chunk;  // chunk s: [s chunk, (s + 1) chunk), the last to N
  int D, k, S;
};

// A block is 64 queries (8 a warp) against its chunk's points in stages of
// up to 1,024 points, a slice of up to 32 axes each, staged transposed by
// 4-byte cp.async (a 3-slot ring, one block barrier a stage).
template <int MODE>
__global__ void __launch_bounds__(kTileThreads, 2) knn_scan_kernel(const KnnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D;
  const int k = a.k;
  const int ds0 = D < kSlice ? D : kSlice;
  const int nsl = (D + kSlice - 1) / kSlice;
  const bool smem_lists = k <= kSmemK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the staged rows first (16-byte aligned): queries [nqbuf][ds0][kLdq],
  // points [kRing][ds0][bp + 1]
  float* sq = reinterpret_cast<float*>(smem_raw);
  const int nqbuf = nsl > 1 ? kRing : 1;
  float* sp = sq + nqbuf * ds0 * kLdq;
  const int bp = kSubP * subtiles(D);  // points a stage
  const int ldp = bp + 1;              // staged point stride (transposed, 32 banks)
  const int pstage = ds0 * ldp;
  unsigned char* p = reinterpret_cast<unsigned char*>(sp + kRing * pstage);
  p += (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  __shared__ Lists lists;
  Lists Lb;
  Lb.buf = reinterpret_cast<unsigned long long*>(p);
  p += sizeof(unsigned long long) * kTQ * kCap;
  Lb.thr = reinterpret_cast<unsigned long long*>(p);
  p += sizeof(unsigned long long) * kTQ;
  Lb.cnt = reinterpret_cast<int*>(p);
  p += sizeof(int) * kTQ;
  Lb.len = reinterpret_cast<int*>(p);
  p += sizeof(int) * kTQ;
  const long long tile = blockIdx.x;
  const int s = blockIdx.y;
  const long long out0 = (tile * a.S + s) * kTQ * static_cast<long long>(k);
  if (smem_lists) {
    Lb.ld = reinterpret_cast<float*>(p);
    p += sizeof(float) * kTQ * k;
    Lb.li = reinterpret_cast<int*>(p);
  } else {
    Lb.ld = a.pd + out0;
    Lb.li = a.pi + out0;
  }
  Lb.gthr = nullptr;
  Lb.row0 = 0;
  Lb.last = 0;
  const Lists* L = &lists;

  const long long q0 = tile * kTQ;
  const long long start = s * a.chunk;
  const long long end = s == a.S - 1 ? a.N : start + a.chunk;
  const int steps = static_cast<int>((end - start + bp - 1) / bp);
  const int stages = steps * nsl;
  const Windows win(D);

  if (tid == 0) lists = Lb;
  if (lane < kRQ) {
    Lb.thr[warp * kRQ + lane] = kNoKey;
    Lb.cnt[warp * kRQ + lane] = 0;
    Lb.len[warp * kRQ + lane] = 0;
  }
  unsigned thi[kRQ];  // the thresholds' distance bits, for the fast test
#pragma unroll
  for (int i = 0; i < kRQ; ++i) thi[i] = 0xffffffffu;

  // stage g is slice g % nsl of step g / nsl, in ring slot g % kRing: its
  // points, and its queries when there is more than one slice (else the
  // queries once, with stage 0)
  auto stage = [&](int g, int st, int sl) {
    const int r = g % kRing;
    const long long row0 = start + static_cast<long long>(st) * bp;
    const int d0 = sl * kSlice;
    const int ds = D - d0 < kSlice ? D - d0 : kSlice;
    if (nsl > 1 || g == 0) {
      stage_rows(sq + (nsl > 1 ? r : 0) * ds0 * kLdq, kLdq, a.q, q0, a.Q - 1, kTQ, D, d0, ds);
    }
    stage_rows(sp + r * pstage, ldp, a.p, row0, end - 1, bp, D, d0, ds);
    sm90::cp_async_commit();
  };

  Sums<kRQ, kRP> acc;
  acc.clear();
  stage(0, 0, 0);
  int nst = nsl > 1 ? 0 : 1, nsl1 = nsl > 1 ? 1 : 0;  // stage g + 1's step and slice
  if (stages > 1) stage(1, nst, nsl1);
  int st = 0, sl = 0;
  for (int g = 0; g < stages; ++g) {
    const int r = g % kRing;
    if (g + 1 < stages) {
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    // stage g has landed for every thread, and every thread is done with
    // stage g - 1, whose ring slot stage g + 2 takes
    __syncthreads();
    if (++nsl1 == nsl) {
      nsl1 = 0;
      ++nst;
    }
    if (g + 2 < stages) stage(g + 2, nst, nsl1);
    if (nsl > 1) {  // one tile of sums a stage, its slices in turn
      const int d0 = sl * kSlice;
      const int ds = D - d0 < kSlice ? D - d0 : kSlice;
      accumulate<MODE>(acc, sq + r * ds0 * kLdq, kLdq, sp + r * pstage, ldp, warp * kRQ, d0,
                       ds, D, win);
      if (++sl < nsl) continue;
      test_append<MODE>(acc, L, k, thi, kFull, start + static_cast<long long>(st) * bp, end,
                        warp * kRQ);
      acc.clear();
      sl = 0;
      ++st;
      continue;
    }
#pragma unroll 1
    for (int u = 0; u < bp / kSubP; ++u) {
      accumulate<MODE>(acc, sq, kLdq, sp + r * pstage + u * kSubP, ldp, warp * kRQ, 0, D, D,
                       win);
      test_append<MODE>(acc, L, k, thi, kFull,
                        start + static_cast<long long>(st) * bp + u * kSubP, end, warp * kRQ);
      acc.clear();
    }
    ++st;
  }
  // the last keys of the warp's buffers, then its lists out
  for (int i = 0; i < kRQ; ++i) select_query(L, warp * kRQ + i, k);
  write_lists(L, a.pd, a.pi, out0, warp * kRQ, k, smem_lists, true);
}

template <int MODE>
size_t smem_bytes(int D, int k) {
  const int ds0 = D < kSlice ? D : kSlice;
  const int nqbuf = D > kSlice ? kRing : 1;
  const int bp = kSubP * subtiles(D);
  const int pstage = ds0 * (bp + 1);
  size_t bytes = static_cast<size_t>(4) * (nqbuf * ds0 * kLdq + kRing * pstage) + 16;
  bytes += sizeof(unsigned long long) * kTQ * (kCap + 1) + sizeof(int) * 2 * kTQ;
  if (k <= kSmemK) bytes += static_cast<size_t>(8) * kTQ * k;
  return bytes;
}

template <int MODE>
int prepare(int D, int k, size_t* smem) {
  *smem = smem_bytes<MODE>(D, k);
  if (*smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(knn_scan_kernel<MODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(*smem)));
}

template <int MODE>
int launch(const KnnArgs& a, cudaStream_t st) {
  size_t smem = 0;
  const int e = prepare<MODE>(a.D, a.k, &smem);
  if (e != 0) return e;
  const dim3 grid(static_cast<unsigned>((a.Q + kTQ - 1) / kTQ), static_cast<unsigned>(a.S));
  knn_scan_kernel<MODE><<<grid, kTileThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int slots(int D, int k) {
  size_t smem = 0;
  int e = prepare<MODE>(D, k, &smem);
  if (e != 0) return -e;
  int n = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, knn_scan_kernel<MODE>, kTileThreads, smem));
  return e != 0 ? -e : n;
}

// ---- knn_scan3_kernel: D = 3 (the design note at the top) -------------

struct Knn3Args {
  const float* q;                // [Q, 3]
  const float* p;                // [N, 3], 4-byte aligned
  float* pd;                     // [T, S, 8 W, k]
  int* pi;                       // [T, S, 8 W, k]
  unsigned* gthr;                // [T tq]: the shared thresholds' bits, all ones at the start
  unsigned long long* counts;    // null, or [2]: culled and all (warp, stage) pairs
  float* boxes;                  // [S, G, 8]: each chunk's stages' boxes (knn_boxes_kernel)
  long long Q, N, chunk;
  int k, S, W, G;                // G stages a chunk at most
};

// Query warps a block for Q queries: ceil(Q / 8) warps of 8 rows in as few
// blocks of at most kWarps3 as hold them, shared out evenly.
__host__ __device__ inline int warps3(long long Q) {
  const long long w = (Q + 7) / 8, t = (w + kWarps3 - 1) / kWarps3;
  return static_cast<int>((w + t - 1) / t);
}

inline size_t smem3_bytes(int W, int k) {
  const size_t tq = static_cast<size_t>(kRQ) * W;
  const size_t R = kRing3;
  size_t bytes = R * kSlot3;                                 // the ring
  bytes += 4 * 8 * R + 4 * 4 * (tq + 4);                     // slot boxes, queries, thresholds
  bytes += 8 * 2 * R + 4 * R + 8;                            // barriers, slot stages, padding
  bytes += 8 * tq * (kCap + 1) + 4 * 2 * tq;                 // buffers, thresholds, counts
  if (k <= kSmemK) bytes += 8 * tq * k;
  return bytes;
}

// One row into a box: lo over every row, hi over the rows whose first
// coordinate is finite (a +inf row is a pad or a masked row; fmaxf passes
// over the NaN put in its place, and over NaN coordinates).
__device__ __forceinline__ void box_row(float (&lo)[3], float (&hi)[3], float x, float y,
                                        float z) {
  const float nan = __int_as_float(0x7fffffff);
  const bool pad = x == __int_as_float(0x7f800000);
  lo[0] = fminf(lo[0], x);
  lo[1] = fminf(lo[1], y);
  lo[2] = fminf(lo[2], z);
  hi[0] = fmaxf(hi[0], pad ? nan : x);
  hi[1] = fmaxf(hi[1], pad ? nan : y);
  hi[2] = fmaxf(hi[2], pad ? nan : z);
}

// Copies rows [row0, row0 + n) of the [N, 3] points at pbase into slot,
// one thread: slot byte 0 is the 16-byte boundary at or below the rows'
// first byte. One bulk copy of the 16-byte-aligned span around the rows (a
// few bytes of the neighbouring rows, inside the tensor) completes on bar;
// the tensor's own first or last bytes, where the span would leave it,
// come by plain loads first.
__device__ __forceinline__ void copy_rows(unsigned char* slot, uintptr_t pbase, long long N,
                                          long long row0, long long n, uint64_t* bar) {
  const uintptr_t b0 = pbase + 12 * row0, b1 = b0 + 12 * n;
  const uintptr_t base16 = b0 & ~static_cast<uintptr_t>(15);
  const uintptr_t lo16 = base16 >= pbase ? base16 : base16 + 16;
  uintptr_t hi16 = (b1 + 15) & ~static_cast<uintptr_t>(15);
  if (hi16 > pbase + 12 * static_cast<uintptr_t>(N)) hi16 -= 16;
  const uint32_t bytes = hi16 > lo16 ? static_cast<uint32_t>(hi16 - lo16) : 0u;
  auto word = [&](uintptr_t w) {
    *reinterpret_cast<float*>(slot + (w - base16)) = *reinterpret_cast<const float*>(w);
  };
  if (bytes == 0) {
    for (uintptr_t w = b0; w < b1; w += 4) word(w);
  } else {
    for (uintptr_t w = b0; w < lo16; w += 4) word(w);
    for (uintptr_t w = hi16; w < b1; w += 4) word(w);
  }
  sm90::mbar_arrive_expect_tx(bar, bytes);
  if (bytes > 0) {
    sm90::bulk_copy_g2s(slot + (lo16 - base16), reinterpret_cast<const void*>(lo16), bytes, bar);
  }
}

// The boxes of every chunk's stages, [S, G, 8] (lo[3], -, hi[3], -): block
// (g, s) reduces stage g of chunk s, its rows staged in shared memory by
// one bulk copy of their 16-byte-aligned span (the tensor's own first and
// last bytes outside it by plain loads), as knn_scan3_kernel stages them.
__global__ void __launch_bounds__(kTileThreads) knn_boxes_kernel(const Knn3Args a) {
  __shared__ __align__(16) unsigned char slot[kSlot3];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float part[kTileWarps][8];
  const int g = blockIdx.x, s = blockIdx.y;
  const long long start = s * a.chunk;
  const long long end = s == a.S - 1 ? a.N : start + a.chunk;
  const long long row0 = start + static_cast<long long>(g) * kStage3;
  if (row0 >= end) return;
  const int n = static_cast<int>(end - row0 < kStage3 ? end - row0 : kStage3);
  const uintptr_t pbase = reinterpret_cast<uintptr_t>(a.p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_mbar_init();
    copy_rows(slot, pbase, a.N, row0, n, &bar);
  }
  __syncthreads();
  sm90::mbar_wait(&bar, 0);
  const float* st = reinterpret_cast<const float*>(slot + ((pbase + 12 * row0) & 15));
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int i = tid; i < n; i += kTileThreads) box_row(lo, hi, st[3 * i], st[3 * i + 1], st[3 * i + 2]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(kFull, lo[c], m));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(kFull, hi[c], m));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      part[warp][c] = lo[c];
      part[warp][4 + c] = hi[c];
    }
  }
  __syncthreads();
  if (tid < 8) {
    float v = part[0][tid];
    for (int w = 1; w < kTileWarps; ++w) {
      v = tid < 4 ? fminf(v, part[w][tid]) : fmaxf(v, part[w][tid]);
    }
    a.boxes[(static_cast<long long>(s) * a.G + g) * 8 + tid] = v;
  }
}

__global__ void __launch_bounds__(32 * (kWarps3 + 1), 2) knn_scan3_kernel(const Knn3Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = a.W;
  constexpr int R = kRing3;
  const int tq = kRQ * W;
  const int ldq = tq + 4;  // staged query stride (16-byte rows)
  const int k = a.k;

  // shared memory: the ring, each slot's box, the queries by axis, the
  // shared thresholds' copies, the barriers, each slot's stage, the lists
  unsigned char* ring = smem_raw;
  float* sbox = reinterpret_cast<float*>(ring + R * kSlot3);   // [R][8]
  float* sq = sbox + 8 * R;                                      // [3][ldq]
  unsigned* sg = reinterpret_cast<unsigned*>(sq + 3 * ldq);      // [ldq]
  uint64_t* full = reinterpret_cast<uint64_t*>(sg + ldq);
  uint64_t* empty = full + R;
  int* sstage = reinterpret_cast<int*>(empty + R);               // [R]
  unsigned char* p = reinterpret_cast<unsigned char*>(sstage + R);
  p += (8 - (reinterpret_cast<uintptr_t>(p) & 7)) & 7;
  __shared__ Lists lists;
  const long long tile = blockIdx.x;
  const int s = blockIdx.y;
  const long long q0 = tile * tq;
  const long long start = s * a.chunk;
  const long long end = s == a.S - 1 ? a.N : start + a.chunk;
  const int stages = static_cast<int>((end - start + kStage3 - 1) / kStage3);
  const uintptr_t pbase = reinterpret_cast<uintptr_t>(a.p);

  if (tid == 0) {
    Lists Lb;
    Lb.buf = reinterpret_cast<unsigned long long*>(p);
    p += sizeof(unsigned long long) * tq * kCap;
    Lb.thr = reinterpret_cast<unsigned long long*>(p);
    p += sizeof(unsigned long long) * tq;
    Lb.cnt = reinterpret_cast<int*>(p);
    p += sizeof(int) * tq;
    Lb.len = reinterpret_cast<int*>(p);
    p += sizeof(int) * tq;
    const long long out0 = (tile * a.S + s) * tq * static_cast<long long>(k);
    if (k <= kSmemK) {
      Lb.ld = reinterpret_cast<float*>(p);
      p += sizeof(float) * tq * k;
      Lb.li = reinterpret_cast<int*>(p);
    } else {
      Lb.ld = a.pd + out0;
      Lb.li = a.pi + out0;
    }
    Lb.gthr = a.gthr;
    Lb.row0 = q0;
    Lb.last = a.Q - 1;
    lists = Lb;
    for (int r = 0; r < R; ++r) {
      sm90::mbar_init(&full[r], 1);
      sm90::mbar_init(&empty[r], W);
    }
    sm90::fence_mbar_init();
  }
  if (warp > 0) {  // a query warp stages its 8 queries, by axis
    const int qb = (warp - 1) * kRQ;
    if (lane < 3 * kRQ) {
      const int i = lane / 3, c = lane - 3 * i;
      const long long row = q0 + qb + i < a.Q ? q0 + qb + i : a.Q - 1;
      sq[c * ldq + qb + i] = a.q[row * 3 + c];
    }
  } else {
    for (int i = lane; i < tq; i += 32) sg[i] = 0xffffffffu;
  }
  __syncthreads();  // barriers, list pointers, queries and thresholds set
  const Lists* L = &lists;
  if (warp > 0 && lane < kRQ) {
    const int q = (warp - 1) * kRQ + lane;
    L->thr[q] = kNoKey;
    L->cnt[q] = 0;
    L->len[q] = 0;
  }
  __syncthreads();  // the lists initialised: the producer reads their thresholds

  if (warp == 0) {
    // The producer. For each stage of the chunk in turn it takes the box
    // from the table and publishes the stage only if some query of the
    // block may need it: its bound to the box at or below the smaller of
    // its chunk list's k-th and its shared threshold (a stage no query
    // needs is never copied in, and the query warps never see it). A stage
    // it publishes goes into the next ring slot, with its index and box,
    // by one bulk copy of the 16-byte-aligned span around its rows (the
    // tensor's own first and last bytes outside it by plain loads); a
    // stage index of -1 ends the chunk. Lane l holds queries l and l + 32
    // (rows past Q repeat the last); every stage it also copies the block's
    // shared thresholds into sg by asynchronous 16-byte copies that it never
    // waits for (any value a query warp reads there is some chunk's k-th,
    // or all ones, so a stale one is as exact).
    const float* table = a.boxes + static_cast<long long>(s) * a.G * 8;
    const unsigned* thr_hi = reinterpret_cast<const unsigned*>(L->thr) + 1;  // d2 bits
    float qv[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h < tq ? lane + 32 * h : tq - 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) qv[h][c] = sq[c * ldq + i];
    }
    // the boxes of 32 stages a batch, stage g's at lane g % 32 (two float4)
    auto load_batch = [&](int g0, float4& lo, float4& hi) {
      const int g = g0 + lane;
      if (g < stages) {
        lo = reinterpret_cast<const float4*>(table)[2 * g];
        hi = reinterpret_cast<const float4*>(table)[2 * g + 1];
      }
    };
    float4 blo, bhi, nlo, nhi;
    load_batch(0, blo, bhi);
    load_batch(32, nlo, nhi);
    int pub = 0;  // stages published
    // stage g into the next slot (lane 0)
    auto publish = [&](int g, const float (&lo)[3], const float (&hi)[3]) {
      const int r = pub % R;
      // the slot frees when every query warp is done with its last stage
      if (pub >= R) sm90::mbar_wait(&empty[r], ((pub - R) / R) & 1);
      sstage[r] = g;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sbox[8 * r + c] = lo[c];
        sbox[8 * r + 4 + c] = hi[c];
      }
      const long long row0 = start + static_cast<long long>(g) * kStage3;
      copy_rows(ring + r * kSlot3, pbase, a.N, row0, end - row0 < kStage3 ? end - row0 : kStage3,
                &full[r]);
    };
    for (int g = 0; g < stages; ++g) {
      if ((g & 31) == 0 && g > 0) {
        blo = nlo;
        bhi = nhi;
        load_batch(g + 32, nlo, nhi);
      }
      if (4 * lane < tq) sm90::cp_async16_cg(sg + 4 * lane, a.gthr + q0 + 4 * lane);
      const int src = g & 31;
      const float lo[3] = {__shfl_sync(kFull, blo.x, src), __shfl_sync(kFull, blo.y, src),
                           __shfl_sync(kFull, blo.z, src)};
      const float hi[3] = {__shfl_sync(kFull, bhi.x, src), __shfl_sync(kFull, bhi.y, src),
                           __shfl_sync(kFull, bhi.z, src)};
      bool need = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        if (i < tq && q0 + i < a.Q) {
          const unsigned own = thr_hi[2 * i];
          const unsigned t = own < sg[i] ? own : sg[i];
          need |= __float_as_uint(box_bound<3>(lo, hi, qv[h], nullptr, 3)) <= t;
        }
      }
      if (!__any_sync(kFull, need)) continue;
      if (lane == 0) publish(g, lo, hi);
      ++pub;
    }
    sm90::cp_async_wait_all();
    if (lane == 0) {  // the end of the chunk
      const int r = pub % R;
      if (pub >= R) sm90::mbar_wait(&empty[r], ((pub - R) / R) & 1);
      sstage[r] = -1;
      sm90::mbar_arrive_expect_tx(&full[r], 0);
    }
    return;
  }

  // a query warp: 8 queries, rows q0 + qb .. q0 + qb + 7 (past Q, the last),
  // through the published stages in turn
  const int qb = (warp - 1) * kRQ;
  const bool active = q0 + qb < a.Q;
  float q3[3][kRQ];  // the warp's queries by axis, in registers for the whole block
#pragma unroll
  for (int c = 0; c < 3; ++c) load_vec(q3[c], sq + c * ldq + qb);
  unsigned thi[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) thi[i] = 0xffffffffu;
  const Windows win(3);
  unsigned long long computed = 0;

  for (int m = 0;; ++m) {
    const int r = m % R;
    sm90::mbar_wait(&full[r], (m / R) & 1);
    const int g = sstage[r];
    if (g < 0) break;
    if (active) {
      // the shared thresholds as the producer last copied them
      float gq[kRQ];
      load_vec(gq, reinterpret_cast<const float*>(sg + qb));
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const unsigned gi = __float_as_uint(gq[i]);
        thi[i] = thi[i] < gi ? thi[i] : gi;
      }
      const int me = qb + (lane & 7);
      const unsigned gcur = sg[me];
      const float* b = sbox + 8 * r;
      const float mq[3] = {sq[me], sq[ldq + me], sq[2 * ldq + me]};
      const float bound = box_bound<3>(b, b + 4, mq, nullptr, 3);
      const unsigned own = static_cast<unsigned>(L->thr[me] >> 32);
      const unsigned t = own < gcur ? own : gcur;
      const bool skip = __ballot_sync(kFull, lane < kRQ && __float_as_uint(bound) <= t) == 0;
      if (!skip) {
        ++computed;
        const long long row0 = start + static_cast<long long>(g) * kStage3;
        const int n = static_cast<int>(end - row0 < kStage3 ? end - row0 : kStage3);
        const float* st =
            reinterpret_cast<const float*>(ring + r * kSlot3 + ((pbase + 12 * row0) & 15));
#pragma unroll 1
        for (int u = 0; u < (n + kSubP - 1) / kSubP; ++u) {
          Sums<kRQ, kRP> acc;
          acc.clear();
          const float* ps = st + 3 * u * kSubP;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float pv[kRP];
#pragma unroll
            for (int j = 0; j < kRP; ++j) pv[j] = ps[3 * (lane + 32 * j) + c];
            add_axis<kFma>(acc, q3[c], pv, c, 3, win);
          }
          test_append<kFma>(acc, L, k, thi, gcur, row0 + u * kSubP, end, qb);
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[r]);
  }
  if (active) {
    for (int i = 0; i < kRQ; ++i) select_query(L, qb + i, k);
    if (a.counts != nullptr && lane == 0) {
      atomicAdd(a.counts, static_cast<unsigned long long>(stages) - computed);
      atomicAdd(a.counts + 1, static_cast<unsigned long long>(stages));
    }
  }
  write_lists(L, a.pd, a.pi, (tile * a.S + s) * tq * static_cast<long long>(k), qb, k,
              k <= kSmemK, active);
}

int prepare3(int W, int k, size_t* smem) {
  *smem = smem3_bytes(W, k);
  if (*smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      knn_scan3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem)));
}

int launch3(Knn3Args a, cudaStream_t st) {
  size_t smem = 0;
  const int e = prepare3(a.W, a.k, &smem);
  if (e != 0) return e;
  knn_boxes_kernel<<<dim3(static_cast<unsigned>(a.G), static_cast<unsigned>(a.S)), kTileThreads,
                     0, st>>>(a);
  const int e1 = static_cast<int>(cudaGetLastError());
  if (e1 != 0) return e1;
  const long long tq = static_cast<long long>(kRQ) * a.W;
  const dim3 grid(static_cast<unsigned>((a.Q + tq - 1) / tq), static_cast<unsigned>(a.S));
  knn_scan3_kernel<<<grid, 32 * (a.W + 1), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int slots3(int W, int k) {
  size_t smem = 0;
  int e = prepare3(W, k, &smem);
  if (e != 0) return -e;
  int n = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, knn_scan3_kernel,
                                                                     32 * (W + 1), smem));
  return e != 0 ? -e : n;
}

}  // namespace

// The query rows a block takes for Q queries of D axes (its tile: the
// partials' third extent): 8 a query warp at D = 3, else 64.
extern "C" int knn_scan_tile(int D, long long Q) { return D == 3 ? kRQ * warps3(Q) : kTQ; }

// Stages of the longest chunk when N points go into S chunks: the D = 3
// kernel's box table has S of these rows.
extern "C" int knn_scan_box_stages(long long N, int S) {
  return static_cast<int>((N - (S - 1) * (N / S) + kStage3 - 1) / kStage3);
}

// Rows a stage of the D = 3 kernel (its cull's granularity).
extern "C" int knn_scan_stage() { return kStage3; }

// Blocks of the kernel for D axes, k and Q queries that one SM holds at
// once (for the caller's choice of S), or minus a CUDA error.
extern "C" int knn_scan_slots(int D, int k, long long Q) {
  if (D == 3) return slots3(warps3(Q), k);
  if (D <= 32) return slots<kFma>(D, k);
  return D <= 32 * 32 ? slots<kWin>(D, k) : slots<kWin2>(D, k);
}

// queries f32[Q, D], points f32[N, D] -> pd f32[T, S, TQ, k], pi i32[T, S,
// TQ, k] with TQ = knn_scan_tile(D, Q), T = ceil(Q / TQ): chunk s's k
// smallest (d2, index) per query row, ascending, (+inf, -1) past the
// chunk's list (rows past Q repeat query Q - 1). Contiguous device memory,
// 4-byte aligned; at D = 3 (ignored at other D), gthr u32[T TQ] all ones (the
// chunks' shared thresholds), boxes f32[S, knn_scan_box_stages(N, S), 8]
// (scratch: the stages' boxes), and counts null or u64[2] to which the
// culled and the examined (warp, stage) pairs are added. 1 <= k, S <=
// 65,535, every chunk (floor(N / S) points, the last to N) at least k
// points, N < 2^31. Returns the launches' CUDA error (0 = cudaSuccess;
// nothing is launched when Q is 0).
extern "C" int knn_scan_launch(const void* queries, const void* points, void* pd, void* pi,
                               void* gthr, void* boxes, void* counts, long long Q, long long N,
                               int D, int k, int S, void* stream) {
  if (Q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    Knn3Args a;
    a.q = static_cast<const float*>(queries);
    a.p = static_cast<const float*>(points);
    a.pd = static_cast<float*>(pd);
    a.pi = static_cast<int*>(pi);
    a.gthr = static_cast<unsigned*>(gthr);
    a.counts = static_cast<unsigned long long*>(counts);
    a.boxes = static_cast<float*>(boxes);
    a.Q = Q;
    a.N = N;
    a.chunk = N / S;
    a.k = k;
    a.S = S;
    a.W = warps3(Q);
    a.G = static_cast<int>((N - (S - 1) * a.chunk + kStage3 - 1) / kStage3);
    return launch3(a, st);
  }
  KnnArgs a;
  a.q = static_cast<const float*>(queries);
  a.p = static_cast<const float*>(points);
  a.pd = static_cast<float*>(pd);
  a.pi = static_cast<int*>(pi);
  a.Q = Q;
  a.N = N;
  a.chunk = N / S;
  a.D = D;
  a.k = k;
  a.S = S;
  if (D <= 32) return launch<kFma>(a, st);
  return D <= 32 * 32 ? launch<kWin>(a, st) : launch<kWin2>(a, st);
}
