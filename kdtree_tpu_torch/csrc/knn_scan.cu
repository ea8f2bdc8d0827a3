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
// k-th (7 instructions at D = 3, 2 D + 1 at D axes, 3 D flops); the points,
// read once, are a small fraction of that (the fallback's 1,000 x 2^24 x
// 3-D: 1.2e11 instructions, ~3.5 ms on 132 SMs, against 0.06 ms for the
// points) unless a batch is small (the CLI's 10 rows over 2^24 x 8-D are
// bound by the points' bytes) or most of the points can be skipped. Where
// they are skipped, the k-best bookkeeping of the pairs near each query is
// what is left; and because every chunk keeps its own k best, each (query,
// chunk) list admits about k (1 + ln(chunk / k)) keys, which at k = 16 on
// small chunks costs more than the distances (hence admit's and the
// select's shapes below).
//
// One design at every D, in two kernels: knn_scan3_kernel at D = 3, the
// serving storage's width, with the axes unrolled and the queries in
// registers; knn_scan_kernel at every other D, with the axis count a
// runtime value (templates: the FMA chain or windows, and how a stage is
// read); both after knn_boxes_kernel when they cull. knn_scan_kernel run at
// D = 3 instead (1,024-row stages, the same table) was slower at every
// shape measured, in a CUDA graph on an H100 80GB HBM3 at 700 W: 9.40
// against 7.07-7.11 ms for 1,000 rows over 2^24 points in random order,
// 0.58 against 0.48 ms for 8 rows, 3.38-3.39 against 2.77-2.80 ms for 1,000
// rows in Morton order (its queries in shared memory, its runtime axis
// loop and its first-tile bound), so D = 3 keeps its own kernel. They keep
// the k best per query the same way:
// - The grid is (query tile) x (S point chunks, each an ascending index
//   range). A thread holds an 8 x 4 register tile of d2, 8 queries of its
//   warp against 4 points (pair_tile.cuh), and compares each pair's
//   distance bits with its query's running k-th (one compare rejects almost
//   every pair; the warp votes once a tile of 128 points). The rest go out
//   of line (admit): each lane's pairs that pass, as keys (d2 bits << 32 |
//   index) below the full threshold key, into the query's buffer of kCap
//   keys in shared memory at slots the lane takes by a shared-memory
//   atomicAdd. At k = 1 the list is one key, lowered by a warp reduction.
//   At D != 3, at the warp's first tile of its chunk, a bound on each
//   query's k-th, the k-th smallest of the lanes' least distances in the
//   tile, lowers its threshold first (first_bounds), so the tile does not
//   send all its keys to the buffer while the list is short (the D = 3
//   kernel's chunks are long, and its distance loop keeps its registers).
// - A query's keys come only from its own warp, so each warp selects for
//   its queries alone, with no block barrier: when the buffer overflows,
//   and at the end of the chunk. Up to k = 32 a select holds the list a key
//   a lane, sorts each 32 keys of the buffer descending across the warp
//   (bitonic) and keeps the lanes' minima, a bitonic sequence of the 32
//   smallest of both, sorted by a bitonic merge; longer lists sort the
//   buffer (kPer keys a lane) and merge it into the sorted k-list by ranks
//   (each key's new place is its rank in its own list plus its rank in the
//   other, by binary search), cut at k. The k-th key is the new threshold.
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
// The design for Hopper, at every D:
// 1. A layout for small batches. A block is one producer warp and W query
//    warps of 8 queries each, W <= 7 (eight warps, two blocks an SM at 128
//    registers), the ceil(Q / 8) warps shared out evenly over as few tiles
//    as hold them: an 8-row batch is one query warp, not 64 rows, 64 rows
//    two tiles of 4 warps, and the plan fills the wave with point chunks
//    instead (kernels/knn_scan.py::plan_splits). The block's queries are
//    staged once, by axis; a query warp keeps its 8 in registers at D = 3
//    and reads an axis's 8 as two 16-byte broadcasts elsewhere.
// 2. An exact cull on the box of each stage (1,024 rows at D = 3, about
//    kStageBytes of rows elsewhere, whole tiles of 128). knn_boxes_kernel
//    first takes every chunk's stages' boxes into a table (each stage
//    staged in shared memory by a bulk copy and min/max-reduced there; a
//    row whose first coordinate is +inf, a pad or masked row, is left out
//    of hi). A query's bound to a box is its squared distance to it in d2's
//    arithmetic at that D: per axis the gap lo - q or q - hi (__fsub_rn), 0
//    inside, folded by the FMA chain up to 32 axes, as rounded squares
//    summed in windows of 32 above (d2.cuh::box_bound, query_bounds2; the
//    plain mirror is ops/_arith.py::sq_dist_to_box). A stage is skipped for
//    a query when the bound's bits are strictly above its threshold: the
//    smaller of its chunk list's k-th and a per-query word in device memory
//    that every chunk lowers (atomicMin) to its k-th's distance bits
//    whenever its list is full (a select). Exact:
//    - A row inside the box has lo <= p <= hi on every axis, so |fl(q - p)|
//      >= the gap (rounding is monotone and symmetric). fma(x, x, acc) is
//      monotone in x >= 0 and acc >= 0, and so are fl(x * x) and a sum of
//      non-negative rounded terms in each term, so each window's sum and
//      the sum of the windows' sums are too: its d2 bits are >= the
//      bound's, in either arithmetic.
//    - A row left out of hi has d2 = +inf or NaN (an infinite coordinate),
//      bits >= +inf's >= any bound's; fminf and fmaxf pass over NaN
//      coordinates, whose d2 is NaN the same way.
//    - Any chunk's k-th is >= the whole answer's k-th, so a row whose d2 is
//      strictly above it is in no answer; a tie at the threshold is not
//      skipped (the lower index may win it). A chunk's list may then hold
//      fewer than k rows; it is padded with (+inf, -1), which the merge
//      handles, and every row of the answer is still in its chunk's list.
//    - first_bounds' word is the k-th smallest of k distinct rows' d2 bits,
//      so the chunk's k-th, and the answer's, are at or below it: it joins
//      the shared word and the argument above holds for it too.
//    - A test made with older thresholds is as exact: the thresholds only
//      fall, so a bound strictly above an older one is above the current.
//    The same threshold tightens the per-pair compare. On points in random
//    order a stage's box spans the domain and nothing is skipped; on the
//    serving callers' Morton-ordered storage a stage is a few neighbouring
//    buckets and almost every stage is. At D != 3 a call whose queries fit
//    one tile builds no table and culls nothing (culls): the table reads
//    every point once more and its kernel is launched over every stage,
//    which a tile of queries does not pay back unless the points are in
//    spatial order, and the kernel cannot tell. Measured with the table at
//    every Q (same card and setting, a CUDA graph): 8 rows over 2^19 x 8-D
//    bucket storage in Morton order 0.085 against 0.097-0.100 ms (0.09 of
//    the (warp, stage) pairs culled), but the same 8 rows in random order
//    0.131-0.132 against 0.111, and the CLI's 10 random rows over 2^24
//    points 0.98-0.99 against 0.389 ms at 8 axes, 2.12-2.13 against 0.700
//    at 16.
// 3. A TMA ring with no block barrier a stage, only for stages some query
//    needs. The producer warp walks the chunk's stages, tests each box
//    against all the block's queries (a lane holds two) and publishes only
//    a stage some query may need, with its index in the slot's header and,
//    at D != 3, the mask of the queries that may need it (so a query warp
//    never bounds a box itself); its rows come with one 1-D bulk copy (cp.async.bulk) of the
//    16-byte-aligned span around them (a few bytes of the neighbouring
//    rows, inside the tensor; only the tensor's own first and last bytes
//    outside it come by plain loads), so any chunk start and any
//    4-byte-aligned base work. A slot has a "full" barrier and an "empty"
//    one (an arrival a query warp); a stage index of -1 ends the chunk.
//    Query warps wait on full, test their own queries (the mask's 8 bits at
//    D != 3), compute or skip, and arrive on empty: the loop has no
//    __syncthreads, a stage no query needs
//    is never copied in, and the warps' slack in the ring is counted in
//    needed stages only. Every stage the producer also copies the block's
//    shared thresholds into shared memory, where the query warps read them,
//    by asynchronous copies it never waits for.
// 4. Reads of a stage without bank conflicts. A lane reads axis c of its 4
//    points, rows lane + 32 j, so in a row-major stage a warp's 32 words
//    are D words apart: 32 banks at odd D (D = 3 and knn_scan_kernel<.,
//    false>, the ring slot read as it lands), but a 2^a-way conflict where
//    2^a divides D (8-way at D = 8, 32-way at D = 32). At even D the
//    producer lands each stage by bulk copy in one of L landing slots (up
//    to L copies in flight, issued as soon as a slot frees) and transposes
//    it into the ring slot [D][ld] itself (transpose_rows4: 16 neighbouring
//    bytes read a lane, axes c .. c + 3 of a row, where D % 4 == 0 and the
//    rows are 16-byte aligned; else transpose_rows, a word a lane; each
//    word written to axis c, row r, ld's residue mod 32 picked so that
//    those writes meet at most 2 to a bank), so the query warps read 32
//    neighbouring words an axis. Done once a stage by the warp that is
//    otherwise idle, not by each query warp, it costs the query warps
//    nothing but a share of the shared-memory bandwidth (two accesses a
//    word against the W query warps' W reads), and it needs no barrier
//    among them. Measured on an H100 80GB HBM3 at 700 W, the k-best
//    bookkeeping switched off: reading the row-major stage as it lands
//    instead took 1.17 against 0.86 ms for 10 rows over 2^24 x 16-D and
//    2.65 against 0.99 ms for 256 rows over 2^19 x 32-D; the word-a-lane
//    transpose left the producer the bottleneck at 8-32 axes (0.44 against
//    0.31 ms for 10 rows over 2^24 x 8-D with no transpose at all), which
//    the 16-byte reads took back to 0.34. A 2-D tensor map could land the
//    stage swizzled only where a row is a multiple of 16 bytes and the base
//    16-byte aligned, and a swizzle of 16-byte chunks still leaves a lane's
//    reads of one axis conflicting at D = 8-32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d2.cuh"
#include "pair_tile.cuh"

namespace {

using namespace kdt;

constexpr int kRQ = 8;                 // queries a thread
constexpr int kRP = 4;                 // points a thread, lane + 32 j
constexpr int kSubP = 32 * kRP;        // points a tile of sums
constexpr int kCap = 64;               // buffered keys a query: 2 a lane in the select
constexpr int kPer = kCap / 32;
constexpr int kSmemK = 64;             // k-lists up to this length in shared memory
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kWarps = 7;  // query warps a block at most: 8 warps, two blocks an SM

constexpr int kStage3 = 1024;  // rows a stage of knn_scan3_kernel
constexpr int kRing3 = 5;      // its ring slots
// a slot: the stage's rows and up to 15 bytes of the 16-byte span on each side
constexpr int kSlot3 = (kStage3 * 12 + 30 + 15) / 16 * 16;
static_assert(kStage3 % kSubP == 0, "a stage is whole tiles of sums");
static_assert(kRing3 >= 2, "a ring of at least two slots");

constexpr int kStageBytes = 8192;     // a stage's rows at D != 3, about (whole tiles, one at least)
constexpr int kMaxDim = 256;          // knn_scan_kernel's axes at most
constexpr int kBoxBatchFloats = 256;  // the box table's floats a batch of the producer's loads
constexpr int kSmemOne = 232448;      // shared memory a block at most
constexpr int kSmemTwo = 233472 / 2 - 1024;  // a block's, two an SM (1 KB reserved a block)

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

// The warp's 32 keys, one a lane, sorted across the lanes by a bitonic
// sort: ascending, or descending with `desc`.
__device__ __forceinline__ unsigned long long warp_sort32(unsigned long long v, int lane,
                                                          bool desc) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = shfl_xor64(v, stride);
      const bool asc = ((lane & size) == 0) != desc;
      v = (((lane & stride) == 0) == asc) ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  return v;
}

// A bitonic sequence of one key a lane, sorted ascending.
__device__ __forceinline__ unsigned long long warp_merge32(unsigned long long v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const unsigned long long o = shfl_xor64(v, stride);
    v = (lane & stride) == 0 ? (o < v ? o : v) : (o > v ? o : v);
  }
  return v;
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
  const int b = L->cnt[q] < kCap ? L->cnt[q] : kCap;  // admit's slots may run past it
  if (b == 0) return;
  unsigned long long* buf = L->buf + static_cast<long long>(q) * kCap;
  float* ld = L->ld + static_cast<long long>(q) * k;
  int* li = L->li + static_cast<long long>(q) * k;
  const int len = L->len[q];
  if (k <= 32) {
    // the list a key a lane; each 32 keys of the buffer sorted descending,
    // then the lanes' minima (a bitonic sequence holding the 32 smallest of
    // both) sorted ascending
    unsigned long long x = lane < len ? list_key(ld, li, lane) : kNoKey;
    for (int h = 0; h < b; h += 32) {
      const unsigned long long y = warp_sort32(h + lane < b ? buf[h + lane] : kNoKey, lane, true);
      x = warp_merge32(x < y ? x : y, lane);
    }
    const int nl = len + b < k ? len + b : k;
    if (lane < nl) {
      ld[lane] = __uint_as_float(static_cast<unsigned>(x >> 32));
      li[lane] = static_cast<int>(static_cast<unsigned>(x));
    }
    const unsigned long long t = (static_cast<unsigned long long>(__shfl_sync(
                                      kFull, static_cast<unsigned>(x >> 32), k - 1))
                                  << 32) |
                                 __shfl_sync(kFull, static_cast<unsigned>(x), k - 1);
    __syncwarp();
    if (lane == 0) {
      L->len[q] = nl;
      L->cnt[q] = 0;
      L->thr[q] = nl == k ? t : kNoKey;
      if (L->gthr != nullptr && nl == k) {
        const long long row = L->row0 + q < L->last ? L->row0 + q : L->last;
        atomicMin(L->gthr + row, static_cast<unsigned>(t >> 32));
      }
    }
    __syncwarp();
    return;
  }

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
// chunk's) against the thresholds' bits thi[i]. Each lane appends its own
// pairs that pass, as keys below the query's full threshold key, to the
// query's buffer at slots it takes with a shared-memory atomicAdd (no
// ballot, no pass over the queries); a buffer that overflows selects, and
// the keys that did not fit try again against the new threshold. At k = 1
// the list is its least key, lowered by a warp reduction, with no buffer. A
// query's keys come only from its warp's lanes, so the warp does this
// alone, with no block barrier. Out of line, and with the comparisons made
// again here, so that the distance loop keeps its registers and its
// compare chain.
__device__ __noinline__ void admit(const float* d2, const unsigned* thi, const Lists* L, int k,
                                   long long base, long long end, int qb) {
  const int lane = threadIdx.x & 31;
  // the lane's candidates: bit i kRP + j, pair (query qb + i, point base +
  // lane + 32 j) at or below the query's threshold bits, in the chunk
  unsigned cand = 0;
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int j = 0; j < kRP; ++j) {
      const bool in = base + lane + 32 * j < end;
      cand |= static_cast<unsigned>(in && __float_as_uint(d2[i * kRP + j]) <= thi[i])
              << (i * kRP + j);
    }
  }
  if (k == 1) {
    // the list is its least key: the tile's least key below it, by a warp
    // reduction, with no buffer and no select
    unsigned near = 0;
#pragma unroll
    for (int i = 0; i < kRQ; ++i) near |= static_cast<unsigned>((cand >> (i * kRP) & 0xfu) != 0) << i;
    near = __reduce_or_sync(kFull, near);
#pragma unroll 1
    for (int i = 0; i < kRQ; ++i) {
      if (!(near >> i & 1)) continue;
      const int q = qb + i;
      unsigned long long m = kNoKey;
#pragma unroll
      for (int j = 0; j < kRP; ++j) {
        const unsigned long long key =
            make_key(d2[i * kRP + j], static_cast<unsigned>(base + lane + 32 * j));
        if ((cand >> (i * kRP + j) & 1) && key < m) m = key;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long x = shfl_xor64(m, o);
        m = x < m ? x : m;
      }
      if (lane == 0 && m < L->thr[q]) {
        L->ld[q] = __uint_as_float(static_cast<unsigned>(m >> 32));
        L->li[q] = static_cast<int>(static_cast<unsigned>(m));
        L->len[q] = 1;
        L->thr[q] = m;
        if (L->gthr != nullptr) {
          const long long row = L->row0 + q < L->last ? L->row0 + q : L->last;
          atomicMin(L->gthr + row, static_cast<unsigned>(m >> 32));
        }
      }
    }
    __syncwarp();
    return;
  }
  // each lane appends its candidates below the full threshold key to the
  // query's buffer at slots it takes by a shared-memory atomic; a query
  // whose buffer overflowed selects, and the keys that did not fit are
  // tried again against the new threshold
  for (;;) {
    unsigned over = 0, left = 0;
    for (unsigned c = cand; c != 0; c &= c - 1) {
      const int e = __ffs(c) - 1;
      const int q = qb + e / kRP;
      const unsigned long long key =
          make_key(d2[e], static_cast<unsigned>(base + lane + 32 * (e % kRP)));
      if (key < L->thr[q]) {
        const int slot = atomicAdd(L->cnt + q, 1);
        if (slot < kCap) {
          L->buf[static_cast<long long>(q) * kCap + slot] = key;
        } else {
          over |= 1u << (e / kRP);
          left |= 1u << e;
        }
      }
    }
    over = __reduce_or_sync(kFull, over);
    if (over == 0) break;
    __syncwarp();
    for (unsigned o = over; o != 0; o &= o - 1) select_query(L, qb + __ffs(o) - 1, k);
    cand = left;
  }
  __syncwarp();
}

// At the first tile a warp computes in its chunk (k <= 32): for each query,
// a bound on the chunk's k-th, the k-th smallest of the lanes' least
// distance bits in the tile (k rows of the chunk lie at or below it), into
// t0[i], and lowered into the query's shared threshold. So the tile does
// not send every key to the buffer while the list is still short. Eight
// bitonic sorts across the warp, one value a lane each; out of line.
__device__ __noinline__ void first_bounds(const float* d2, unsigned* t0, const Lists* L, int k,
                                          long long base, long long end, int qb) {
  const int lane = threadIdx.x & 31;
  unsigned v[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    v[i] = kFull;
#pragma unroll
    for (int j = 0; j < kRP; ++j) {
      const unsigned b = __float_as_uint(d2[i * kRP + j]);
      if (base + lane + 32 * j < end && b < v[i]) v[i] = b;
    }
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_small = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const unsigned o = __shfl_xor_sync(kFull, v[i], stride);
        v[i] = keep_small ? (o < v[i] ? o : v[i]) : (o > v[i] ? o : v[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRQ; ++i) t0[i] = __shfl_sync(kFull, v[i], k - 1);
  if (lane < kRQ && L->gthr != nullptr && t0[lane] != kFull) {
    const long long row = L->row0 + qb + lane < L->last ? L->row0 + qb + lane : L->last;
    atomicMin(L->gthr + row, t0[lane]);
  }
}

// The tile's pairs (points base + lane + 32 j) against thi[i], query qb +
// i's threshold bits: one vote rejects almost every tile, and admit takes
// the rest to the lists; points at or past `end` are not the chunk's. Lane
// i < 8 of `gq` holds the shared threshold of query qb + i (all ones when
// there is none), which bounds thi again after that; at the warp's `first`
// tile of the chunk first_bounds bounds it first.
template <int MODE>
__device__ __forceinline__ void test_append(const Sums<kRQ, kRP>& acc, const Lists* L, int k,
                                            unsigned (&thi)[kRQ], unsigned gq, long long base,
                                            long long end, int qb, bool first) {
  if (first && k <= 32) {
    float d2[kRQ * kRP];
    unsigned t0[kRQ];
#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
#pragma unroll
      for (int j = 0; j < kRP; ++j) d2[i * kRP + j] = acc.template result<MODE>(i, j);
    }
    first_bounds(d2, t0, L, k, base, end, qb);
#pragma unroll
    for (int i = 0; i < kRQ; ++i) thi[i] = thi[i] < t0[i] ? thi[i] : t0[i];
  }
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
    const unsigned t = own < g ? own : g;
    thi[i] = t < thi[i] ? t : thi[i];
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

// Query warps a block for Q queries: ceil(Q / 8) warps of 8 rows in as few
// blocks of at most kWarps as hold them, shared out evenly.
__host__ __device__ inline int query_warps(long long Q) {
  const long long w = (Q + 7) / 8, t = (w + kWarps - 1) / kWarps;
  return static_cast<int>((w + t - 1) / t);
}

__host__ __device__ inline int up16(long long x) { return static_cast<int>((x + 15) & ~15LL); }

// Copies rows [row0, row0 + n) of the [N, rb / 4] points at pbase into
// slot, one thread: slot byte 0 is the 16-byte boundary at or below the
// rows' first byte. One bulk copy of the 16-byte-aligned span around the
// rows (a few bytes of the neighbouring rows, inside the tensor) completes
// on bar; the tensor's own first or last bytes, where the span would leave
// it, come by plain loads first.
__device__ __forceinline__ void copy_rows(unsigned char* slot, uintptr_t pbase, long long N,
                                          int rb, long long row0, long long n, uint64_t* bar) {
  const uintptr_t b0 = pbase + static_cast<uintptr_t>(rb) * static_cast<uintptr_t>(row0);
  const uintptr_t b1 = b0 + static_cast<uintptr_t>(rb) * static_cast<uintptr_t>(n);
  const uintptr_t base16 = b0 & ~static_cast<uintptr_t>(15);
  const uintptr_t lo16 = base16 >= pbase ? base16 : base16 + 16;
  uintptr_t hi16 = (b1 + 15) & ~static_cast<uintptr_t>(15);
  if (hi16 > pbase + static_cast<uintptr_t>(rb) * static_cast<uintptr_t>(N)) hi16 -= 16;
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

// ---- the box table: every chunk's stages' boxes --------------------------

struct BoxArgs {
  const float* p;   // [N, D], 4-byte aligned
  float* boxes;     // [S, G, 2, Dp]: lo[Dp], hi[Dp] a stage (axes past D unused)
  long long N, chunk;
  int D, Dp, S, G, rows, slot_bytes;  // rows a stage; the staged rows' bytes
};

constexpr int kBoxAxes = 8;  // axis chunks of 32 a lane holds in knn_boxes_kernel (D <= 256)

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

// The boxes of every chunk's stages, [S, G, 2, Dp]: block (g, s) reduces
// stage g of chunk s, its rows staged in shared memory by one bulk copy of
// their 16-byte-aligned span (the tensor's own first and last bytes outside
// it by plain loads), as the scan kernels stage them. DC = 3: a thread
// takes whole rows; DC = 0 (any D): a lane takes one axis, of a row of
// 32 / D rows a warp reads at once up to 32 axes (contiguous words), of
// axes lane, lane + 32, .. of one row above; the lanes of one axis, then
// the warps, are reduced.
template <int DC>
__global__ void __launch_bounds__(kTileThreads) knn_boxes_kernel(const BoxArgs a) {
  const int g = blockIdx.x, s = blockIdx.y;
  const long long start = s * a.chunk;
  const long long end = s == a.S - 1 ? a.N : start + a.chunk;
  const long long row0 = start + static_cast<long long>(g) * a.rows;
  if (row0 >= end) return;
  const int n = static_cast<int>(end - row0 < a.rows ? end - row0 : a.rows);
  const uintptr_t pbase = reinterpret_cast<uintptr_t>(a.p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);
  if constexpr (DC == 3) {
    __shared__ __align__(16) unsigned char slot[kSlot3];
    __shared__ __align__(8) uint64_t bar;
    __shared__ float part[kTileWarps][8];
    if (tid == 0) {
      sm90::mbar_init(&bar, 1);
      sm90::fence_mbar_init();
      copy_rows(slot, pbase, a.N, 12, row0, n, &bar);
    }
    __syncthreads();
    sm90::mbar_wait(&bar, 0);
    const float* st = reinterpret_cast<const float*>(slot + ((pbase + 12 * row0) & 15));
    float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
    for (int i = tid; i < n; i += kTileThreads) {
      box_row(lo, hi, st[3 * i], st[3 * i + 1], st[3 * i + 2]);
    }
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
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int D = a.D, Dp = a.Dp;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + a.slot_bytes);
    float* part = reinterpret_cast<float*>(smem_raw + a.slot_bytes + 16);  // [8][2][Dp]
    if (tid == 0) {
      sm90::mbar_init(bar, 1);
      sm90::fence_mbar_init();
      copy_rows(smem_raw, pbase, a.N, 4 * D, row0, n, bar);
    }
    __syncthreads();
    sm90::mbar_wait(bar, 0);
    const float* st = reinterpret_cast<const float*>(
        smem_raw + ((pbase + static_cast<uintptr_t>(4 * D) * row0) & 15));
    const float nan = __int_as_float(0x7fffffff);
    const int per = D <= 32 ? 32 / D : 1;  // rows a warp reads at once
    const int ri = D <= 32 ? lane / D : 0;
    const int c0 = D <= 32 ? lane - ri * D : lane;
    const bool on = ri < per;
    float lo[kBoxAxes], hi[kBoxAxes];
#pragma unroll
    for (int h = 0; h < kBoxAxes; ++h) {
      lo[h] = inf;
      hi[h] = -inf;
    }
    for (int r = warp * per + ri; r < n + ri; r += kTileWarps * per) {
      if (on && r < n) {
        const float* row = st + static_cast<long long>(r) * D;
        const bool pad = row[0] == inf;
#pragma unroll
        for (int h = 0; h < kBoxAxes; ++h) {
          const int c = c0 + 32 * h;
          if (c < D) {
            const float x = row[c];
            lo[h] = fminf(lo[h], x);
            hi[h] = fmaxf(hi[h], pad ? nan : x);
          }
        }
      }
    }
    // lanes l, l + D, l + 2 D, .. hold one axis: their minimum and maximum
    // into lane l
    for (int m = D; m < 32 && per > 1; m <<= 1) {
      lo[0] = fminf(lo[0], __shfl_down_sync(kFull, lo[0], m));
      hi[0] = fmaxf(hi[0], __shfl_down_sync(kFull, hi[0], m));
    }
    if (D > 32 || lane < D) {
#pragma unroll
      for (int h = 0; h < kBoxAxes; ++h) {
        const int c = c0 + 32 * h;
        if (c < D) {
          part[warp * 2 * Dp + c] = lo[h];
          part[warp * 2 * Dp + Dp + c] = hi[h];
        }
      }
    }
    __syncthreads();
    float* out = a.boxes + (static_cast<long long>(s) * a.G + g) * 2 * Dp;
    for (int t = tid; t < 2 * Dp; t += kTileThreads) {
      const bool low = t < Dp;
      const int c = low ? t : t - Dp;
      float v = 0.f;
      if (c < D) {
        v = part[t];
        for (int w = 1; w < kTileWarps; ++w) {
          v = low ? fminf(v, part[w * 2 * Dp + t]) : fmaxf(v, part[w * 2 * Dp + t]);
        }
      }
      out[t] = v;
    }
  }
}

// Bytes of dynamic shared memory knn_boxes_kernel<0> takes.
inline int box_smem(int slot_bytes, int Dp) { return slot_bytes + 16 + 4 * kTileWarps * 2 * Dp; }

// ---- knn_scan_kernel: every D but 3 (the design note at the top) --------

struct KnnArgs {
  const float* q;               // [Q, D]
  const float* p;               // [N, D], 4-byte aligned
  float* pd;                    // [T, S, 8 W, k]
  int* pi;                      // [T, S, 8 W, k]
  unsigned* gthr;               // [T tq]: the shared thresholds' bits, all ones at the start
  unsigned long long* counts;   // null, or [2]: culled and all (warp, stage) pairs
  const float* boxes;           // null (no cull), or [S, G, 2, Dp] (knn_boxes_kernel)
  long long Q, N, chunk;
  int D, Dp, k, S, W, G;        // Dp = D rounded up to 4; G stages a chunk at most
  int rows, ld, L, R, nb;       // rows a stage; a transposed slot's stride; landing and
                                // ring slots; boxes a batch of the producer's box loads
  int slot_bytes, ring_bytes;   // a landing (or, at odd D, ring) slot; a ring slot
};

// Byte offsets of knn_scan_kernel's shared memory (the ring at 0), all
// 16-byte aligned, and its total.
struct Carve {
  int land, hdr, bbuf, sq, sg, bars, idx, lists, total;
};

__host__ __device__ inline Carve carve(const KnnArgs& a) {
  const int tq = kRQ * a.W, ldq = tq + 4, Dp = a.Dp;
  Carve c;
  int o = a.R * a.ring_bytes;
  c.land = o;
  o += a.L * a.slot_bytes;
  c.hdr = o;  // each ring and landing slot's query mask (two words)
  o += up16(8LL * (a.R + a.L));
  c.bbuf = o;  // two batches of the box table
  o += 16 * a.nb * Dp;
  c.sq = o;  // the block's queries by axis
  o += 4 * a.D * ldq;
  c.sg = o;  // the shared thresholds' copy
  o += 4 * ldq;
  c.bars = o;  // full[R], empty[R], landed[L]
  o += up16(8LL * (2 * a.R + a.L));
  c.idx = o;  // each ring and landing slot's stage
  o += up16(4LL * (a.R + a.L));
  c.lists = o;  // buffers, thresholds, counts, lengths, the k-lists up to kSmemK
  o += 8 * tq * (kCap + 1) + 8 * tq;
  if (a.k <= kSmemK) o += 8 * tq * a.k;
  c.total = o;
  return c;
}

// The bounds of queries i0 and i1, their values at sq[d * ldq + i], to the
// box [lo, hi]: the per-axis gaps in d2's arithmetic at this D, as
// d2.cuh::box_bound folds them (the FMA chain, or the rounded squares in
// windows of 32: kMaxDim keeps to one level of windows), both queries in
// one pass over the axes.
template <int MODE>
__device__ __forceinline__ void query_bounds2(const float* sq, int ldq, int i0, int i1,
                                              const float* lo, const float* hi, int D,
                                              float& b0, float& b1) {
  float a0 = 0.f, a1 = 0.f;
  if (MODE == kFma) {
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float g0 = box_gap(sq[d * ldq + i0], lo[d], hi[d]);
      const float g1 = box_gap(sq[d * ldq + i1], lo[d], hi[d]);
      a0 = __fmaf_rn(g0, g0, a0);
      a1 = __fmaf_rn(g1, g1, a1);
    }
  } else {
    const Windows w(D);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float g0 = box_gap(sq[d * ldq + i0], lo[d], hi[d]);
      const float g1 = box_gap(sq[d * ldq + i1], lo[d], hi[d]);
      s0 = __fadd_rn(s0, __fmul_rn(g0, g0));
      s1 = __fadd_rn(s1, __fmul_rn(g1, g1));
      if (((d + w.f1) & 31) == 31 || d == D - 1) {
        a0 = __fadd_rn(a0, s0);
        a1 = __fadd_rn(a1, s1);
        s0 = s1 = 0.f;
      }
    }
  }
  b0 = a0;
  b1 = a1;
}

// The landed rows [n, D] at src (row-major) into dst[c * ld + r], one warp:
// a lane reads every 32nd word (neighbouring words, no bank conflict), kU
// of them before it writes any (the reads then overlap), and writes each
// transposed; ld's residue mod 32 (slot_stride) keeps the writes' conflicts
// few.
__device__ __forceinline__ void transpose_rows(float* dst, int ld, const float* src, int n,
                                               int D, int lane) {
  constexpr int kU = 8;
  const int E = n * D;
  const int dr = 32 / D, dc = 32 - dr * D;
  int r = lane / D, c = lane - r * D;
  for (int w0 = lane; w0 < E; w0 += 32 * kU) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) v[u] = w0 + 32 * u < E ? src[w0 + 32 * u] : 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (w0 + 32 * u < E) dst[c * ld + r] = v[u];
      r += dr;
      c += dc;
      if (c >= D) {
        c -= D;
        ++r;
      }
    }
  }
}

// transpose_rows with 16-byte reads, where D % 4 == 0 and src is 16-byte
// aligned: a lane reads axes c .. c + 3 of row r at once (neighbouring 16
// bytes, no bank conflict) and writes them to dst[(c + i) * ld + r];
// slot_stride picks ld for this pattern at such D.
__device__ __forceinline__ void transpose_rows4(float* dst, int ld, const float* src, int n,
                                                int D, int lane) {
  constexpr int kU = 4;
  const int E = n * D / 4;
  const int dr = 128 / D, dc = 128 - dr * D;
  int r = 4 * lane / D, c = 4 * lane - r * D;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int f0 = lane; f0 < E; f0 += 32 * kU) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (f0 + 32 * u < E) v[u] = s4[f0 + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (f0 + 32 * u < E) {
        float* o = dst + c * ld + r;
        o[0] = v[u].x;
        o[ld] = v[u].y;
        o[2 * ld] = v[u].z;
        o[3 * ld] = v[u].w;
      }
      r += dr;
      c += dc;
      if (c >= D) {
        c -= D;
        ++r;
      }
    }
  }
}

// Every axis of a tile of sums from a transposed slot: point lane + 32 j's
// axis c at st[c * ld + lane + 32 j].
template <int MODE>
__device__ __forceinline__ void slot_sums(Sums<kRQ, kRP>& acc, const float* sq, int ldq,
                                          const float* st, int ld, int qb, int D,
                                          const Windows& win) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int c = 0; c < D; ++c) {
    float qv[kRQ], pv[kRP];
    load_vec(qv, sq + c * ldq + qb);
#pragma unroll
    for (int j = 0; j < kRP; ++j) pv[j] = st[c * ld + lane + 32 * j];
    add_axis<MODE>(acc, qv, pv, c, D, win);
  }
}

// Every axis of a tile of sums from row-major rows (odd D: the word stride
// D of a lane's rows is odd, so a warp's reads of one axis hit 32 banks):
// point lane + 32 j at st[(lane + 32 j) D + c].
template <int MODE>
__device__ __forceinline__ void direct_sums(Sums<kRQ, kRP>& acc, const float* sq, int ldq,
                                            const float* st, int qb, int D, const Windows& win) {
  const int lane = threadIdx.x & 31;
  const float* pr = st + lane * D;
  const int js = 32 * D;
#pragma unroll 1
  for (int c = 0; c < D; ++c) {
    float qv[kRQ], pv[kRP];
    load_vec(qv, sq + c * ldq + qb);
#pragma unroll
    for (int j = 0; j < kRP; ++j) pv[j] = pr[j * js + c];
    add_axis<MODE>(acc, qv, pv, c, D, win);
  }
}

// TR: even D, each stage landed row-major and transposed by the producer
// into a ring slot [D][ld]; else (odd D) each stage lands by bulk copy in
// its ring slot and is read row-major.
template <int MODE, bool TR>
__global__ void __launch_bounds__(32 * (kWarps + 1), 2) knn_scan_kernel(const KnnArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int D = a.D, Dp = a.Dp, W = a.W, R = a.R, k = a.k, rows = a.rows;
  const int tq = kRQ * W;
  const int ldq = tq + 4;  // staged query stride (16-byte rows)
  const Carve cv = carve(a);
  unsigned char* ring = smem_raw;
  unsigned char* land = smem_raw + cv.land;
  unsigned* hmask = reinterpret_cast<unsigned*>(smem_raw + cv.hdr);  // [R][2]
  unsigned* lmask = hmask + 2 * R;                                      // [L][2]
  float* bbuf = reinterpret_cast<float*>(smem_raw + cv.bbuf);   // [2][nb][2][Dp]
  float* sq = reinterpret_cast<float*>(smem_raw + cv.sq);       // [D][ldq]
  unsigned* sg = reinterpret_cast<unsigned*>(smem_raw + cv.sg); // [ldq]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + cv.bars);
  uint64_t* empty = full + R;
  uint64_t* landed = empty + R;
  int* sstage = reinterpret_cast<int*>(smem_raw + cv.idx);      // [R]
  int* lstage = sstage + R;                                      // [L]
  __shared__ Lists lists;
  const long long tile = blockIdx.x;
  const int s = blockIdx.y;
  const long long q0 = tile * tq;
  const long long start = s * a.chunk;
  const long long end = s == a.S - 1 ? a.N : start + a.chunk;
  const int stages = static_cast<int>((end - start + rows - 1) / rows);
  const uintptr_t pbase = reinterpret_cast<uintptr_t>(a.p);
  const int rb = 4 * D;  // bytes a row
  const bool cull = a.boxes != nullptr;

  if (tid == 0) {
    Lists Lb;
    unsigned char* p = smem_raw + cv.lists;
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
      sm90::mbar_init(&full[r], 32);
      sm90::mbar_init(&empty[r], W);
    }
    for (int l = 0; l < a.L; ++l) sm90::mbar_init(&landed[l], 1);
    sm90::fence_mbar_init();
  }
  // the block's queries by axis, once (rows past Q repeat the last)
  for (int e = tid; e < tq * D; e += blockDim.x) {
    const int i = e / D, c = e - i * D;
    const long long row = q0 + i < a.Q ? q0 + i : a.Q - 1;
    sq[c * ldq + i] = a.q[row * D + c];
  }
  for (int i = tid; i < tq; i += blockDim.x) sg[i] = 0xffffffffu;
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
    // The producer (the note at the top). Stage g's box comes from the
    // table in batches of nb, double-buffered by cp.async; the block's
    // shared thresholds are copied into sg every stage, never waited for
    // (any value there is some chunk's k-th, or all ones).
    const float* table = cull ? a.boxes + static_cast<long long>(s) * a.G * 2 * Dp : nullptr;
    const unsigned* thr_hi = reinterpret_cast<const unsigned*>(L->thr) + 1;  // d2 bits
    const int bfl = 2 * a.nb * Dp;  // floats a batch
    auto load_batch = [&](int b) {
      const int g0 = b * a.nb;
      if (g0 < stages) {
        const int cnt = stages - g0 < a.nb ? stages - g0 : a.nb;
        const float4* src = reinterpret_cast<const float4*>(table + 2LL * g0 * Dp);
        float4* dst = reinterpret_cast<float4*>(bbuf + (b & 1) * bfl);
        for (int i = lane; i < cnt * Dp / 2; i += 32) sm90::cp_async16_cg(dst + i, src + i);
      }
      sm90::cp_async_commit();
    };
    auto box_of = [&](int g) { return bbuf + ((g / a.nb) & 1) * bfl + (g % a.nb) * 2 * Dp; };
    if (cull) load_batch(0);
    // which queries of the block may need stage g, as two masks (bit i of
    // word w: query 32 w + i): their bound to the box at or below the
    // smaller of the chunk list's k-th and the shared threshold (lane l
    // holds queries l and l + 32; rows past Q need none); all ones when the
    // call does not cull
    unsigned m0 = kFull, m1 = kFull;
    auto needed = [&](int g) -> bool {
      if (4 * lane < tq) sm90::cp_async16_cg(sg + 4 * lane, a.gthr + q0 + 4 * lane);
      if (!cull) return true;
      if (g % a.nb == 0) {  // batch g / nb landed, the next one on its way
        __syncwarp();  // every lane done with the buffer the next batch takes
        load_batch(g / a.nb + 1);
        sm90::cp_async_wait<1>();
        __syncwarp();
      }
      const float* bx = box_of(g);
      const int i1 = lane + 32 < tq ? lane + 32 : lane;
      float b0, b1;
      query_bounds2<MODE>(sq, ldq, lane, i1, bx, bx + Dp, D, b0, b1);
      const unsigned t0 = thr_hi[2 * lane] < sg[lane] ? thr_hi[2 * lane] : sg[lane];
      const unsigned t1 = thr_hi[2 * i1] < sg[i1] ? thr_hi[2 * i1] : sg[i1];
      m0 = __ballot_sync(kFull, lane < tq && q0 + lane < a.Q && __float_as_uint(b0) <= t0);
      m1 = __ballot_sync(kFull, lane + 32 < tq && q0 + lane + 32 < a.Q &&
                                    __float_as_uint(b1) <= t1);
      return (m0 | m1) != 0;
    };
    int pub = 0;  // stages published into the ring
    // ring slot r frees when every query warp is done with its last stage
    auto ring_wait = [&](int r) {
      if (pub >= R) sm90::mbar_wait(&empty[r], ((pub - R) / R) & 1);
    };
    if constexpr (TR) {
      // a needed stage is copied into the next free landing slot as soon as
      // one frees (up to L in flight), then transposed into the next ring
      // slot in turn
      const int NL = a.L;
      const bool vec = D % 4 == 0 && (pbase & 15) == 0;  // every row 16-byte aligned
      int issued = 0, taken = 0, g = 0;
      for (;;) {
        while (issued - taken < NL && g < stages) {
          const int gg = g++;
          if (!needed(gg)) continue;
          const int li = issued % NL;
          __syncwarp();  // every lane done with landing slot li's last stage
          if (lane == 0) {
            lmask[2 * li] = m0;
            lmask[2 * li + 1] = m1;
            lstage[li] = gg;
            const long long row0 = start + static_cast<long long>(gg) * rows;
            copy_rows(land + li * a.slot_bytes, pbase, a.N, rb, row0,
                      end - row0 < rows ? end - row0 : rows, &landed[li]);
          }
          ++issued;
        }
        if (taken == issued) break;
        __syncwarp();  // the landing slots' stages and boxes written
        const int li = taken % NL;
        sm90::mbar_wait(&landed[li], (taken / NL) & 1);
        const int r = pub % R;
        ring_wait(r);
        const int gs = lstage[li];
        const long long row0 = start + static_cast<long long>(gs) * rows;
        const int n = static_cast<int>(end - row0 < rows ? end - row0 : rows);
        float* dst = reinterpret_cast<float*>(ring + r * a.ring_bytes);
        const float* src = reinterpret_cast<const float*>(
            land + li * a.slot_bytes + ((pbase + static_cast<uintptr_t>(rb) * row0) & 15));
        if (vec) {
          transpose_rows4(dst, a.ld, src, n, D, lane);
        } else {
          transpose_rows(dst, a.ld, src, n, D, lane);
        }
        if (lane == 0) {
          hmask[2 * r] = lmask[2 * li];
          hmask[2 * r + 1] = lmask[2 * li + 1];
          sstage[r] = gs;
        }
        sm90::fence_proxy_async();  // the landing slot read before its next bulk copy
        sm90::mbar_arrive(&full[r]);
        ++taken;
        ++pub;
      }
    } else {
      // a needed stage goes into the next ring slot by one bulk copy
      for (int g = 0; g < stages; ++g) {
        if (!needed(g)) continue;
        const int r = pub % R;
        ring_wait(r);
        if (lane == 0) {
          hmask[2 * r] = m0;
          hmask[2 * r + 1] = m1;
          sstage[r] = g;
          const long long row0 = start + static_cast<long long>(g) * rows;
          copy_rows(ring + r * a.ring_bytes, pbase, a.N, rb, row0,
                    end - row0 < rows ? end - row0 : rows, &full[r]);
        } else {
          sm90::mbar_arrive(&full[r]);
        }
        ++pub;
      }
    }
    sm90::cp_async_wait_all();
    // the end of the chunk: a stage index of -1
    const int r = pub % R;
    ring_wait(r);
    if (lane == 0) sstage[r] = -1;
    sm90::mbar_arrive(&full[r]);
    return;
  }

  // a query warp: 8 queries, rows q0 + qb .. q0 + qb + 7 (past Q, the last),
  // through the published stages in turn
  const int qb = (warp - 1) * kRQ;
  const bool active = q0 + qb < a.Q;
  unsigned thi[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) thi[i] = 0xffffffffu;
  const Windows win(D);
  unsigned long long computed = 0;
  bool first = true;  // the warp's first tile of the chunk not yet computed

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
      const unsigned gcur = sg[qb + (lane & 7)];
      // the producer's test of the warp's queries against the stage's box
      // (with thresholds no lower than the current ones)
      if ((hmask[2 * r + (qb >> 5)] >> (qb & 31) & 0xffu) != 0) {
        ++computed;
        const long long row0 = start + static_cast<long long>(g) * rows;
        const int n = static_cast<int>(end - row0 < rows ? end - row0 : rows);
        const float* st = reinterpret_cast<const float*>(
            ring + r * a.ring_bytes +
            (TR ? 0 : ((pbase + static_cast<uintptr_t>(rb) * row0) & 15)));
#pragma unroll 1
        for (int u = 0; u < (n + kSubP - 1) / kSubP; ++u) {
          Sums<kRQ, kRP> acc;
          acc.clear();
          if (TR) {
            slot_sums<MODE>(acc, sq, ldq, st + u * kSubP, a.ld, qb, D, win);
          } else {
            direct_sums<MODE>(acc, sq, ldq, st + u * kSubP * D, qb, D, win);
          }
          test_append<MODE>(acc, L, k, thi, gcur, row0 + u * kSubP, end, qb, first);
          first = false;
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

// Rows a stage at D axes: 1,024 at D = 3; else about kStageBytes, whole
// tiles of sums, at least one.
inline int stage_rows(int D) {
  if (D == 3) return kStage3;
  const int r = kStageBytes / (4 * D) / kSubP * kSubP;
  return r > kSubP ? r : kSubP;
}

// A transposed slot's stride for stages of `rows` rows at D axes: the
// least stride >= rows whose residue x mod 32 gives the transpose's stores
// the fewest bank conflicts (transpose_rows4's where D % 4 == 0, else
// transpose_rows'): a warp's stores to rows r, axes c land in banks
// (c x + r) mod 32.
inline int slot_stride(int D, int rows) {
  static int cache[kMaxDim + 1];
  if (cache[D] == 0) {
    const bool vec = D % 4 == 0;
    int best = 0, best_cost = 1 << 30;
    for (int x = 0; x < 32; ++x) {
      int cost = 0;
      for (int u = 0; u < D; ++u) {      // a warp's 32 words (4 D stores of 128 words: vec)
        for (int i = 0; i < (vec ? 4 : 1); ++i) {
          int cnt[32] = {0}, worst = 0;
          for (int l = 0; l < 32; ++l) {
            const int w = vec ? 128 * u + 4 * l : 32 * u + l, r = w / D, c = w - r * D + i;
            const int b = (c * x + r) & 31;
            worst = ++cnt[b] > worst ? cnt[b] : worst;
          }
          cost += worst;
        }
      }
      if (cost < best_cost) {
        best_cost = cost;
        best = x;
      }
    }
    cache[D] = best + 1;
  }
  return rows + (((cache[D] - 1 - rows) % 32) + 32) % 32;
}

using KernelFn = void (*)(KnnArgs);

inline KernelFn kernel_for(int D) {
  const bool tr = D % 2 == 0;
  if (D <= 32) return tr ? knn_scan_kernel<kFma, true> : knn_scan_kernel<kFma, false>;
  return tr ? knn_scan_kernel<kWin, true> : knn_scan_kernel<kWin, false>;
}

// knn_scan_kernel's layout for D axes, k and W query warps into a: the
// stage's rows, the slots, the most landing and ring slots (of the
// candidates below, in order) that keep two blocks an SM, else one. Returns
// the shared-memory bytes, or -1 when not even one slot of each fits.
inline int plan_wide(int D, int k, int W, KnnArgs* a) {
  if (D < 1 || D > kMaxDim || D == 3) return -1;
  const bool tr = D % 2 == 0;
  a->D = D;
  a->Dp = (D + 3) & ~3;
  a->k = k;
  a->W = W;
  a->rows = stage_rows(D);
  const int nb = kBoxBatchFloats / (2 * a->Dp);
  a->nb = nb < 1 ? 1 : (nb > 32 ? 32 : nb);
  a->slot_bytes = up16(4LL * D * a->rows + 32);
  a->ld = tr ? slot_stride(D, a->rows) : 0;
  a->ring_bytes = tr ? up16(4LL * D * a->ld) : a->slot_bytes;
  static const int kTrSlots[][2] = {{2, 3}, {2, 2}, {1, 2}, {1, 1}};
  static const int kDirectSlots[][2] = {{0, 4}, {0, 3}, {0, 2}, {0, 1}};
  const int budgets[2] = {kSmemTwo, kSmemOne};
  for (const int budget : budgets) {
    for (int i = 0; i < 4; ++i) {
      a->L = tr ? kTrSlots[i][0] : kDirectSlots[i][0];
      a->R = tr ? kTrSlots[i][1] : kDirectSlots[i][1];
      const int bytes = carve(*a).total;
      if (bytes <= budget) return bytes;
    }
  }
  return -1;
}

// Whether a call of Q queries at D axes builds the box table and culls: at
// D = 3 always; else when the queries take more than one tile (the note at
// the top: for one tile the table costs more than it saves unless the
// points are in spatial order).
inline bool culls(int D, long long Q) { return D == 3 || Q > static_cast<long long>(kRQ) * kWarps; }

int launch_wide(KnnArgs a, cudaStream_t st) {
  const int smem = plan_wide(a.D, a.k, query_warps(a.Q), &a);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  a.G = static_cast<int>((a.N - (a.S - 1) * a.chunk + a.rows - 1) / a.rows);
  const KernelFn fn = kernel_for(a.D);
  if (smem > 48 * 1024) {
    const int e = static_cast<int>(
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (e != 0) return e;
  }
  if (a.boxes != nullptr) {
    BoxArgs b;
    b.p = a.p;
    b.boxes = const_cast<float*>(a.boxes);
    b.N = a.N;
    b.chunk = a.chunk;
    b.D = a.D;
    b.Dp = a.Dp;
    b.S = a.S;
    b.G = a.G;
    b.rows = a.rows;
    b.slot_bytes = a.slot_bytes;
    const int bs = box_smem(b.slot_bytes, b.Dp);
    if (bs > 48 * 1024) {
      const int e = static_cast<int>(cudaFuncSetAttribute(
          knn_boxes_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, bs));
      if (e != 0) return e;
    }
    knn_boxes_kernel<0><<<dim3(static_cast<unsigned>(a.G), static_cast<unsigned>(a.S)),
                          kTileThreads, bs, st>>>(b);
    const int e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
  }
  const long long tq = static_cast<long long>(kRQ) * a.W;
  const dim3 grid(static_cast<unsigned>((a.Q + tq - 1) / tq), static_cast<unsigned>(a.S));
  fn<<<grid, 32 * (a.W + 1), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int slots_wide(int D, int k, int W) {
  KnnArgs a;
  const int smem = plan_wide(D, k, W, &a);
  if (smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = kernel_for(D);
  if (smem > 48 * 1024) {
    const int e = static_cast<int>(
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (e != 0) return -e;
  }
  int n = 0;
  const int e = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, 32 * (W + 1), smem));
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
  float* boxes;                  // [S, G, 8]: each chunk's stages' boxes (knn_boxes_kernel<3>)
  long long Q, N, chunk;
  int k, S, W, G;                // G stages a chunk at most
};

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

__global__ void __launch_bounds__(32 * (kWarps + 1), 2) knn_scan3_kernel(const Knn3Args a) {
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
      copy_rows(ring + r * kSlot3, pbase, a.N, 12, row0,
                end - row0 < kStage3 ? end - row0 : kStage3, &full[r]);
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
          test_append<kFma>(acc, L, k, thi, gcur, row0 + u * kSubP, end, qb, false);
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
  BoxArgs b;
  b.p = a.p;
  b.boxes = a.boxes;
  b.N = a.N;
  b.chunk = a.chunk;
  b.D = 3;
  b.Dp = 4;
  b.S = a.S;
  b.G = a.G;
  b.rows = kStage3;
  b.slot_bytes = kSlot3;
  knn_boxes_kernel<3><<<dim3(static_cast<unsigned>(a.G), static_cast<unsigned>(a.S)),
                        kTileThreads, 0, st>>>(b);
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

// The query rows a block takes for Q queries (its tile: the partials' third
// extent), at every D: 8 a query warp, the ceil(Q / 8) warps shared out
// evenly over as few blocks of at most 7 as hold them.
extern "C" int knn_scan_tile(int D, long long Q) { return kRQ * query_warps(Q); }

// Rows a stage at D axes (the cull's granularity).
extern "C" int knn_scan_stage(int D) { return stage_rows(D); }

// Floats of the box table a call of Q queries over N points of D axes in S
// chunks takes, [S, G, 2, Dp] with G the longest chunk's stages and Dp = D
// rounded up to 4; 0 when the call builds none and culls nothing
// (`culls`).
extern "C" long long knn_scan_box_floats(int D, long long Q, long long N, int S) {
  if (!culls(D, Q)) return 0;
  const long long rows = stage_rows(D), G = (N - (S - 1) * (N / S) + rows - 1) / rows;
  return static_cast<long long>(S) * G * 2 * ((D + 3) & ~3);
}

// Blocks of the kernel for D axes, k and Q queries that one SM holds at
// once (for the caller's choice of S), or minus a CUDA error (minus
// cudaErrorInvalidValue when no layout fits: D above kMaxDim, or too wide
// for shared memory).
extern "C" int knn_scan_slots(int D, int k, long long Q) {
  if (D == 3) return slots3(query_warps(Q), k);
  return slots_wide(D, k, query_warps(Q));
}

// queries f32[Q, D], points f32[N, D] -> pd f32[T, S, TQ, k], pi i32[T, S,
// TQ, k] with TQ = knn_scan_tile(D, Q), T = ceil(Q / TQ): chunk s's k
// smallest (d2, index) per query row, ascending, (+inf, -1) past the
// chunk's list (rows past Q repeat query Q - 1). Contiguous device memory,
// 4-byte aligned; gthr u32[T TQ] all ones (the chunks' shared thresholds),
// boxes f32[knn_scan_box_floats(D, Q, N, S)] (scratch: the stages' boxes;
// null when that is 0), and counts null or u64[2] to which the culled and
// the examined (warp, stage) pairs are added. 1 <= k, S <= 65,535, every
// chunk (floor(N / S) points, the last to N) at least k points, N < 2^31.
// Returns the launches' CUDA error (0 = cudaSuccess; nothing is launched
// when Q is 0).
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
    a.W = query_warps(Q);
    a.G = static_cast<int>((N - (S - 1) * a.chunk + kStage3 - 1) / kStage3);
    return launch3(a, st);
  }
  KnnArgs a;
  a.q = static_cast<const float*>(queries);
  a.p = static_cast<const float*>(points);
  a.pd = static_cast<float*>(pd);
  a.pi = static_cast<int*>(pi);
  a.gthr = static_cast<unsigned*>(gthr);
  a.counts = static_cast<unsigned long long*>(counts);
  a.boxes = culls(D, Q) ? static_cast<const float*>(boxes) : nullptr;
  a.Q = Q;
  a.N = N;
  a.chunk = N / S;
  a.D = D;
  a.k = k;
  a.S = S;
  return launch_wide(a, st);
}
