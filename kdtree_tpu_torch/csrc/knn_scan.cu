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
// What bounds it on the card: the FP32 pipe. Every (query, point) pair costs
// 3 D flops (a subtract and an FMA an axis as instructions, and one compare
// against the query's running k-th); the points, read once, are a small
// fraction of that time (the fallback's 1,000 x 2^24 x 3-D: 1.5e11 flops,
// 2.25 ms at 67 TFLOP/s, against 0.06 ms for the points). The design before
// this one wrote every distance to device memory and read it back three
// times to pack keys and select.
//
// Design for Hopper:
// - The grid is (query tile of kTQ rows) x (S point chunks, each an
//   ascending index range of at least k points). A block stages its
//   queries in shared memory once (per slice above 32 axes) and streams its
//   chunk's points through a ring of kRing stages (cp.async; at D = 3 the
//   stage's rows are copied as they lie, with no index arithmetic), one
//   block barrier a stage. A thread holds an 8 x 4 register tile of d2, 8
//   queries of its warp against 4 points, as pair_d2 does (pair_tile.cuh).
// - Each pair's distance bits are compared with its query's running k-th
//   key's, held in registers: one compare rejects almost every pair. The
//   rest go out of line (admit): the key (d2 bits << 32 | index) against
//   the full threshold, and the survivors of a 32-point column into the
//   query's buffer of kCap keys in shared memory, at slots from one ballot.
// - A query's keys come only from its own warp, so each warp selects for
//   its queries alone, with no block barrier: when a column would overflow
//   the buffer, and at the end of the chunk. A select sorts the buffer
//   across the warp (bitonic, kPer keys a lane) and merges it into the
//   query's sorted k-list by ranks (each key's new place is its rank in
//   its own list plus its rank in the other, by binary search), cut at k.
//   The k-th key is the new threshold.
// - The k-lists of up to kSmemK entries live in shared memory and are
//   written out at the end; longer lists live in the partial buffers in
//   device memory from the start, the same code through generic pointers.
// - The lists are written with id -1 at +inf, the reference's pad. The
//   chunks' lists, pd/pi f32/i32[T, S, kTQ, k], are joined by the merge
//   kernel of scan_knn.cu (kernels/scan_knn.py::merge_partials): it keeps
//   the k smallest by (d2, chunk, rank in chunk) and pads with (+inf, -1).
//   The chunks are ascending index ranges and each list is in (d2, index)
//   order, so that order is (d2, index).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tile.cuh"

namespace {

using namespace kdt;

constexpr int kRQ = 8;                 // queries a thread
constexpr int kRP = 4;                 // points a thread, lane + 32 j
constexpr int kTQ = kTileWarps * kRQ;  // queries a block
constexpr int kSubP = 32 * kRP;        // points a tile of sums
constexpr int kSub = 8;                // tiles of sums a stage at most: a barrier a stage
constexpr int kLdq = kTQ + 4;          // staged query stride (16-byte rows)
constexpr int kCap = 64;               // buffered keys a query: 2 a lane in the select
constexpr int kPer = kCap / 32;
constexpr int kSmemK = 64;             // k-lists up to this length in shared memory
constexpr int kRing = 3;               // point stages in the ring
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// Tiles of sums a stage: kSub at D = DC (the rows as they lie), one above
// 32 axes (a stage is a slice of one tile), else as many as keep a stage's
// staged axes within 32 rows of 128 points.
__host__ __device__ constexpr int subtiles(int D, int DC) {
  return DC > 0 ? kSub : (D > kSlice ? 1 : (kSlice / D < kSub ? kSlice / D : kSub));
}

struct KnnArgs {
  const float* q;  // [Q, D]
  const float* p;  // [N, D]
  float* pd;       // [T, S, kTQ, k]
  int* pi;         // [T, S, kTQ, k]
  long long Q, N, chunk;  // chunk s: [s chunk, (s + 1) chunk), the last to N
  int D, k, S;
};

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

struct Lists {
  unsigned long long* buf;  // [kTQ][kCap]
  unsigned long long* thr;  // [kTQ]: the k-th key, kNoKey while a list is short
  int* cnt;                 // [kTQ]: keys in the buffer
  int* len;                 // [kTQ]: entries in the k-list
  float* ld;                // the k-lists: shared [kTQ][k], or the block's partials
  int* li;
};

// One warp merges query q's buffer into its k-list (see the note above) and
// empties the buffer. Out of line: it runs rarely, and its registers stay
// out of the distance loop's.
__device__ __noinline__ void select_query(const Lists L, int q, int k) {
  const int lane = threadIdx.x & 31;
  const int b = L.cnt[q];
  if (b == 0) return;
  unsigned long long* buf = L.buf + static_cast<long long>(q) * kCap;
  float* ld = L.ld + static_cast<long long>(q) * k;
  int* li = L.li + static_cast<long long>(q) * k;
  const int len = L.len[q];

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
    L.len[q] = nl;
    L.cnt[q] = 0;
    L.thr[q] = nl == k ? list_key(ld, li, k - 1) : kNoKey;
  }
  __syncwarp();
}

// Appends the keys of one 32-point column (a key a lane) that pass `test`
// against query q's threshold to its buffer, selecting first when they
// would overflow it, and testing again against the new threshold then. A
// query's keys come only from its warp's lanes, so the warp does this
// alone, with no block barrier.
template <typename Test>
__device__ __forceinline__ void append(const Lists& L, int q, int k, unsigned long long key,
                                       Test test) {
  const int lane = threadIdx.x & 31;
  bool pass = test(L.thr[q]);
  unsigned m = __ballot_sync(kFull, pass);
  if (m == 0) return;
  int c = L.cnt[q];
  if (c + __popc(m) > kCap) {
    select_query(L, q, k);
    pass = test(L.thr[q]);
    m = __ballot_sync(kFull, pass);
    c = 0;
  }
  if (pass) L.buf[static_cast<long long>(q) * kCap + c + __popc(m & ((1u << lane) - 1))] = key;
  __syncwarp();
  if (lane == 0) L.cnt[q] = c + __popc(m);
  __syncwarp();
}

// The rare path of test_append: the pairs of the queries in `near` (d2[i
// kRP + j] for query i and point base + lane + 32 j) through append. Out of
// line, so that the distance loop keeps its registers.
__device__ __noinline__ void admit(const float* d2, const Lists L, int k, unsigned near,
                                   long long base, long long end) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = 0; i < kRQ; ++i) {
    if (!(near >> i & 1)) continue;
    const int q = warp * kRQ + i;
#pragma unroll 1
    for (int j = 0; j < kRP; ++j) {
      const long long idx = base + lane + 32 * j;
      const unsigned long long key = make_key(d2[i * kRP + j], static_cast<unsigned>(idx));
      const bool real = idx < end;
      append(L, q, k, key, [&](unsigned long long t) { return real && key < t; });
    }
  }
}

// The tile's pairs (points base + lane + 32 j) against each query's running
// k-th key: the distance bits alone reject almost every pair, and the rest
// go through admit; points at or past `end` are not the chunk's.
template <int MODE>
__device__ __forceinline__ void test_append(const Sums<kRQ, kRP>& acc, const Lists& L, int k,
                                            unsigned (&thi)[kRQ], long long base,
                                            long long end) {
  const int warp = threadIdx.x >> 5;
  unsigned near = 0;  // bit i: a pair of query i may pass
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRP; ++j) {
      any |= __float_as_uint(acc.template result<MODE>(i, j)) <= thi[i];
    }
    near |= static_cast<unsigned>(any) << i;
  }
  near = __reduce_or_sync(kFull, near);
  if (!near) return;
  float d2[kRQ * kRP];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int j = 0; j < kRP; ++j) d2[i * kRP + j] = acc.template result<MODE>(i, j);
  }
  admit(d2, L, k, near, base, end);
#pragma unroll
  for (int i = 0; i < kRQ; ++i) thi[i] = static_cast<unsigned>(L.thr[warp * kRQ + i] >> 32);
}

template <int MODE, int DC>
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
  // points [kRing][ds0][bp + 1] (at DC = 3 row-major [kRing][bp][3])
  float* sq = reinterpret_cast<float*>(smem_raw);
  const int nqbuf = nsl > 1 ? kRing : 1;
  float* sp = sq + nqbuf * ds0 * kLdq;
  const int bp = kSubP * subtiles(D, DC);  // points a stage
  const int ldp = bp + 1;                  // staged point stride (transposed, 32 banks)
  const int pstage = DC > 0 ? bp * DC : ds0 * ldp;
  unsigned char* p = reinterpret_cast<unsigned char*>(sp + kRing * pstage);
  p += (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  Lists L;
  L.buf = reinterpret_cast<unsigned long long*>(p);
  p += sizeof(unsigned long long) * kTQ * kCap;
  L.thr = reinterpret_cast<unsigned long long*>(p);
  p += sizeof(unsigned long long) * kTQ;
  L.cnt = reinterpret_cast<int*>(p);
  p += sizeof(int) * kTQ;
  L.len = reinterpret_cast<int*>(p);
  p += sizeof(int) * kTQ;
  const long long tile = blockIdx.x;
  const int s = blockIdx.y;
  const long long out0 = (tile * a.S + s) * kTQ * static_cast<long long>(k);
  if (smem_lists) {
    L.ld = reinterpret_cast<float*>(p);
    p += sizeof(float) * kTQ * k;
    L.li = reinterpret_cast<int*>(p);
  } else {
    L.ld = a.pd + out0;
    L.li = a.pi + out0;
  }

  const long long q0 = tile * kTQ;
  const long long start = s * a.chunk;
  const long long end = s == a.S - 1 ? a.N : start + a.chunk;
  const int steps = static_cast<int>((end - start + bp - 1) / bp);
  const int stages = steps * nsl;
  const Windows win(D);

  if (lane < kRQ) {
    L.thr[warp * kRQ + lane] = kNoKey;
    L.cnt[warp * kRQ + lane] = 0;
    L.len[warp * kRQ + lane] = 0;
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
    if constexpr (DC > 0) {  // the tile's rows are contiguous: copied as they lie
      if (g == 0) stage_rows(sq, kLdq, a.q, q0, a.Q - 1, kTQ, D, 0, D);
      const long long first = row0 * DC, last = end * DC - 1;
      for (int e = tid; e < bp * DC; e += kTileThreads) {
        const long long src = first + e < last ? first + e : last;
        sm90::cp_async4(sp + r * pstage + e, a.p + src);
      }
    } else {
      const int d0 = sl * kSlice;
      const int ds = D - d0 < kSlice ? D - d0 : kSlice;
      if (nsl > 1 || g == 0) {
        stage_rows(sq + (nsl > 1 ? r : 0) * ds0 * kLdq, kLdq, a.q, q0, a.Q - 1, kTQ, D, d0, ds);
      }
      stage_rows(sp + r * pstage, ldp, a.p, row0, end - 1, bp, D, d0, ds);
    }
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
      test_append<MODE>(acc, L, k, thi, start + static_cast<long long>(st) * bp, end);
      acc.clear();
      sl = 0;
      ++st;
      continue;
    }
#pragma unroll 1
    for (int u = 0; u < bp / kSubP; ++u) {
      if constexpr (DC > 0) {
        const float* ps = sp + r * pstage + u * kSubP * DC;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          float qv[kRQ], pv[kRP];
          load_vec(qv, sq + c * kLdq + warp * kRQ);
#pragma unroll
          for (int j = 0; j < kRP; ++j) pv[j] = ps[(lane + 32 * j) * DC + c];
          add_axis<MODE>(acc, qv, pv, c, D, win);
        }
      } else {
        accumulate<MODE>(acc, sq, kLdq, sp + r * pstage + u * kSubP, ldp, warp * kRQ, 0, D,
                         D, win);
      }
      test_append<MODE>(acc, L, k, thi, start + static_cast<long long>(st) * bp + u * kSubP, end);
      acc.clear();
    }
    ++st;
  }
  // the last keys of the warp's buffers, then its lists out with id -1 at +inf
  for (int i = 0; i < kRQ; ++i) select_query(L, warp * kRQ + i, k);
  for (int e = lane; e < kRQ * k; e += 32) {
    const long long o = static_cast<long long>(warp) * kRQ * k + e;
    const float d = L.ld[o];
    if (smem_lists) a.pd[out0 + o] = d;
    if (smem_lists || isinf(d)) a.pi[out0 + o] = isinf(d) ? -1 : L.li[o];
  }
}

template <int MODE, int DC>
size_t smem_bytes(int D, int k) {
  const int ds0 = D < kSlice ? D : kSlice;
  const int nqbuf = D > kSlice ? kRing : 1;
  const int bp = kSubP * subtiles(D, DC);
  const int pstage = DC > 0 ? bp * DC : ds0 * (bp + 1);
  size_t bytes = static_cast<size_t>(4) * (nqbuf * ds0 * kLdq + kRing * pstage) + 16;
  bytes += sizeof(unsigned long long) * kTQ * (kCap + 1) + sizeof(int) * 2 * kTQ;
  if (k <= kSmemK) bytes += static_cast<size_t>(8) * kTQ * k;
  return bytes;
}

template <int MODE, int DC>
int prepare(int D, int k, size_t* smem) {
  *smem = smem_bytes<MODE, DC>(D, k);
  if (*smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(knn_scan_kernel<MODE, DC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(*smem)));
}

template <int MODE, int DC>
int launch(const KnnArgs& a, cudaStream_t st) {
  size_t smem = 0;
  const int e = prepare<MODE, DC>(a.D, a.k, &smem);
  if (e != 0) return e;
  const dim3 grid(static_cast<unsigned>((a.Q + kTQ - 1) / kTQ), static_cast<unsigned>(a.S));
  knn_scan_kernel<MODE, DC><<<grid, kTileThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int DC>
int slots(int D, int k) {
  size_t smem = 0;
  int e = prepare<MODE, DC>(D, k, &smem);
  if (e != 0) return -e;
  int n = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, knn_scan_kernel<MODE, DC>, kTileThreads, smem));
  return e != 0 ? -e : n;
}

}  // namespace

// The queries a block takes (its tile: the partials' third extent).
extern "C" int knn_scan_tile() { return kTQ; }

// Blocks of the kernel for D axes and k that one SM holds at once (for the
// caller's choice of S), or minus a CUDA error.
extern "C" int knn_scan_slots(int D, int k) {
  if (D <= 32) return D == 3 ? slots<kFma, 3>(D, k) : slots<kFma, 0>(D, k);
  return D <= 32 * 32 ? slots<kWin, 0>(D, k) : slots<kWin2, 0>(D, k);
}

// queries f32[Q, D], points f32[N, D] -> pd f32[T, S, kTQ, k], pi i32[T, S,
// kTQ, k] with T = ceil(Q / kTQ): chunk s's k smallest (d2, index) per query,
// ascending (rows past Q repeat query Q - 1). Contiguous device memory;
// 1 <= k, S <= 65,535, every chunk (floor(N / S) points, the last to N) at
// least k points, N < 2^31. Returns the launch's CUDA error (0 =
// cudaSuccess; nothing is launched when Q is 0).
extern "C" int knn_scan_launch(const void* queries, const void* points, void* pd, void* pi,
                               long long Q, long long N, int D, int k, int S, void* stream) {
  if (Q <= 0) return 0;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return D == 3 ? launch<kFma, 3>(a, st) : launch<kFma, 0>(a, st);
  return D <= 32 * 32 ? launch<kWin, 0>(a, st) : launch<kWin2, 0>(a, st);
}
