// The frontier descent of the tiled engine and the query verbs: for each tile
// box, the <= cap nodes of the bucket-AABB heap with the smallest box-to-box
// lower bound, level by level, pruned by the tile's bound.
//
// Replaces no TPU kernel: the JAX package runs this descent as the XLA program
// kdtree_tpu/ops/tile_query.py::_frontier (:113, its bounds from
// _gathered_box_lb :91). Its plain PyTorch version is
// kdtree_tpu_torch/ops/tile_query.py::_frontier, which this kernel matches bit
// for bit (bucket ids, lower bounds, overflow flags), and
// kdtree_tpu_torch/kernels/frontier.py::frontier_mirror follows it step for
// step on the CPU, every path included.
//
// The function, per tile t:
//   start at level s = min(floor(log2 cap), L): the m = 2^s nodes m - 1 + j;
//   at each of the L - s levels after it, the two children of every live slot;
//   a node is live when its lower bound lb <= bound[t] and lb is finite;
//   more than cap live nodes at a level set overflow[t];
//   the cap smallest live nodes, in the order of one stable sort by lb over
//   the level's positions (a left child of slot j at j, a right one at cap + j,
//   so on equal lb every left child comes before every right child), are the
//   next level's slots. The last level's slots are buckets (id - first_leaf);
//   the slots past them are (-1, +inf).
//
// Traps the plain version sets, kept here:
//   a. the lower bound is _arith.sq_sum_unrolled over the box-to-box gaps
//      max(max(lo - bhi, blo - hi), 0): x0 * x0 at D = 1, else
//      fma(x0, x0, round(x1 * x1)) and fma(x_d, x_d, acc) on, at every D (no
//      windows above 32 axes, unlike d2.cuh's box_bound);
//   b. torch.maximum propagates NaN and fmaxf does not: a gap that is NaN on
//      any axis (an infinite tile face against an empty node's [+inf, -inf]
//      box) makes the plain lb NaN, which fails lb <= bound: the node is dead;
//   c. ties are the common case (every node overlapping the tile box has lb
//      0): every sort here is stable on the lb bits and keeps position order
//      on ties (why that holds across CTAs: below); after the mask a lower
//      bound is +0..+inf, so its float bits order like unsigned integers;
//   d. caps run from 1 to pow2ceil(num_buckets); cap >= 2^L leaves no level
//      loop; with bound +inf an empty node's lb +inf passes lb <= bound but is
//      not finite, so it is not live.
//
// What bounds it on this card: the bytes and flops are microseconds (one
// lower bound per child of a live slot, 6 D flops, and each distinct node box
// read once). The selection is the cost: a level cannot start before the
// previous level's sort has ended, and a sort is a chain of barrier-separated
// steps. The served plans are sparse (one to eight 8-query tiles, cap = every
// bucket), so one block per tile walked a 65,536-candidate level alone on 1
// or 8 of the 132 SMs; and where many tiles each keep a few thousand nodes
// (128 tiles at cap 32,768), the chain's fixed steps, barriers and merge
// rounds, repeated over every level and every wave of CTAs, are the time.
//
// The design: a tile runs on a cluster of c CTAs (c = 1, 2, 4, 8 or 16, picked
// by the wrapper from T, cap, the widest level and the shared memory a key
// takes: the smallest c whose slices fit, raised to what the measured
// sweeps found best for that many tiles and that width; c = 1 is one block
// per tile, its own instantiation with no cluster code and a register bound
// of four 512-thread blocks an SM, right for the tiled batches' 512
// tiles). A key is (lb bits << 32 | node), so a slot is a key. At each level:
//   1. CTA j takes the contiguous slice [j P, (j + 1) P) of the level's
//      positions, P = ceil(n / c): the start level's nodes, or the left
//      children of the live slots followed by their right children, each
//      parent read from the CTA that holds its slot (DSMEM);
//   2. it computes their lower bounds (group_lb, traps a and b; the loads of
//      a group of positions in flight together) and writes its live ones'
//      keys in position order, ranked by one scan of ballot counts;
//   3. each CTA pushes its live count and lb range into every CTA (DSMEM
//      stores); the cluster's prefix of the counts orders the CTAs' keys. A
//      level with no live candidate ends the tile's descent;
//   4. the cluster rebalances: CTA j gathers ranks [j Q, (j + 1) Q) of the
//      level's Q c live keys (live nodes are contiguous in Morton order, so
//      a few slices hold most of them); keys that fit half a slice all go to
//      CTA 0 (Q = count), which sorts them alone, since with 128 tiles of a
//      few thousand keys the merge rounds' barriers cost more than that
//      sort. A level whose live lbs are all equal
//      (range mode's 0, an all-overlap level) is in order now. Otherwise each
//      CTA sorts its share by lb, stably (an odd-even network over 8 keys in
//      registers, then merge-path rounds in shared memory; up to 32 keys in
//      one warp), and log2(c) rounds merge pairs of sorted runs: a run lies in
//      its CTAs' shared memory, key e in the (e / Q)-th at e % Q; two warps of
//      each CTA find where its outputs split between the two runs (32 probes a
//      DSMEM round trip), its threads copy those inputs into its spare slice,
//      and after a cluster barrier it merges them into its keys. Only the
//      first min(count, cap) keys of a run are made.
// Why stable sorts on lb alone give the contract's order (trap c): a CTA's
// keys are in position order, a share precedes the next CTA's share, and a
// merge takes the lower CTAs' run first on equal lb; so on every tie the
// earlier position comes first, and no rank needs to travel with a key.
// A key takes 16 bytes of shared memory (its slot and a spare), a slice
// 8,192 keys (131,072 of a CTA's 232,448 bytes): a cluster of 8 holds every
// level of a cap up to 2^15 and a start level of 2^16 nodes, a cluster of 16
// twice that. Wider levels, or a slice the wrapper forces below the level,
// run the same steps on per-CTA slices of device memory (the device-memory
// path, a plan from the shapes). Keys are stored swizzled, key i at
// i ^ ((i >> 4) & 15), so that threads a few keys apart in a merge fall on
// different banks. A cluster's CTAs meet at a barrier before the first DSMEM
// access, since a CTA may not touch the shared memory of one that has not
// started (a CTA with no start-level position gets there at once: measured,
// 512 tiles at cap 8 on 16 CTAs faulted within 30 launches without it). A
// refused cluster launch returns its CUDA error; nothing retries another
// size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;  // a CTA of a cluster
constexpr int kSoloThreads = 512;  // a tile's one block
constexpr int kMaxCluster = 16;
// Keys a thread sorts in registers (and merge outputs a thread), and chunks
// of a level whose lower bounds a thread computes together: fewer on a solo
// tile's block, whose registers decide how many blocks share an SM.
template <bool kSolo> constexpr int kItems = kSolo ? 4 : 8;
template <bool kSolo> constexpr int kGroup = kSolo ? 2 : 4;
constexpr int kMaxGroup = 4;
constexpr int kBatch = 4;          // remote reads a thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ull;

struct FrontierArgs {
  const float* node_lo;       // [H, D] the heap's boxes
  const float* node_hi;
  const float* box_lo;        // [T, D] the tiles' boxes
  const float* box_hi;
  const float* bound;         // [T]
  int* bucket;                // [T, cap] bucket ids
  float* lb;                  // [T, cap]
  unsigned char* overflow;    // [T]
  unsigned long long* keys;   // [T c, 2 slice] device-memory path, null on chip
  int D, cap, start, levels, first_leaf, cluster, slice;
};

// A CTA's small state in shared memory; its peers write peer_count,
// peer_min and peer_max.
struct Shared {
  int prefix[kMaxCluster + 1];     // the cluster's exclusive prefix of counts
  int peer_count[kMaxCluster];     // each CTA's live candidates
  unsigned peer_min[kMaxCluster], peer_max[kMaxCluster];  // and their lb bits' range
  int uniform;                     // every live lb of the level is equal
  int split[2];  // a merge round: A keys before this CTA's outputs, and to their end
  int warp_counts[kMaxGroup][32];  // ranking: live candidates by (chunk, warp), then their prefix
  int chunk_total[kMaxGroup];
  unsigned warp_min[32], warp_max[32];
};

constexpr size_t kSharedBytes = (sizeof(Shared) + 15) / 16 * 16;

// Where key i of a slice is stored: its row of 16 keys, permuted by the row's
// number, so that threads reading keys a few apart (a merge's runs) fall on
// different banks.
__device__ __forceinline__ int sw(int i) { return i ^ ((i >> 4) & 15); }

// This CTA's view of the descent: where its keys live and who its peers are.
struct Cta {
  Shared* sh;
  unsigned long long* keys;   // its slice of keys (swizzled): shared memory, or device memory
  unsigned long long* spare;  // a second slice: children's nodes, sort and gather scratch
  long long stride;           // device-memory path: elements between CTAs' key slices
  long long tile;
  int rank, c;
};

// CTA r's keys: its shared memory over DSMEM, or its slice of device memory.
// A solo tile (one block) has no peer.
template <bool kOnChip, bool kSolo>
__device__ __forceinline__ unsigned long long* peer_keys(const Cta& x, int r) {
  if constexpr (kSolo) return x.keys;
  if (r == x.rank) return x.keys;
  if constexpr (kOnChip) return cg::this_cluster().map_shared_rank(x.keys, r);
  return x.keys + (r - x.rank) * x.stride;
}

template <bool kSolo>
__device__ __forceinline__ Shared* peer_shared(const Cta& x, int r) {
  if constexpr (kSolo) return x.sh;
  if (r == x.rank) return x.sh;
  return cg::this_cluster().map_shared_rank(x.sh, r);
}

// A barrier over the tile's CTAs (the block's when the tile has one).
template <bool kSolo>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kSolo) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// The lower bounds of G nodes' boxes against the tile box [blo, bhi], in the
// plain version's arithmetic (trap a); +inf where a gap is NaN (trap b). The
// axes run outermost, so each axis's loads of all G nodes are in flight
// together.
template <int G>
__device__ __forceinline__ void group_lb(const FrontierArgs& a, const int (&node)[G],
                                         const float* blo, const float* bhi, float (&lb)[G]) {
  float g0[G], acc[G];
  bool nan[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    g0[k] = acc[k] = 0.f;
    nan[k] = false;
  }
  for (int d = 0; d < a.D; ++d) {
    const float bl = blo[d], bh = bhi[d];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const long long at = static_cast<long long>(node[k]) * a.D + d;
      const float x = __fsub_rn(a.node_lo[at], bh);
      const float y = __fsub_rn(bl, a.node_hi[at]);
      nan[k] |= isnan(x) || isnan(y);
      const float g = fmaxf(fmaxf(x, y), 0.f);
      if (d == 0) {
        g0[k] = g;
      } else if (d == 1) {
        acc[k] = __fmaf_rn(g0[k], g0[k], __fmul_rn(g, g));
      } else {
        acc[k] = __fmaf_rn(g, g, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) {
    lb[k] = nan[k] ? INFINITY : (a.D == 1 ? __fmul_rn(g0[k], g0[k]) : acc[k]);
  }
}

// The lb bits of a key (lb bits << 32 | node): what every sort compares. A
// sort that keeps ties in their order (stable) keeps the position order the
// contract asks for.
__device__ __forceinline__ unsigned lb_of(unsigned long long key) {
  return static_cast<unsigned>(key >> 32);
}

// Sorts v[0, E) by lb in registers, stably: odd-even transposition, a swap
// only on a strictly greater lb (constant indices).
template <int E>
__device__ __forceinline__ void sort_items(unsigned long long (&v)[E]) {
#pragma unroll
  for (int p = 0; p < E; ++p) {
#pragma unroll
    for (int i = p & 1; i + 1 < E; i += 2) {
      if (lb_of(v[i]) > lb_of(v[i + 1])) {
        const unsigned long long t = v[i];
        v[i] = v[i + 1];
        v[i + 1] = t;
      }
    }
  }
}

// Writes outputs [d, d + n) (n <= E) of the stable merge of A and B (on equal
// lb, A first) to dst[o, o + n), for the sorted runs A = src[a0, a0 + la) and
// B = src[b0, b0 + lb) of one slice (swizzled): a merge-path search for the
// split at d, then a sequential merge.
template <int E>
__device__ __forceinline__ void merge_items(const unsigned long long* src, int a0, int la, int b0,
                                            int lb, int d, int n, unsigned long long* dst,
                                            int o) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lb_of(src[sw(a0 + mid)]) <= lb_of(src[sw(b0 + d - 1 - mid)])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ia = lo, ib = d - lo;
  unsigned long long ka = ia < la ? src[sw(a0 + ia)] : kPadKey;
  unsigned long long kb = ib < lb ? src[sw(b0 + ib)] : kPadKey;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (k < n) {
      if (lb_of(ka) <= lb_of(kb)) {
        dst[sw(o + k)] = ka;
        ka = ++ia < la ? src[sw(a0 + ia)] : kPadKey;
      } else {
        dst[sw(o + k)] = kb;
        kb = ++ib < lb ? src[sw(b0 + ib)] : kPadKey;
      }
    }
  }
}

// Sorts in[0, n) by lb, stably, into keys[0, n) (in is keys or spare), with
// spare[0, n) as scratch: up to 32 keys
// in one warp, each lane's place counted over shuffles; else each thread
// sorts runs of E keys in registers, then rounds of merge-path merges double
// the runs, src to dst, E outputs a thread and one barrier a round
// (log2(n / E) barriers, where a bitonic network takes log2(n)^2 / 2).
template <int E>
__device__ void local_sort(const unsigned long long* in, unsigned long long* keys,
                           unsigned long long* spare, int n) {
  const int nt = blockDim.x;
  if (n <= 32) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const unsigned long long v = lane < n ? in[sw(lane)] : kPadKey;
      const unsigned mine = lb_of(v);
      int place = 0;
      for (int i = 0; i < n; ++i) {  // the keys before this one in the stable order
        const unsigned other = __shfl_sync(kFull, mine, i);
        place += other < mine || (other == mine && i < lane);
      }
      __syncwarp();
      if (lane < n) keys[sw(place)] = v;
    }
    __syncthreads();
    return;
  }
  for (int d0 = static_cast<int>(threadIdx.x) * E; d0 < n; d0 += nt * E) {
    const int mine = min(E, n - d0);
    unsigned long long v[E];
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = k < mine ? in[sw(d0 + k)] : kPadKey;
    sort_items<E>(v);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (k < mine) keys[sw(d0 + k)] = v[k];
    }
  }
  __syncthreads();
  unsigned long long* src = keys;
  unsigned long long* dst = spare;
  for (int w = E; w < n; w <<= 1) {
    for (int d0 = static_cast<int>(threadIdx.x) * E; d0 < n; d0 += nt * E) {
      const int base = d0 / (2 * w) * (2 * w);  // the merged run of 2 w holding d0
      const int la = min(w, n - base), lb = max(0, min(w, n - base - w));
      merge_items<E>(src, base, la, base + w, lb, d0 - base, min(E, n - d0), dst, d0);
    }
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  if (src != keys) {
    for (int i = threadIdx.x; i < n; i += nt) keys[sw(i)] = src[sw(i)];
    __syncthreads();
  }
}

// Key e of the run that starts at cluster rank g: in the (e / P)-th CTA on,
// at e % P.
template <bool kOnChip>
__device__ __forceinline__ unsigned long long run_key(const Cta& x, int g, int e, int P) {
  const int o = e / P;
  return peer_keys<kOnChip, false>(x, g + o)[sw(e - o * P)];
}

// How many of the first d keys of the stable merge of A and B come from A,
// for the runs A (length la from rank ga) and B (lb from rank gb) of the
// cluster; one warp probes 32 splits a step, so a step costs one DSMEM round
// trip.
template <bool kOnChip>
__device__ int warp_path(const Cta& x, int ga, int la, int gb, int lb, int d, int P) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - lb), hi = min(d, la);  // the split lies in [lo, hi]
  while (lo < hi) {
    const int mid = lo + static_cast<int>(static_cast<long long>(hi - lo) * lane / 32);
    const bool before =
        lb_of(run_key<kOnChip>(x, ga, mid, P)) <= lb_of(run_key<kOnChip>(x, gb, d - 1 - mid, P));
    const int n_before = __popc(__ballot_sync(kFull, before));  // true on a prefix of the lanes
    const int new_lo = n_before > 0 ? __shfl_sync(kFull, mid, n_before - 1) + 1 : lo;
    const int new_hi = n_before < 32 ? __shfl_sync(kFull, mid, n_before & 31) : hi;
    lo = new_lo;
    hi = new_hi;
  }
  return lo;
}

// Copies keys [e0, e0 + n) of the cluster's concatenation held from rank g (the
// e / P-th CTA on, at e % P) to dst[o, o + n): kBatch remote reads a thread in
// flight.
template <bool kOnChip>
__device__ __forceinline__ void gather_run(const Cta& x, int g, int e0, int n, int P,
                                           unsigned long long* dst, int o) {
  const int nt = blockDim.x;
  for (int b = threadIdx.x; b < n; b += nt * kBatch) {
    unsigned long long v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (b + k * nt < n) v[k] = run_key<kOnChip>(x, g, e0 + b + k * nt, P);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (b + k * nt < n) dst[sw(o + b + k * nt)] = v[k];
    }
  }
}

// One merge round over the cluster's runs of P keys a CTA (the first `total`
// keys of the concatenation, run r held by CTA r): the runs of each pair of
// `half`-CTA groups become one run of their 2 half CTAs, its first
// min(la + lb, cap) keys, this CTA making its P of them. Two warps find the
// split of its outputs between the runs, its threads copy those inputs from
// their CTAs into its spare slice (coalesced DSMEM reads), and after a
// cluster barrier (every CTA has its inputs, so the keys may be overwritten)
// it merges them into its keys.
template <bool kOnChip>
__device__ void merge_round(Cta& x, int cap, int total, int half, int P) {
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int g = x.rank & ~(2 * half - 1), gb = g + half;
  const int la = min(min(max(total - g * P, 0), half * P), cap);
  const int lb = min(min(max(total - gb * P, 0), half * P), cap);
  const int base = (x.rank - g) * P;
  const int n = max(0, min(base + P, min(la + lb, cap)) - base);
  for (int w = warp; n > 0 && w < 2; w += nt >> 5) {
    const int ia = warp_path<kOnChip>(x, g, la, gb, lb, base + w * n, P);
    if ((tid & 31) == 0) x.sh->split[w] = ia;
  }
  __syncthreads();
  const int ia0 = x.sh->split[0], na = n > 0 ? x.sh->split[1] - ia0 : 0;
  gather_run<kOnChip>(x, g, ia0, na, P, x.spare, 0);
  gather_run<kOnChip>(x, gb, base - ia0, n - na, P, x.spare, na);
  cluster_sync<false>();
  constexpr int E = kItems<false>;
  for (int d0 = tid * E; d0 < n; d0 += nt * E) {
    merge_items<E>(x.spare, 0, na, na, n - na, d0, min(E, n - d0), x.keys, d0);
  }
}

// One level for this CTA's slice of the level's n_cand positions (the start
// level's nodes, or the children of the n_live slots, held p_prev a CTA).
// Returns the level's kept count; *p_out gets the kept keys a CTA holds.
template <bool kOnChip, bool kSolo>
__device__ int descend(const FrontierArgs& a, Cta& x, int n_cand, int n_live, int p_prev,
                       bool children, const float* blo, const float* bhi, float bound,
                       int* p_out, bool* overflowed) {
  const int c = kSolo ? 1 : x.c, j = kSolo ? 0 : x.rank;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int warps = nt >> 5;
  const int P = (n_cand + c - 1) / c;
  const int p0 = min(j * P, n_cand), n_mine = min(p0 + P, n_cand) - p0;
  Shared* sh = x.sh;
  int* child = reinterpret_cast<int*>(x.spare);  // step 1's nodes, read by step 2

  // 1. each position's node: a child of the slot that holds its parent
  if (children) {
    for (int b = tid; b < n_mine; b += nt * kBatch) {
      unsigned parent[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int p = p0 + b + k * nt, s = p < n_live ? p : p - n_live, o = s / p_prev;
        if (b + k * nt < n_mine) {
          parent[k] = static_cast<unsigned>(peer_keys<kOnChip, kSolo>(x, o)[sw(s - o * p_prev)]);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = b + k * nt;
        if (i < n_mine) child[i] = 2 * static_cast<int>(parent[k]) + (p0 + i < n_live ? 1 : 2);
      }
    }
    cluster_sync<kSolo>();  // every slot is read before any CTA writes its keys
  }

  // 2. lower bounds, G chunks of nt positions at a time (their loads in
  // flight together); the live candidates' keys (lb bits << 32 | node) laid
  // out in position order by one scan of the (chunk, warp) counts
  constexpr int G = kGroup<kSolo>;
  const int m = 1 << a.start;
  int count = 0;
  unsigned mn = ~0u, mx = 0u;
  for (int g0 = 0; g0 < n_mine; g0 += G * nt) {
    int node[G];
    float lb[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {  // a position past the slice reads node 0 and is dropped
      const int i = g0 + k * nt + tid;
      node[k] = i >= n_mine ? 0 : children ? child[i] : m - 1 + p0 + i;
    }
    group_lb<G>(a, node, blo, bhi, lb);
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (g0 + k * nt + tid < n_mine && lb[k] <= bound && lb[k] < INFINITY) live |= 1u << k;
      const unsigned ballot = __ballot_sync(kFull, (live >> k) & 1u);
      if (lane == 0) sh->warp_counts[k][warp] = __popc(ballot);
    }
    __syncthreads();
    for (int k = warp; k < G; k += warps) {  // warp k scans chunk k's warp counts
      const int v = lane < warps ? sh->warp_counts[k][lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      if (lane < warps) sh->warp_counts[k][lane] = incl - v;
      if (lane == 31) sh->chunk_total[k] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const unsigned ballot = __ballot_sync(kFull, (live >> k) & 1u);
      if ((live >> k) & 1u) {
        const unsigned bits = __float_as_uint(lb[k]);
        const int r = count + sh->warp_counts[k][warp] + __popc(ballot & ((1u << lane) - 1u));
        x.keys[sw(r)] = (static_cast<unsigned long long>(bits) << 32) |
                        static_cast<unsigned>(node[k]);
        mn = min(mn, bits);
        mx = max(mx, bits);
      }
      count += sh->chunk_total[k];
    }
    __syncthreads();  // the counts are read before the next group writes them
  }

  // 3. the cluster's counts and lb range, pushed into every CTA
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  if (lane == 0) {
    sh->warp_min[warp] = mn;
    sh->warp_max[warp] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < warps; ++w) {
      mn = min(mn, sh->warp_min[w]);
      mx = max(mx, sh->warp_max[w]);
    }
    if constexpr (kSolo) {
      sh->prefix[0] = 0;
      sh->prefix[1] = count;
      sh->uniform = mn == mx;
    } else {
      for (int r = 0; r < c; ++r) {  // DSMEM stores
        Shared* q = peer_shared<false>(x, r);
        q->peer_count[j] = count;
        q->peer_min[j] = mn;
        q->peer_max[j] = mx;
      }
    }
  }
  if constexpr (!kSolo) {
    cluster_sync<false>();  // every CTA's count and range are in every CTA
    if (tid == 0) {
      unsigned lo = ~0u, hi = 0u;
      sh->prefix[0] = 0;
      for (int r = 0; r < c; ++r) {
        sh->prefix[r + 1] = sh->prefix[r] + sh->peer_count[r];
        lo = min(lo, sh->peer_min[r]);
        hi = max(hi, sh->peer_max[r]);
      }
      sh->uniform = lo == hi;
    }
  }
  __syncthreads();
  const int total = sh->prefix[c];
  if (total > a.cap) *overflowed = true;
  if (total == 0) return 0;  // the descent ends here (the kernel's last barrier waits for peers)
  const int keep = min(total, a.cap);

  // 4. the kept keys in order, key e in CTA e / Q at e % Q. A cluster first
  // rebalances: CTA j gathers ranks [j Q, (j + 1) Q) of the level's live keys
  // from the CTAs that ranked them (live nodes are contiguous in Morton
  // order, so a few slices hold most of them), and its share precedes CTA
  // j + 1's; a level whose keys fit half a slice goes whole to CTA 0 (Q =
  // count), where one sort costs less than the merge rounds. Unless every
  // live lb is equal (then rank order is the order), each CTA sorts its share
  // and log2(c) rounds merge the runs.
  const int Q = 2 * total <= a.slice ? total : (total + c - 1) / c;
  const int r0 = min(j * Q, total), nq = min(r0 + Q, total) - r0;
  const bool uniform = sh->uniform;
  *p_out = Q;
  if constexpr (!kSolo) {
    for (int b = tid; b < nq; b += nt * kBatch) {
      unsigned long long v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = r0 + b + k * nt;
        if (b + k * nt < nq) {
          int o = 0;
          while (o + 1 < c && sh->prefix[o + 1] <= r) ++o;
          v[k] = peer_keys<kOnChip, false>(x, o)[sw(r - sh->prefix[o])];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (b + k * nt < nq) x.spare[sw(b + k * nt)] = v[k];
      }
    }
    cluster_sync<false>();  // every CTA has its share: the keys may be overwritten
    if (uniform) {
      for (int i = tid; i < nq; i += nt) x.keys[sw(i)] = x.spare[sw(i)];
    } else {
      local_sort<kItems<kSolo>>(x.spare, x.keys, x.spare, nq);
      for (int half = 1; Q < total && half < c; half <<= 1) {
        cluster_sync<false>();  // the round's runs are complete
        merge_round<kOnChip>(x, a.cap, total, half, Q);
      }
    }
  } else if (!uniform) {
    local_sort<kItems<kSolo>>(x.keys, x.keys, x.spare, nq);
  }
  cluster_sync<kSolo>();  // the slots are complete in every CTA
  return keep;
}

// The descent of one tile on its cluster (kSolo: on one block, with no
// cluster code compiled in).
template <bool kOnChip, bool kSolo>
__device__ __forceinline__ void run_tile(const FrontierArgs& a, unsigned char* smem_raw) {
  Cta x;
  x.c = kSolo ? 1 : a.cluster;
  x.rank = kSolo ? 0 : static_cast<int>(blockIdx.x) % a.cluster;  // clusters (c, 1, 1) along x
  x.tile = kSolo ? static_cast<long long>(blockIdx.x)
                 : static_cast<long long>(blockIdx.x) / a.cluster;
  x.sh = reinterpret_cast<Shared*>(smem_raw);
  if constexpr (kOnChip) {
    x.keys = reinterpret_cast<unsigned long long*>(smem_raw + kSharedBytes);
    x.stride = 0;
  } else {
    x.stride = 2LL * a.slice;
    x.keys = a.keys + static_cast<long long>(blockIdx.x) * x.stride;
  }
  x.spare = x.keys + a.slice;
  const float* blo = a.box_lo + x.tile * a.D;
  const float* bhi = a.box_hi + x.tile * a.D;
  const float bound = a.bound[x.tile];
  // every CTA of the cluster runs before any touches another's shared memory
  // (a CTA with no start-level position reaches its first DSMEM store at once)
  if constexpr (!kSolo) cg::this_cluster().sync();

  bool overflowed = false;
  int P = 0, next = 0;
  int n_live = descend<kOnChip, kSolo>(a, x, 1 << a.start, 0, 0, false, blo, bhi, bound, &P,
                                       &overflowed);
  for (int level = a.start; level < a.levels && n_live > 0; ++level) {
    n_live = descend<kOnChip, kSolo>(a, x, 2 * n_live, n_live, P, true, blo, bhi, bound,
                                     &next, &overflowed);
    P = next;
  }

  // this CTA's slots out, then its share of the padding
  const long long row = x.tile * a.cap;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int e0 = min(x.rank * P, n_live), e1 = min(e0 + P, n_live);
  for (int e = e0 + tid; e < e1; e += nt) {
    const unsigned long long slot = x.keys[sw(e - x.rank * P)];
    a.bucket[row + e] = static_cast<int>(static_cast<unsigned>(slot)) - a.first_leaf;
    a.lb[row + e] = __uint_as_float(static_cast<unsigned>(slot >> 32));
  }
  for (int e = n_live + x.rank * nt + tid; e < a.cap; e += x.c * nt) {
    a.bucket[row + e] = -1;
    a.lb[row + e] = INFINITY;
  }
  if (x.rank == 0 && tid == 0) a.overflow[x.tile] = overflowed ? 1 : 0;
  if constexpr (!kSolo) cg::this_cluster().sync();  // no CTA leaves while a peer may read it
}

template <bool kOnChip>
__global__ void __launch_bounds__(kSoloThreads, 4) frontier_kernel_solo(const FrontierArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  run_tile<kOnChip, true>(a, smem_raw);
}

template <bool kOnChip>
__global__ void __launch_bounds__(kMaxThreads) frontier_kernel_cluster(const FrontierArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  run_tile<kOnChip, false>(a, smem_raw);
}

}  // namespace

// node_lo / node_hi f32[H, D], box_lo / box_hi f32[T, D], bound f32[T] ->
// bucket i32[T, cap] (-1 padding), lb f32[T, cap] (+inf padding), overflow
// u8[T]; contiguous device memory. start = min(floor(log2 cap), levels);
// cluster (1, 2, 4, 8 or 16) CTAs a tile, each holding `slice` keys (a power
// of two >= ceil(widest level / cluster)) twice: in shared memory when keys
// is null, else in keys u64[T cluster, 2 slice] of device memory; threads a
// multiple of 32 up to 1024
// (512 when cluster is 1). Launches on `stream` through cudaLaunchKernelEx (a
// cluster dimension when cluster > 1). Returns the CUDA error of the launch
// (0 = cudaSuccess; nothing is launched when T is 0); a size the card refuses
// is an error, never retried.
extern "C" int frontier_launch(const void* node_lo, const void* node_hi, const void* box_lo,
                               const void* box_hi, const void* bound, void* bucket, void* lb,
                               void* overflow, void* keys, int T, int D, int cap,
                               int start, int levels, int first_leaf, int cluster, int slice,
                               int threads, void* stream) {
  if (T <= 0) return 0;
  const bool on_chip = keys == nullptr;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 || slice < 1 ||
      threads < 32 || threads > (cluster > 1 ? kMaxThreads : kSoloThreads) ||
      threads % 32 != 0 || static_cast<long long>(T) * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FrontierArgs a;
  a.node_lo = static_cast<const float*>(node_lo);
  a.node_hi = static_cast<const float*>(node_hi);
  a.box_lo = static_cast<const float*>(box_lo);
  a.box_hi = static_cast<const float*>(box_hi);
  a.bound = static_cast<const float*>(bound);
  a.bucket = static_cast<int*>(bucket);
  a.lb = static_cast<float*>(lb);
  a.overflow = static_cast<unsigned char*>(overflow);
  a.keys = static_cast<unsigned long long*>(keys);
  a.D = D;
  a.cap = cap;
  a.start = start;
  a.levels = levels;
  a.first_leaf = first_leaf;
  a.cluster = cluster;
  a.slice = slice;
  const size_t smem = kSharedBytes + (on_chip ? static_cast<size_t>(slice) * 2 * 8 : 0);
  void (*kernel)(const FrontierArgs) =
      cluster > 1 ? (on_chip ? frontier_kernel_cluster<true> : frontier_kernel_cluster<false>)
                  : (on_chip ? frontier_kernel_solo<true> : frontier_kernel_solo<false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(T * cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the launch error is returned, not left for a later call
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
