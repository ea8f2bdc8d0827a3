// The Morton tree's per-query best-first DFS as one kernel: the walk over
// the bucket heap, the scans of its collected buckets and the k best per
// query, with no host look between steps.
//
// Replaces no TPU kernel: the JAX package runs this DFS as the XLA program
// kdtree_tpu/ops/morton.py::_morton_knn_one (:403), vmapped over a chunk of
// queries. Its plain PyTorch version is the lockstep loop
// kdtree_tpu_torch/ops/morton.py::_morton_knn_batch, which this kernel
// matches bit for bit (d2 and ids), and
// kdtree_tpu_torch/kernels/morton_dfs.py::morton_dfs_mirror follows this
// source's control flow step for step on the CPU. What is kept of the
// reference, query by query (lanes of the lockstep loop never interact, so
// running each query to its end alone gives the same answer):
// - The stack of (node, bound), the root pre-pushed with bound 0. A popped
//   entry is visited only if bound < worst (strictly), worst being the
//   k-list's last entry, which changes only after a scan. An internal node
//   bounds both children (2n+1, 2n+2, clamped to the heap) and pushes the
//   farther first, so the nearer is visited first (swap = bd[0] < bd[1]: on
//   a tie c1 is pushed first), each only if its own bound < worst. A
//   visited leaf joins the round's bucket list; a round ends at kV buckets
//   or an empty stack, and scans only if it holds one.
// - The box bound: per axis the gap max(max(lo - q, q - hi), 0), NaN
//   passed on as torch.maximum and clamp_min pass it, folded by d2.cuh's
//   FMA chain from 0 (window_sum above 32 axes). An empty node (lo = +inf,
//   hi = -inf) bounds at +inf and is never pushed. The leaf distances are
//   d2.cuh's point_d2 (diff = q - p), +inf at the +inf padding rows.
// - The fold of a round (kdtree_tpu/ops/topk.py::merge_topk): first the
//   kk = min(k, V B) smallest candidates of the block by (d2, position),
//   lax.top_k's rule, position being bucket-list order then slot; only then
//   a merge with the k-list by (d2, id), the list's entries first among
//   equal keys. Candidates above worst can enter neither (the list's k
//   entries all sort before them), and those at or below it are a prefix of
//   the (d2, position) order, so the kernel keeps the survivors (d2 <= worst,
//   finite) only, selects the k smallest of them by (d2, position) and
//   merges those by (d2, id). Both are selections of 64-bit keys, (d2
//   bits << 32 | position) and (d2 bits << 32 | id with its sign bit
//   flipped), d2 being finite and never -0; positions are distinct, and so
//   are a tree's ids (a merge puts the list's entries first among equal
//   keys all the same). A +inf
//   candidate never enters: every +inf entry of the list is (+inf, -1),
//   which sorts first, so the list's +inf slots keep id -1.
//
// What bounds it on the card (clock64() stamps, NVIDIA H100): at a few
// queries the kernel's time is its slowest query's, a chain of dependent
// steps. In the one-warp-a-query kernel this replaces, the headline's
// slowest query (10 x 1-NN) spent 55% of its cycles in the scan (each
// wave's loads waited on one another, ~2,400 cycles a wave of 128 rows),
// 25% in the walk (~430 cycles an expansion, two child boxes read from
// memory), 17% inserting survivors one by one; at k = 16 the insertions
// were 42%. Here the walk is what is left: about half the slowest query's
// cycles in the block layout, a few hundred cycles a step of pops, shared
// memory reads and compares that depend on one another. At many queries,
// the scanned buckets' bytes and the warps in flight to hide them.
//
// Design:
// - Two layouts of one code, chosen by the wrapper. The warp layout
//   (morton_dfs_kernel_warp, large batches): one warp a query, kWarpQ
//   queries a block, no block barrier. The block layout
//   (morton_dfs_kernel_block, small batches): one block of kBlockW warps a
//   query; warp 0 walks, all warps scan and select, warp 0 merges. Both
//   give the same bits.
// - The walk's state is warp-uniform (every lane holds the same sp, node,
//   bound and worst). The stack (at most 2 * 31 + 2 entries) lives in
//   registers: entry e in lane e & 31, slot e >> 5.
// - Windows of the heap: the levels are cut into bands of kL from the
//   leaves up; expanding a node needs its children's bounds, which lie in
//   the window of the band of the children's depth rooted at the node's
//   ancestor at the band's top. A window's 62 boxes (2 a lane, each level a
//   contiguous run of the heap) are read and bounded at once into shared
//   memory, one window a band kept, so an expansion reads two bounds from
//   shared memory and the walk reloads only when it moves to another
//   subtree. The bounds are the same floats, so the walk's pops, tests and
//   pushes are the reference's.
// - A scan: a warp's positions of the round (all of them in the warp
//   layout; a contiguous share, in warp order, in the block layout) in
//   batches of kUWarp or kUBlock rows a lane, all loaded before any is
//   tested. A ballot a 32 finds the survivors below the selection's last
//   key (while it is full), and they go to a buffer in position order; in
//   the block layout, a batch of more than 32 survivors at k <= 32 keeps
//   only those at or below the k-th smallest of the lanes' least keys
//   (k lanes hold a key at or below it, so the batch's k smallest do).
//   Then the buffer, 32 at a time: tested again against the selection's
//   last key, which tightens as it goes, sorted by a bitonic network over
//   shuffles and merged into the selection (ascending, at most k) by
//   ranks: each new key's rank in the list (a binary search) and each list
//   entry's rank among the new keys (a search over shuffles), written from
//   the top chunk down, in place.
// - The block layout joins its warps' selections by rank (an entry's rank
//   is its index plus its rank in every other warp's list), so the round's
//   selection is the k smallest of the whole round by (d2, position).
// - The selection then merges into the k-list by (d2, id), 32 entries at a
//   time re-keyed, sorted and merged the same way.
// - Lists up to kSmemK entries live in shared memory, longer ones in
//   device memory (a scratch the wrapper allocates), the same code through
//   generic pointers. At D != 3 the query row is staged in shared memory.
// - A measurement, off unless the caller passes its buffers: the child
//   boxes and buckets the walk reads (byte flags), its box bounds and
//   scanned pairs and the boxes the windows load (counters), and clock64()
//   sums per query (walk, scan, select, merge, and the walk's window loads;
//   their own instantiation).

#include <cuda_runtime.h>
#include <limits.h>

#include "d2.cuh"

namespace {

using namespace kdt;

constexpr int kV = 8;           // buckets a scan round (_QUERY_COLLECT)
constexpr int kSmemK = 64;      // lists up to this length in shared memory
constexpr int kMaxStack = 64;   // 2 * num_levels + 2 for num_levels <= 31
constexpr int kL = 5;           // levels a window: 2 + 4 + ... + 32 = 62 boxes
constexpr int kBands = 7;       // windows kept: 31 levels in bands of kL
constexpr int kWarpQ = 4;       // warp layout: queries a block
constexpr int kBlockW = 8;      // block layout: warps a query
// rows a lane loads before any is tested, by layout and width (measured on
// the card: more rows in flight at D = 3 in the block layout, where one
// batch is a warp's share of a round of 256-row buckets; fewer where they
// cost occupancy)
template <int DC> constexpr int kUBlock = DC == 3 ? 8 : 4;
template <int DC> constexpr int kUWarp = DC == 3 ? 4 : 8;
// blocks an SM each kernel is compiled for (its registers a thread): ptxas
// left to itself traded spills for occupancy; these bounds give none (the
// stamped kernels hold more registers)
template <int DC, bool kStamps> constexpr int kWarpBlocksPerSM = DC == 3 ? (kStamps ? 6 : 7) : 1;
template <bool kStamps> constexpr int kBlockBlocksPerSM = kStamps ? 2 : 3;
constexpr int kQSmemBytes = 32 * 1024;  // query rows staged up to this size
constexpr int kStampCols = 6;   // total, walk, scan, select, merge, windows
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;  // above every key

struct DfsArgs {
  const float* q;            // [Q, D]
  const float* lo;           // [H, D] node boxes
  const float* hi;           // [H, D]
  const float* pts;          // [NB, B, D] (+inf padding rows)
  const int* gid;            // [NB, B] (-1 padding)
  float* out_d;              // [Q, k]
  int* out_i;                // [Q, k]
  unsigned long long* scr_key;  // [Q, nkey * k]: lists past kSmemK
  int* scr_id;               // [Q, nid * k]
  unsigned char* node_seen;  // [H] or null: child boxes read
  unsigned char* bucket_seen;  // [NB] or null: buckets scanned
  unsigned long long* work;  // [3] or null: box bounds, scanned pairs, window boxes
  long long* stamps;         // [Q, kStampCols] clock64 sums (the stamped build)
  long long Q;
  int D, B, k, nb, heap, nkey, nid;
  int q_smem;                // the query rows are staged in shared memory
};

// One query's walk state in shared memory: a window of bounds per band,
// the window's root (-1: none), the round's bucket list.
struct __align__(16) Walk {
  float win[kBands][64];
  int root[kBands];
  int bl[kV];
  int nb;
  float worst;
};

__device__ __forceinline__ unsigned long long shfl64(unsigned long long v, int src) {
  const unsigned lo = __shfl_sync(kFull, static_cast<unsigned>(v), src);
  const unsigned hi = __shfl_sync(kFull, static_cast<unsigned>(v >> 32), src);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned long long shfl64_xor(unsigned long long v, int m) {
  const unsigned lo = __shfl_xor_sync(kFull, static_cast<unsigned>(v), m);
  const unsigned hi = __shfl_xor_sync(kFull, static_cast<unsigned>(v >> 32), m);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned long long d2_key(float d2, unsigned low) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | low;
}

// An id as the low word of a (d2, id) key, in the order of signed ids.
__device__ __forceinline__ unsigned id_bits(int id) {
  return static_cast<unsigned>(id) ^ 0x80000000u;
}

__device__ __forceinline__ float key_d2(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ long long stamp() { return clock64(); }

// The stamped build's sums go straight to the query's row of stamps (t,
// null on the warps that do not report), by one lane.
__device__ __forceinline__ void stamp_add(long long* t, int col, long long dt, int lane) {
  if (t && lane == 0) atomicAdd(reinterpret_cast<unsigned long long*>(t + col), dt);
}

// One axis's gap from q to [lo, hi], as torch.maximum and clamp_min take
// it (kdtree_tpu_torch/ops/morton.py::_bbox_d2): a NaN difference stays NaN.
__device__ __forceinline__ float dfs_gap(float q, float lo, float hi) {
  const float a = __fsub_rn(lo, q);
  const float b = __fsub_rn(q, hi);
  const float m = (a > b || a != a) ? a : b;
  return (m > 0.f || m != m) ? m : 0.f;
}

// The bounds of two boxes (rows n0, n1 of lo/hi), their loads issued
// together.
template <int DC>
__device__ __forceinline__ void node_bounds(const DfsArgs& a, long long n0, long long n1,
                                            const float* qv, const float* qrow, float& b0,
                                            float& b1) {
  const int D = a.D;
  const float* lo0 = a.lo + n0 * D;
  const float* hi0 = a.hi + n0 * D;
  const float* lo1 = a.lo + n1 * D;
  const float* hi1 = a.hi + n1 * D;
  float acc0 = 0.f, acc1 = 0.f;
  if constexpr (DC > 0) {
    float l0[DC], h0[DC], l1[DC], h1[DC];
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      l0[d] = lo0[d];
      h0[d] = hi0[d];
      l1[d] = lo1[d];
      h1[d] = hi1[d];
    }
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      const float g0 = dfs_gap(qv[d], l0[d], h0[d]);
      const float g1 = dfs_gap(qv[d], l1[d], h1[d]);
      acc0 = __fmaf_rn(g0, g0, acc0);
      acc1 = __fmaf_rn(g1, g1, acc1);
    }
  } else if (D > 32) {
    acc0 = window_sum(D, [&](int d) { return dfs_gap(qrow[d], lo0[d], hi0[d]); });
    acc1 = window_sum(D, [&](int d) { return dfs_gap(qrow[d], lo1[d], hi1[d]); });
  } else {
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float g0 = dfs_gap(qd, lo0[d], hi0[d]);
      const float g1 = dfs_gap(qd, lo1[d], hi1[d]);
      acc0 = __fmaf_rn(g0, g0, acc0);
      acc1 = __fmaf_rn(g1, g1, acc1);
    }
  }
  b0 = acc0;
  b1 = acc1;
}

// The window of `band` rooted at node r, nl levels below it: slot s holds
// the bound of node ((r + 1) << j) - 1 + (s + 2 - 2^j) at level j =
// floor(log2(s + 2)) below r, two slots a lane.
template <int DC>
__device__ __forceinline__ int load_window(const DfsArgs& a, Walk& w, int band, int r, int nl,
                                           const float* qv, const float* qrow, int lane) {
  const int nslots = (2 << nl) - 2;
  long long node[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    const int j = 31 - __clz(s + 2);
    node[h] = s < nslots ? (static_cast<long long>(r + 1) << j) - 1 + (s + 2 - (1 << j)) : r;
  }
  float b0, b1;
  node_bounds<DC>(a, node[0], node[1], qv, qrow, b0, b1);
  if (lane < nslots) w.win[band][lane] = b0;
  if (lane + 32 < nslots) w.win[band][lane + 32] = b1;
  w.root[band] = r;  // every lane writes the same
  __syncwarp();
  return nslots;
}

// The walk's registers: the stack (entry e in lane e & 31, slot e >> 5).
struct Stack {
  int n0, n1;
  float b0, b1;
  int sp;
};

// Collect the next round's buckets into w.bl: pop until kV buckets are
// held or the stack is empty, and on until one is held or the stack is
// empty. Returns the count (0: the walk is over). An expansion that pushes
// its nearer child would pop it next: the child is taken as the next entry
// without going through the stack.
template <int DC, bool kStamps>
__device__ __forceinline__ int collect(const DfsArgs& a, Walk& w, Stack& st, float worst,
                                       const float* qv, const float* qrow, int lane,
                                       unsigned& n_box, unsigned& n_win,
                                       long long* t) {
  const int first_leaf = a.nb - 1;
  const int last = a.heap - 1;
  const int ld = 31 - __clz(a.nb);  // the leaves' depth
  int nb = 0;
  bool held = false;  // node and bound hold the next entry
  int node = 0;
  float bound = 0.f;
  while ((st.sp > 0 || held) && nb == 0) {
    while ((st.sp > 0 || held) && nb < kV) {
      if (!held) {
        const int top = st.sp - 1;
        const int src = top & 31;
        const int n0 = __shfl_sync(kFull, st.n0, src);
        const int n1 = __shfl_sync(kFull, st.n1, src);
        const float b0 = __shfl_sync(kFull, st.b0, src);
        const float b1 = __shfl_sync(kFull, st.b1, src);
        node = top < 32 ? n0 : n1;
        bound = top < 32 ? b0 : b1;
        st.sp = top;
      }
      held = false;
      if (!(bound < worst)) continue;
      if (node >= first_leaf) {
        w.bl[nb] = node - first_leaf;  // every lane writes the same
        ++nb;
        continue;
      }
      const int c1 = min(2 * node + 1, last);  // a complete heap: never clamped
      const int c2 = min(2 * node + 2, last);
      // the children's depth, its band and the window's root
      const int dn = 31 - __clz(node + 1);
      const int band = (ld - dn - 1) / kL;
      const int rdep = max(0, ld - kL * (band + 1));
      const int r = ((node + 1) >> (dn - rdep)) - 1;
      const int j = dn + 1 - rdep;
      const int slot = (1 << j) - 2 + 2 * (node + 1) - ((r + 1) << j);  // c1's; even
      float2 bd = *reinterpret_cast<const float2*>(&w.win[band][slot]);
      if (w.root[band] != r) {
        const long long t0 = kStamps ? clock64() : 0;
        n_win += load_window<DC>(a, w, band, r, ld - kL * band - rdep, qv, qrow, lane);
        bd = *reinterpret_cast<const float2*>(&w.win[band][slot]);
        if (kStamps) stamp_add(t, 5, clock64() - t0, lane);
      }
      if (a.node_seen && lane < 2) a.node_seen[lane ? c2 : c1] = 1;
      n_box += 2;
      const bool swap = bd.x < bd.y;  // push the nearer child last
      const int fc = swap ? c2 : c1;
      const float fb = swap ? bd.y : bd.x;
      if (fb < worst && st.sp < kMaxStack) {
        if (lane == (st.sp & 31)) {
          if (st.sp < 32) { st.n0 = fc; st.b0 = fb; } else { st.n1 = fc; st.b1 = fb; }
        }
        ++st.sp;
      }
      node = swap ? c1 : c2;  // the nearer child: pushed, then popped next
      bound = swap ? bd.x : bd.y;
      held = bound < worst;
    }
  }
  __syncwarp();
  return nb;
}

// Ascending over the warp's lanes: a bitonic network over shuffles; ids
// travel with their keys.
template <bool kIds>
__device__ __forceinline__ void sort32(unsigned long long& key, int& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other = shfl64_xor(key, stride);
      int other_id = 0;
      if constexpr (kIds) other_id = __shfl_xor_sync(kFull, id, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      if (low == up ? other < key : other > key) {
        key = other;
        if constexpr (kIds) id = other_id;
      }
    }
  }
}

// The number of keys of the warp's sorted group (lane l holds the l-th)
// below x.
__device__ __forceinline__ int group_rank(unsigned long long gk, unsigned long long x) {
  int c = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (shfl64(gk, c + step - 1) < x) c += step;
  }
  if (shfl64(gk, c) < x) ++c;
  return c;
}

// The number of entries of the ascending list l[0, n) at or below x.
__device__ __forceinline__ int list_rank(const unsigned long long* l, int n, unsigned long long x) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (l[lo + h] <= x) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

// The list (ascending, n <= k entries) takes the warp's sorted group (g
// real keys in lanes 0..g-1, kNone above): it becomes the min(k, n + g)
// smallest of both, ascending, the list's entries first among equal keys.
// Each key goes to its rank in the union: a group key's by a search of the
// list (before anything moves), a list entry's by a search of the group;
// the list's chunks move from the top down, each read before it is
// written. Returns the new length.
template <bool kIds>
__device__ __forceinline__ int merge_group(unsigned long long* lk, int* li, int n, int k,
                                           unsigned long long gk, int gi, int g, int lane) {
  const int to = lane < g ? lane + list_rank(lk, n, gk) : INT_MAX;
  __syncwarp();
  for (int c = (n - 1) >> 5; c >= 0; --c) {
    const int e = (c << 5) + lane;
    unsigned long long x = kNone;
    int xi = 0;
    if (e < n) {
      x = lk[e];
      if constexpr (kIds) xi = li[e];
    }
    const int r = e + group_rank(gk, x);
    __syncwarp();
    if (e < n && r < k) {
      lk[r] = x;
      if constexpr (kIds) li[r] = xi;
    }
    __syncwarp();
  }
  if (to < k) {
    lk[to] = gk;
    if constexpr (kIds) li[to] = gi;
  }
  __syncwarp();
  return min(k, n + g);
}

// A selection: ascending (d2, position) keys and their ids, n entries,
// thr its last key once it holds k (the counts and thr in registers), and
// a buffer (shared memory, 32 kU entries) for one batch's survivors.
struct Sel {
  unsigned long long* key;
  int* id;
  int n;
  unsigned long long thr;
  unsigned long long* bk;
  int* bi;
};


// One survivor a lane (pass) into the batch's buffer in position order.
__device__ __forceinline__ void append(Sel& s, int& c, bool pass, unsigned long long key,
                                       int cid, int lane) {
  const unsigned m = __ballot_sync(kFull, pass);
  if (pass) {
    const int at = c + __popc(m & ((1u << lane) - 1));
    s.bk[at] = key;
    s.bi[at] = cid;
  }
  c += __popc(m);
}

// The batch's c buffered survivors into the selection, 32 at a time: each
// tested again against thr (it tightens as they go), sorted and merged.
__device__ __forceinline__ void merge_batch(Sel& s, int c, int k, int lane) {
  __syncwarp();
  for (int b = 0; b < c; b += 32) {
    const int e = b + lane;
    unsigned long long gk = e < c ? s.bk[e] : kNone;
    int gi = s.bi[e < c ? e : 0];
    if (s.n == k && gk >= s.thr) gk = kNone;
    const unsigned m = __ballot_sync(kFull, gk != kNone);
    if (m == 0) continue;
    if (m != 1u) sort32<true>(gk, gi, lane);  // one survivor in lane 0 is sorted
    s.n = merge_group<true>(s.key, s.id, s.n, k, gk, gi, __popc(m), lane);
    if (s.n == k) s.thr = s.key[k - 1];
  }
}

// The warp's positions [p0, p1) of the round (bucket-list order, then
// slot) into its selection. A batch: kU rows a lane, all loaded before any
// is tested (above 32 axes one row a lane at a time, each row's axes in
// order); the survivors (d2 <= worst, finite, below thr while the
// selection is full; with kBound, more than 32 of them and k <= 32, at
// or below the k-th smallest of the lanes' least keys) go to the buffer in
// position order; merge_batch.
template <int DC, int kU, bool kBound, bool kStamps>
__device__ __forceinline__ void scan_range(const DfsArgs& a, const Walk& w, Sel& s, int p0,
                                           int p1, float worst, const float* qv,
                                           const float* qrow, int lane, long long* t) {
  const int B = a.B, D = a.D, k = a.k;
  const float kInf = __int_as_float(0x7f800000);
  // the lane's next position (32 on from the last): its bucket-list entry
  // j and slot sl, carried from row to row without a division
  int j = (p0 + lane) / B;
  int sl = p0 + lane - j * B;
  auto next_row = [&](int p) {
    const unsigned row = p < p1 ? static_cast<unsigned>(w.bl[j < kV ? j : 0]) * B + sl : 0u;
    for (sl += 32; sl >= B; sl -= B) ++j;
    return row;
  };
  for (int base = p0; base < p1; base += 32 * kU) {
    const long long t0 = kStamps ? stamp() : 0;
    long long t1 = t0;
    int c = 0;  // the batch's survivors
    if (DC == 0 && D > 32) {
#pragma unroll 1
      for (int u = 0; u < kU; ++u) {
        const int p = base + 32 * u + lane;
        const unsigned row = next_row(p);
        const int cid = a.gid[row];
        const float cd = point_d2<0>(a.pts + static_cast<size_t>(row) * D, qv, qrow, D);
        const unsigned long long key = d2_key(cd, static_cast<unsigned>(p));
        append(s, c, p < p1 && cd <= worst && cd < kInf && (s.n < k || key < s.thr), key, cid,
               lane);
      }
    } else {
      unsigned row[kU];  // the wrapper holds NB * B below 2^32
      float cd[kU];
      int cid[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) row[u] = next_row(base + 32 * u + lane);
#pragma unroll
      for (int u = 0; u < kU; ++u) cid[u] = a.gid[row[u]];
      if constexpr (DC == 3) {
        float x[kU], y[kU], z[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float* pr = a.pts + static_cast<size_t>(row[u]) * 3;
          x[u] = pr[0];
          y[u] = pr[1];
          z[u] = pr[2];
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) cd[u] = d2_3(qv, x[u], y[u], z[u]);
      } else {
#pragma unroll
        for (int u = 0; u < kU; ++u) cd[u] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float qd = qrow[d];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float diff = __fsub_rn(qd, a.pts[static_cast<size_t>(row[u]) * D + d]);
            cd[u] = __fmaf_rn(diff, diff, cd[u]);
          }
        }
      }
      if (kStamps) {  // wait for the loads before the stamp
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < kU; ++u) acc += cd[u] + static_cast<float>(cid[u]);
        if (__float_as_int(__shfl_sync(kFull, acc, 0)) == 0x7fc01234) cd[0] = 0.f;
        t1 = stamp();
      }
      // more than 32 survivors and k <= 32: the k-th smallest of the lanes'
      // least keys bounds the batch's k smallest, so only keys at or below
      // it can enter the selection
      unsigned long long bound = kNone;
      if (kBound && k <= 32) {
        int n_pass = 0;
        unsigned long long least = kNone;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int p = base + 32 * u + lane;
          const unsigned long long key = d2_key(cd[u], static_cast<unsigned>(p));
          const bool pass =
              p < p1 && cd[u] <= worst && cd[u] < kInf && (s.n < k || key < s.thr);
          n_pass += __popc(__ballot_sync(kFull, pass));
          if (pass && key < least) least = key;
        }
        if (n_pass > 32 && k == 1) {  // the least of the lanes' least keys
#pragma unroll
          for (int m = 16; m > 0; m >>= 1) {
            const unsigned long long other = shfl64_xor(least, m);
            least = other < least ? other : least;
          }
          bound = least;
        } else if (n_pass > 32) {
          int unused = 0;
          sort32<false>(least, unused, lane);
          bound = shfl64(least, k - 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int p = base + 32 * u + lane;
        const unsigned long long key = d2_key(cd[u], static_cast<unsigned>(p));
        append(s, c,
               p < p1 && cd[u] <= worst && cd[u] < kInf && (s.n < k || key < s.thr) &&
                   key <= bound,
               key, cid[u], lane);
      }
    }
    merge_batch(s, c, k, lane);
    if (kStamps) {
      stamp_add(t, 2, t1 - t0, lane);
      stamp_add(t, 3, stamp() - t1, lane);
    }
  }
}

// The selection (ascending by (d2, position), n entries) into the k-list
// by (d2, id): 32 entries at a time re-keyed, sorted and merged. Returns
// the list's new last d2.
__device__ __forceinline__ float merge_klist(unsigned long long* kl, const unsigned long long* sk,
                                             const int* si, int n, int k, int lane) {
  for (int c = 0; c < n; c += 32) {
    const int e = c + lane;
    unsigned long long gk = e < n ? (sk[e] & 0xffffffff00000000ull) | id_bits(si[e]) : kNone;
    int unused = 0;
    if (n - c > 1) sort32<false>(gk, unused, lane);  // one entry is sorted
    merge_group<false>(kl, nullptr, k, k, gk, 0, min(32, n - c), lane);
  }
  return key_d2(kl[k - 1]);
}

// A query's start: its row in registers (D = 3) or staged in shared memory
// (`stage`, lanes `lane` of `nthreads`), the k-list at (+inf, -1), no
// window.
template <int DC>
__device__ __forceinline__ const float* start_query(const DfsArgs& a, long long qi, float* stage,
                                                    float* qv, Walk& w, unsigned long long* kl,
                                                    int t, int nthreads) {
  const float* qrow = a.q + qi * a.D;
  if constexpr (DC > 0) {
#pragma unroll
    for (int d = 0; d < DC; ++d) qv[d] = qrow[d];
  } else if (a.q_smem) {
    for (int d = t; d < a.D; d += nthreads) stage[d] = qrow[d];
    qrow = stage;
  }
  for (int e = t; e < a.k; e += nthreads) kl[e] = d2_key(__int_as_float(0x7f800000), id_bits(-1));
  for (int b = t; b < kBands; b += nthreads) w.root[b] = -1;
  return qrow;
}

__device__ __forceinline__ void finish_query(const DfsArgs& a, long long qi,
                                             const unsigned long long* kl, int t, int nthreads) {
  for (int e = t; e < a.k; e += nthreads) {
    const unsigned long long x = kl[e];
    a.out_d[qi * a.k + e] = key_d2(x);
    a.out_i[qi * a.k + e] = static_cast<int>(static_cast<unsigned>(x) ^ 0x80000000u);
  }
}

__device__ __forceinline__ void count_work(const DfsArgs& a, unsigned n_box, unsigned n_pairs,
                                           unsigned n_win) {
  if (a.work) {
    atomicAdd(a.work, static_cast<unsigned long long>(n_box));
    atomicAdd(a.work + 1, static_cast<unsigned long long>(n_pairs));
    atomicAdd(a.work + 2, static_cast<unsigned long long>(n_win));
  }
}

// ---- the warp layout: one warp a query, kWarpQ queries a block

template <int DC, bool kStamps>
__global__ void __launch_bounds__(kWarpQ * 32, kWarpBlocksPerSM<DC, kStamps>)
    morton_dfs_kernel_warp(const DfsArgs a) {
  __shared__ Walk s_walk[kWarpQ];
  __shared__ unsigned long long s_kl[kWarpQ][kSmemK];
  __shared__ unsigned long long s_sk[kWarpQ][kSmemK];
  __shared__ int s_si[kWarpQ][kSmemK];
  __shared__ unsigned long long s_bk[kWarpQ][32 * kUWarp<DC>];
  __shared__ int s_bi[kWarpQ][32 * kUWarp<DC>];
  extern __shared__ float s_q[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qi = static_cast<long long>(blockIdx.x) * kWarpQ + warp;
  if (qi >= a.Q) return;  // the whole warp: no barrier below waits on it
  const int k = a.k;
  long long* const t = kStamps ? a.stamps + qi * kStampCols : nullptr;
  const long long t_start = kStamps ? stamp() : 0;

  Walk& w = s_walk[warp];
  const bool smem = k <= kSmemK;
  unsigned long long* kl = smem ? s_kl[warp] : a.scr_key + qi * a.nkey * k;
  Sel s{smem ? s_sk[warp] : a.scr_key + qi * a.nkey * k + k,
        smem ? s_si[warp] : a.scr_id + qi * a.nid * k, 0, 0, s_bk[warp], s_bi[warp]};
  float qv[DC > 0 ? DC : 1];
  const float* qrow = start_query<DC>(a, qi, s_q + warp * a.D, qv, w, kl, lane, 32);
  __syncwarp();

  Stack st{0, 0, 0.f, 0.f, 1};  // the root (node 0, bound 0) is entry 0
  float worst = __int_as_float(0x7f800000);
  unsigned n_box = 0, n_pairs = 0, n_win = 0;  // a query's: the wrapper holds NB * B below 2^32
  for (;;) {
    const long long t0 = kStamps ? stamp() : 0;
    const int nb = collect<DC, kStamps>(a, w, st, worst, qv, qrow, lane, n_box, n_win, t);
    if (kStamps) stamp_add(t, 1, stamp() - t0, lane);
    if (nb == 0) break;
    if (a.bucket_seen && lane < nb) a.bucket_seen[w.bl[lane]] = 1;
    const int total = nb * a.B;
    n_pairs += static_cast<unsigned>(total);
    s.n = 0;
    scan_range<DC, kUWarp<DC>, false, kStamps>(a, w, s, 0, total, worst, qv, qrow, lane, t);
    const long long t1 = kStamps ? stamp() : 0;
    worst = merge_klist(kl, s.key, s.id, s.n, k, lane);
    if (kStamps) stamp_add(t, 4, stamp() - t1, lane);
  }
  finish_query(a, qi, kl, lane, 32);
  if (lane == 0) count_work(a, n_box, n_pairs, n_win);
  if (kStamps) stamp_add(t, 0, stamp() - t_start, lane);
}

// ---- the block layout: one block of kBlockW warps a query

template <int DC, bool kStamps>
__global__ void __launch_bounds__(kBlockW * 32, kBlockBlocksPerSM<kStamps>)
    morton_dfs_kernel_block(const DfsArgs a) {
  __shared__ Walk w;
  __shared__ unsigned long long s_kl[kSmemK];
  __shared__ unsigned long long s_sk[kBlockW + 1][kSmemK];  // each warp's, then the join
  __shared__ int s_si[kBlockW + 1][kSmemK];
  __shared__ int s_n[kBlockW];
  __shared__ unsigned long long s_bk[kBlockW][32 * kUBlock<DC>];
  __shared__ int s_bi[kBlockW][32 * kUBlock<DC>];
  extern __shared__ float s_q[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qi = blockIdx.x;
  const int k = a.k;
  long long* const t = kStamps && warp == 0 ? a.stamps + qi * kStampCols : nullptr;
  const long long t_start = kStamps ? stamp() : 0;

  const bool smem = k <= kSmemK;
  unsigned long long* const keys = a.scr_key + qi * a.nkey * k;  // used only past kSmemK
  int* const ids = a.scr_id + qi * a.nid * k;
  unsigned long long* kl = smem ? s_kl : keys;
  auto sel_key = [&](int v) { return smem ? s_sk[v] : keys + (1 + v) * k; };
  auto sel_id = [&](int v) { return smem ? s_si[v] : ids + v * k; };
  Sel s{sel_key(warp), sel_id(warp), 0, 0, s_bk[warp], s_bi[warp]};
  float qv[DC > 0 ? DC : 1];
  const float* qrow = start_query<DC>(a, qi, s_q, qv, w, kl, threadIdx.x, kBlockW * 32);
  __syncthreads();

  Stack st{0, 0, 0.f, 0.f, 1};
  float worst = __int_as_float(0x7f800000);
  unsigned n_box = 0, n_pairs = 0, n_win = 0;  // a query's: the wrapper holds NB * B below 2^32
  for (;;) {
    long long t0 = kStamps ? stamp() : 0;
    if (warp == 0) {
      const int nb = collect<DC, kStamps>(a, w, st, worst, qv, qrow, lane, n_box, n_win, t);
      if (lane == 0) {
        w.nb = nb;
        w.worst = worst;
      }
      if (a.bucket_seen && lane < nb) a.bucket_seen[w.bl[lane]] = 1;
      n_pairs += static_cast<unsigned>(nb * a.B);
    }
    __syncthreads();
    if (kStamps) stamp_add(t, 1, stamp() - t0, lane);
    const int nb = w.nb;
    if (nb == 0) break;
    worst = w.worst;
    // the warps' shares of the round, contiguous and in warp order
    const int total = nb * a.B;
    const int share = ((total + 32 * kBlockW - 1) / (32 * kBlockW)) * 32;
    const int p0 = min(total, warp * share);
    s.n = 0;
    scan_range<DC, kUBlock<DC>, true, kStamps>(a, w, s, p0, min(total, p0 + share), worst, qv,
                                               qrow, lane, t);
    if (lane == 0) s_n[warp] = s.n;
    t0 = kStamps ? stamp() : 0;
    __syncthreads();
    // the join: an entry's rank in the round is its index plus its rank in
    // every other warp's selection; the k smallest go to the joined list
    int joined = 0;
    for (int v = 0; v < kBlockW; ++v) joined += s_n[v];
    for (int e = threadIdx.x; e < kBlockW * k; e += kBlockW * 32) {
      const int v = e / k;
      const int i = e - v * k;
      if (i >= s_n[v]) continue;
      const unsigned long long x = sel_key(v)[i];
      int rank = i;
      for (int u = 0; u < kBlockW; ++u) {
        if (u != v) rank += list_rank(sel_key(u), s_n[u], x);
      }
      if (rank < k) {
        sel_key(kBlockW)[rank] = x;
        sel_id(kBlockW)[rank] = sel_id(v)[i];
      }
    }
    __syncthreads();
    if (kStamps) stamp_add(t, 3, stamp() - t0, lane);
    if (warp == 0) {
      t0 = kStamps ? stamp() : 0;
      worst = merge_klist(kl, sel_key(kBlockW), sel_id(kBlockW), min(k, joined), k, lane);
      if (kStamps) stamp_add(t, 4, stamp() - t0, lane);
    }
  }
  finish_query(a, qi, kl, threadIdx.x, kBlockW * 32);
  if (threadIdx.x == 0) count_work(a, n_box, n_pairs, n_win);
  if (kStamps) stamp_add(t, 0, stamp() - t_start, lane);
}

template <int DC, bool kStamps>
cudaError_t launch(const DfsArgs& a, int block_layout, cudaStream_t st) {
  const int nq = block_layout ? 1 : kWarpQ;
  const size_t smem = a.q_smem ? static_cast<size_t>(nq) * a.D * sizeof(float) : 0;
  if (block_layout) {
    morton_dfs_kernel_block<DC, kStamps>
        <<<static_cast<unsigned>(a.Q), kBlockW * 32, smem, st>>>(a);
  } else {
    const long long blocks = (a.Q + kWarpQ - 1) / kWarpQ;
    morton_dfs_kernel_warp<DC, kStamps>
        <<<static_cast<unsigned>(blocks), kWarpQ * 32, smem, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// The scratch a launch needs past kSmemK: 64-bit keys and ids, each
// [Q, n * k]. Returns nkey | nid << 16.
extern "C" int morton_dfs_scratch(int block_layout) {
  return block_layout ? (kBlockW + 2) | ((kBlockW + 1) << 16) : 2 | (1 << 16);
}

extern "C" int morton_dfs_launch(const void* q, const void* lo, const void* hi, const void* pts,
                                 const void* gid, void* out_d, void* out_i, void* scr_key,
                                 void* scr_id, void* node_seen, void* bucket_seen, void* work,
                                 void* stamps, long long Q, int D, int B, int k, int nb,
                                 int heap, int block_layout, void* stream) {
  if (Q <= 0 || k <= 0) return 0;
  if ((block_layout ? Q : (Q + kWarpQ - 1) / kWarpQ) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DfsArgs a;
  a.q = static_cast<const float*>(q);
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.pts = static_cast<const float*>(pts);
  a.gid = static_cast<const int*>(gid);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.scr_key = static_cast<unsigned long long*>(scr_key);
  a.scr_id = static_cast<int*>(scr_id);
  a.node_seen = static_cast<unsigned char*>(node_seen);
  a.bucket_seen = static_cast<unsigned char*>(bucket_seen);
  a.work = static_cast<unsigned long long*>(work);
  a.stamps = static_cast<long long*>(stamps);
  a.Q = Q;
  a.D = D;
  a.B = B;
  a.k = k;
  a.nb = nb;
  a.heap = heap;
  const int scr = morton_dfs_scratch(block_layout);
  a.nkey = scr & 0xffff;
  a.nid = scr >> 16;
  a.q_smem = D != 3 && static_cast<long long>(block_layout ? 1 : kWarpQ) * D * 4 <= kQSmemBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 3) {
    err = stamps ? launch<3, true>(a, block_layout, st) : launch<3, false>(a, block_layout, st);
  } else {
    err = stamps ? launch<0, true>(a, block_layout, st) : launch<0, false>(a, block_layout, st);
  }
  return static_cast<int>(err);
}
