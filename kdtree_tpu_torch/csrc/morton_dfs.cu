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
//   the (d2, position) order, so the kernel keeps the survivors (d2 <= worst)
//   only, selects the k smallest of them by (d2, position) and merges those
//   by (d2, id). A +inf candidate never enters: every +inf entry of the list
//   is (+inf, -1), which sorts first, so the list's +inf slots keep id -1.
//
// What bounds it on the card: at a few queries (the headline's 10), the
// chain of dependent steps of one walk, each a stack pop, a child box read
// from device memory and its bound (hundreds of steps a query); at many
// queries (the sparse lane's 65,536), the bytes of the scanned buckets and
// the warps in flight to hide their latency.
//
// Design, right and simple first:
// - One warp a query, kWarps queries a block, one launch for the whole
//   batch, no block barrier. The walk's state is warp-uniform: every lane
//   holds the same sp, node, bound and worst, so the whole warp takes the
//   same branches. Lanes 0 and 1 compute the two children's bounds, and
//   shuffles hand them to all.
// - The stack (at most 2 * 31 + 2 entries) lives in registers: entry e in
//   lane e & 31, slot e >> 5. The round's bucket list (kV entries) too:
//   entry j in lane j.
// - A scan round: the warp's lanes take the round's nb * B positions in
//   order, lane-strided over each bucket's rows (coalesced), kU batches of
//   32 loaded before any is folded. A ballot a batch finds the survivors;
//   they go into the selection list in lane order, each placed after every
//   entry with d2 at or below its own (those came earlier), the last one
//   dropped once the list holds k; once full, a candidate must be strictly
//   below its last. Then the selection merges into the k-list entry by
//   entry by (d2, id), stopping at the first above the list's last.
// - The k-list and the selection live in shared memory up to kSmemK
//   entries; longer ones in device memory (the output rows and a scratch
//   of [Q, k]), the same code through generic pointers. A list update is a
//   warp-wide count of the entries at or below the key (ballots) and a
//   shift of the entries after it, a chunk of 32 at a time from the top.
// - A measurement, off unless the caller passes its buffers: the child
//   boxes and buckets each query read (byte flags) and the box bounds and
//   scanned pairs (two counters), for the bound of what the inputs need.

#include <cuda_runtime.h>
#include <limits.h>

#include "d2.cuh"

namespace {

using namespace kdt;

constexpr int kWarps = 4;       // queries a block
constexpr int kV = 8;           // buckets a scan round (_QUERY_COLLECT)
constexpr int kU = 4;           // batches of 32 positions loaded before folding
constexpr int kSmemK = 64;      // k-lists up to this length in shared memory
constexpr int kMaxStack = 64;   // 2 * num_levels + 2 for num_levels <= 31
constexpr unsigned kFull = 0xffffffffu;

struct DfsArgs {
  const float* q;            // [Q, D]
  const float* lo;           // [H, D] node boxes
  const float* hi;           // [H, D]
  const float* pts;          // [NB, B, D] (+inf padding rows)
  const int* gid;            // [NB, B] (-1 padding)
  float* out_d;              // [Q, k]
  int* out_i;                // [Q, k]
  float* scr_d;              // [Q, k] the selection when k > kSmemK
  int* scr_i;
  unsigned char* node_seen;  // [H] or null: child boxes read
  unsigned char* bucket_seen;  // [NB] or null: buckets scanned
  unsigned long long* work;  // [2] or null: box bounds, scanned pairs
  long long Q;
  int D, B, k, nb, heap;
};

// One axis's gap from q to [lo, hi], as torch.maximum and clamp_min take
// it (kdtree_tpu_torch/ops/morton.py::_bbox_d2): a NaN difference stays NaN.
__device__ __forceinline__ float dfs_gap(float q, float lo, float hi) {
  const float a = __fsub_rn(lo, q);
  const float b = __fsub_rn(q, hi);
  const float m = (a > b || a != a) ? a : b;
  return (m > 0.f || m != m) ? m : 0.f;
}

template <int DC>
__device__ __forceinline__ float node_bound(const float* lo, const float* hi, const float* qv,
                                            const float* qrow, int D) {
  float acc = 0.f;
  if constexpr (DC > 0) {
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      const float g = dfs_gap(qv[d], lo[d], hi[d]);
      acc = __fmaf_rn(g, g, acc);
    }
  } else if (D > 32) {
    acc = window_sum(D, [&](int d) { return dfs_gap(qrow[d], lo[d], hi[d]); });
  } else {
    for (int d = 0; d < D; ++d) {
      const float g = dfs_gap(qrow[d], lo[d], hi[d]);
      acc = __fmaf_rn(g, g, acc);
    }
  }
  return acc;
}

// Put (cd, ci) at position `at` of the list d/i, whose length becomes n:
// entries at..n-2 move up one (the one at n-1 before, if the list was full,
// drops out). A chunk of 32 entries at a time, from the top, each chunk
// read before it is written.
__device__ __forceinline__ void shift_in(float* d, int* i, int at, int n, float cd, int ci,
                                         int lane) {
  for (int c = (n - 1) & ~31; c >= (at & ~31); c -= 32) {
    const int e = c + lane;
    const bool w = e >= at && e < n;
    float vd = cd;
    int vi = ci;
    if (w && e > at) {
      vd = d[e - 1];
      vi = i[e - 1];
    }
    __syncwarp();
    if (w) {
      d[e] = vd;
      i[e] = vi;
    }
    __syncwarp();
  }
}

template <int DC>
__global__ void __launch_bounds__(kWarps * 32) morton_dfs_kernel(const DfsArgs a) {
  __shared__ float s_kd[kWarps][kSmemK];
  __shared__ int s_ki[kWarps][kSmemK];
  __shared__ float s_sd[kWarps][kSmemK];
  __shared__ int s_si[kWarps][kSmemK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qi = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (qi >= a.Q) return;  // the whole warp: no barrier below waits on it
  const int D = a.D, B = a.B, k = a.k;
  const float kInf = __int_as_float(0x7f800000);

  float* kd;  // the k-list, ascending by (d2, id)
  int* ki;
  float* sd;  // the round's selection, ascending by (d2, position)
  int* si;
  if (k <= kSmemK) {
    kd = s_kd[warp];
    ki = s_ki[warp];
    sd = s_sd[warp];
    si = s_si[warp];
  } else {
    kd = a.out_d + qi * k;
    ki = a.out_i + qi * k;
    sd = a.scr_d + qi * k;
    si = a.scr_i + qi * k;
  }
  for (int e = lane; e < k; e += 32) {
    kd[e] = kInf;
    ki[e] = -1;
  }
  __syncwarp();

  const float* qrow = a.q + qi * D;
  float qv[DC > 0 ? DC : 1];
  if constexpr (DC > 0) {
#pragma unroll
    for (int d = 0; d < DC; ++d) qv[d] = qrow[d];
  }
  const int first_leaf = a.nb - 1;
  const int last = a.heap - 1;
  unsigned long long n_box = 0, n_pairs = 0;

  // the stack: entry e in lane e & 31, register slot e >> 5; the root
  // (node 0, bound 0) is entry 0
  int sn0 = 0, sn1 = 0;
  float sb0 = 0.f, sb1 = 0.f;
  int sp = 1;
  float worst = kInf;
  int bl = 0;  // lane j < kV: the round's j-th bucket

  while (sp > 0) {
    // collect up to kV buckets
    int nb = 0;
    while (sp > 0 && nb < kV) {
      const int top = sp - 1;
      const int src = top & 31;
      const int n0 = __shfl_sync(kFull, sn0, src);
      const int n1 = __shfl_sync(kFull, sn1, src);
      const float b0 = __shfl_sync(kFull, sb0, src);
      const float b1 = __shfl_sync(kFull, sb1, src);
      const int node = top < 32 ? n0 : n1;
      const float bound = top < 32 ? b0 : b1;
      sp = top;
      if (!(bound < worst)) continue;
      if (node >= first_leaf) {
        if (lane == nb) bl = node - first_leaf;
        ++nb;
        continue;
      }
      const long long c1l = 2ll * node + 1;
      const int c1 = static_cast<int>(c1l < last ? c1l : last);
      const int c2 = static_cast<int>(c1l + 1 < last ? c1l + 1 : last);
      float bd = 0.f;
      if (lane < 2) {
        const int c = lane ? c2 : c1;
        const long long off = static_cast<long long>(c) * D;
        bd = node_bound<DC>(a.lo + off, a.hi + off, qv, qrow, D);
        if (a.node_seen) a.node_seen[c] = 1;
      }
      n_box += 2;
      const float bd0 = __shfl_sync(kFull, bd, 0);
      const float bd1 = __shfl_sync(kFull, bd, 1);
      const bool swap = bd0 < bd1;  // push the nearer child last
      const int fc = swap ? c2 : c1;
      const float fb = swap ? bd1 : bd0;
      const int sc = swap ? c1 : c2;
      const float sb = swap ? bd0 : bd1;
      if (fb < worst && sp < kMaxStack) {
        if (lane == (sp & 31)) {
          if (sp < 32) { sn0 = fc; sb0 = fb; } else { sn1 = fc; sb1 = fb; }
        }
        ++sp;
      }
      if (sb < worst && sp < kMaxStack) {
        if (lane == (sp & 31)) {
          if (sp < 32) { sn0 = sc; sb0 = sb; } else { sn1 = sc; sb1 = sb; }
        }
        ++sp;
      }
    }
    if (nb == 0) continue;

    // scan the round's buckets: select the k smallest survivors by
    // (d2, position)
    if (a.bucket_seen && lane < nb) a.bucket_seen[bl] = 1;
    const int total = nb * B;
    n_pairs += static_cast<unsigned long long>(total);
    int s = 0;          // selection length
    float smax = kInf;  // its last entry once it holds k
    for (int base = 0; base < total; base += 32 * kU) {
      float cd[kU];
      int cid[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int p = base + 32 * u + lane;
        const bool in = p < total;
        const int j = in ? p / B : 0;
        const int b = __shfl_sync(kFull, bl, j);
        cd[u] = kInf;
        cid[u] = -1;
        if (in) {
          const long long row = static_cast<long long>(b) * B + (p - j * B);
          const float* pr = a.pts + row * D;
          if constexpr (DC == 3) {
            cd[u] = d2_3(qv, pr[0], pr[1], pr[2]);
          } else {
            cd[u] = point_d2<DC>(pr, qv, qrow, D);
          }
          cid[u] = a.gid[row];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        unsigned m = __ballot_sync(
            kFull, cd[u] <= worst && cd[u] < kInf && (s < k || cd[u] < smax));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float xd = __shfl_sync(kFull, cd[u], src);
          const int xi = __shfl_sync(kFull, cid[u], src);
          if (s == k && !(xd < smax)) continue;
          int at = 0;  // entries at or below xd came earlier: they stay ahead
          for (int c = 0; c < s; c += 32) {
            const int e = c + lane;
            at += __popc(__ballot_sync(kFull, e < s && sd[e] <= xd));
          }
          const int n = s < k ? s + 1 : k;
          shift_in(sd, si, at, n, xd, xi, lane);
          s = n;
          if (s == k) smax = sd[k - 1];
        }
      }
    }

    // merge the selection into the k-list by (d2, id)
    for (int e = 0; e < s; ++e) {
      const float xd = sd[e];
      const int xi = si[e];
      if (xd > kd[k - 1]) break;  // so is every later entry
      int at = 0;
      for (int c = 0; c < k; c += 32) {
        const int f = c + lane;
        at += __popc(__ballot_sync(
            kFull, f < k && (kd[f] < xd || (kd[f] == xd && ki[f] <= xi))));
      }
      if (at < k) shift_in(kd, ki, at, k, xd, xi, lane);
    }
    worst = kd[k - 1];
  }

  if (k <= kSmemK) {
    for (int e = lane; e < k; e += 32) {
      a.out_d[qi * k + e] = kd[e];
      a.out_i[qi * k + e] = ki[e];
    }
  }
  if (a.work && lane == 0) {
    atomicAdd(a.work, n_box);
    atomicAdd(a.work + 1, n_pairs);
  }
}

}  // namespace

extern "C" int morton_dfs_launch(const void* q, const void* lo, const void* hi, const void* pts,
                                 const void* gid, void* out_d, void* out_i, void* scr_d,
                                 void* scr_i, void* node_seen, void* bucket_seen, void* work,
                                 long long Q, int D, int B, int k, int nb, int heap,
                                 void* stream) {
  if (Q <= 0 || k <= 0) return 0;
  const long long blocks = (Q + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  DfsArgs a;
  a.q = static_cast<const float*>(q);
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.pts = static_cast<const float*>(pts);
  a.gid = static_cast<const int*>(gid);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.scr_d = static_cast<float*>(scr_d);
  a.scr_i = static_cast<int*>(scr_i);
  a.node_seen = static_cast<unsigned char*>(node_seen);
  a.bucket_seen = static_cast<unsigned char*>(bucket_seen);
  a.work = static_cast<unsigned long long*>(work);
  a.Q = Q;
  a.D = D;
  a.B = B;
  a.k = k;
  a.nb = nb;
  a.heap = heap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    morton_dfs_kernel<3><<<static_cast<unsigned>(blocks), kWarps * 32, 0, st>>>(a);
  } else {
    morton_dfs_kernel<0><<<static_cast<unsigned>(blocks), kWarps * 32, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
