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
// step on the CPU, both selection paths included.
//
// The function, per tile t (one block each, the level loop inside):
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
//      0): the key (lb bits << 32 | rank) ranks the live nodes in position
//      order, so sorting the keys is that stable sort;
//   d. caps run from 1 to pow2ceil(num_buckets); cap >= 2^L leaves no level
//      loop; with bound +inf an empty node's lb +inf passes lb <= bound but is
//      not finite, so it is not live.
//
// What bounds it on the card: the bytes and flops are microseconds (one lower
// bound per child of a live slot, 6 D flops, and each distinct node box read
// once), but the selection is a serial chain inside each block: a level
// cannot start before the previous level's sort has ended, and a sort of n
// keys is log2(n)^2 / 2 barrier-separated steps. The design keeps that chain
// short and on chip: after the mask a lower bound is +0..+inf, so its float
// bits order like unsigned integers; only the live children are ranked (a
// ballot and a prefix over the warps), so dead slots cost nothing; up to
// smem_keys live candidates are sorted by a bitonic network in shared memory;
// past that (caps above smem_keys / 2, where 2 x 65,536 children do not fit
// 227 KB) the keys go to the tile's scratch in device memory and a stable
// least-significant-digit radix sort on the lb bits orders them, one 8-bit
// digit a pass, skipping a pass whose digit every key shares (all lbs are 0
// in range mode). A block has as many threads as cap, from 32 to 512.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kDigits = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ull;

struct FrontierArgs {
  const float* node_lo;       // [H, D] the heap's boxes
  const float* node_hi;
  const float* box_lo;        // [T, D] the tiles' boxes
  const float* box_hi;
  const float* bound;         // [T]
  int* bucket;                // [T, cap] the slots' node ids, then bucket ids
  float* lb;                  // [T, cap]
  unsigned char* overflow;    // [T]
  unsigned long long* keys;   // [T, 4 cap] radix scratch, null if never used
  int* nodes;                 // [T, 2 cap] node of each ranked key, the same
  int D, cap, start, levels, first_leaf, smem_keys;
};

struct Smem {
  unsigned long long* keys;   // [smem_keys]
  int* nodes;                 // [smem_keys]
  int* warp_digits;           // [warps, 256] (radix path)
  int* hist;                  // [256]
  int* warp_sums;             // [32]
  int* flag;                  // [1]
};

// The lower bound of node `node`'s box against the tile box [blo, bhi], in the
// plain version's arithmetic (trap a); +inf when a gap is NaN (trap b).
__device__ __forceinline__ float node_lb(const FrontierArgs& a, int node, const float* blo,
                                         const float* bhi) {
  const float* lo = a.node_lo + static_cast<long long>(node) * a.D;
  const float* hi = a.node_hi + static_cast<long long>(node) * a.D;
  float g0 = 0.f, acc = 0.f;
  for (int d = 0; d < a.D; ++d) {
    const float x = __fsub_rn(lo[d], bhi[d]);
    const float y = __fsub_rn(blo[d], hi[d]);
    if (isnan(x) || isnan(y)) return INFINITY;
    const float g = fmaxf(fmaxf(x, y), 0.f);
    if (d == 0) {
      g0 = g;
    } else if (d == 1) {
      acc = __fmaf_rn(g0, g0, __fmul_rn(g, g));
    } else {
      acc = __fmaf_rn(g, g, acc);
    }
  }
  return a.D == 1 ? __fmul_rn(g0, g0) : acc;
}

// The rank of this thread's flag among the block's set flags before it, in
// thread order; *total gets the block's count. Every thread must call it.
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int c = warp_sums[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();  // warp_sums is read before the next call writes it
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// Sorts keys[0, n) ascending in shared memory (a bitonic network over the
// next power of two, padded with the largest key). n <= smem_keys, a power of
// two, so the padded length fits.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + threadIdx.x; i < p; i += blockDim.x) keys[i] = kPadKey;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long x = keys[i], y = keys[l];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Sorts src[0, n) by the high 32 bits (the lb bits), stably, in device memory:
// one 8-bit digit a pass from bit 32 up, src and dst swapping. A pass whose
// digit every key shares moves nothing and is skipped. The keys come in rank
// order, so stability makes this the sort of the whole keys. Returns the
// buffer that holds the result.
__device__ unsigned long long* radix_sort(unsigned long long* src, unsigned long long* dst,
                                          int n, const Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int shift = 32; shift < 64; shift += 8) {
    for (int d = threadIdx.x; d < kDigits; d += blockDim.x) s.hist[d] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      atomicAdd(&s.hist[(src[i] >> shift) & 255], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // digit counts -> each digit's first slot
      int run = 0, uniform = 0;
      for (int d = 0; d < kDigits; ++d) {
        const int c = s.hist[d];
        uniform |= c == n;
        s.hist[d] = run;
        run += c;
      }
      *s.flag = uniform;
    }
    __syncthreads();
    if (*s.flag) continue;
    for (int c0 = 0; c0 < n; c0 += blockDim.x) {
      const int i = c0 + threadIdx.x;
      const bool valid = i < n;
      const unsigned long long key = valid ? src[i] : 0ull;
      const int digit = valid ? static_cast<int>((key >> shift) & 255) : kDigits;
      for (int e = threadIdx.x; e < warps * kDigits; e += blockDim.x) s.warp_digits[e] = 0;
      __syncthreads();
      const unsigned peers = __match_any_sync(kFull, digit);
      if (valid && lane == __ffs(peers) - 1) {
        s.warp_digits[warp * kDigits + digit] = __popc(peers);
      }
      __syncthreads();
      for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {  // warps in order
        int run = s.hist[d];
        for (int w = 0; w < warps; ++w) {
          const int c = s.warp_digits[w * kDigits + d];
          s.warp_digits[w * kDigits + d] = run;
          run += c;
        }
        s.hist[d] = run;
      }
      __syncthreads();
      if (valid) {
        dst[s.warp_digits[warp * kDigits + digit] + __popc(peers & ((1u << lane) - 1u))] = key;
      }
      __syncthreads();
    }
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// One level: the n_cand candidates (the start level's nodes, or the two
// children of each of the n_live slots), the live ones ranked in position
// order, sorted, the cap smallest written as the new slots. Returns how many
// slots are live now; sets *overflowed when more than cap candidates lived.
__device__ int descend(const FrontierArgs& a, const Smem& s, int n_cand, int n_live,
                       bool children, const float* blo, const float* bhi, float bound,
                       int* slot_id, float* slot_lb, unsigned long long* gkeys, int* gnodes,
                       bool* overflowed) {
  const bool on_chip = n_cand <= a.smem_keys;
  unsigned long long* keys = on_chip ? s.keys : gkeys;
  int* nodes = on_chip ? s.nodes : gnodes;
  const int m = 1 << a.start;
  int count = 0;
  for (int c0 = 0; c0 < n_cand; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    int node = 0;
    float lb = INFINITY;
    if (i < n_cand) {
      if (!children) {
        node = m - 1 + i;
      } else if (i < n_live) {
        node = 2 * slot_id[i] + 1;  // position i
      } else {
        node = 2 * slot_id[i - n_live] + 2;  // position cap + (i - n_live)
      }
      lb = node_lb(a, node, blo, bhi);
    }
    const bool live = lb <= bound && lb < INFINITY;
    int total;
    const int r = count + block_rank(live, s.warp_sums, &total);
    if (live) {
      keys[r] = (static_cast<unsigned long long>(__float_as_uint(lb)) << 32) |
                static_cast<unsigned>(r);
      nodes[r] = node;
    }
    count += total;
  }
  if (count > a.cap) *overflowed = true;
  __syncthreads();  // the ranked keys are written, the slots read
  const unsigned long long* sorted = keys;
  if (on_chip) {
    bitonic_sort(keys, count);
  } else {
    sorted = radix_sort(gkeys, gkeys + 2 * a.cap, count, s);
  }
  const int keep = min(count, a.cap);
  for (int r = threadIdx.x; r < keep; r += blockDim.x) {
    const unsigned long long key = sorted[r];
    slot_lb[r] = __uint_as_float(static_cast<unsigned>(key >> 32));
    slot_id[r] = nodes[static_cast<unsigned>(key)];
  }
  __syncthreads();  // the new slots are written before the next level reads them
  return keep;
}

__global__ void __launch_bounds__(kMaxThreads) frontier_kernel(const FrontierArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem s;
  s.keys = reinterpret_cast<unsigned long long*>(smem_raw);
  s.nodes = reinterpret_cast<int*>(s.keys + a.smem_keys);
  s.warp_digits = s.nodes + a.smem_keys;
  s.hist = s.warp_digits + (a.keys != nullptr ? (blockDim.x >> 5) * kDigits : 0);
  s.warp_sums = s.hist + kDigits;
  s.flag = s.warp_sums + 32;

  const long long t = blockIdx.x;
  const float* blo = a.box_lo + t * a.D;
  const float* bhi = a.box_hi + t * a.D;
  const float bound = a.bound[t];
  int* slot_id = a.bucket + t * a.cap;
  float* slot_lb = a.lb + t * a.cap;
  unsigned long long* gkeys = a.keys != nullptr ? a.keys + t * 4 * a.cap : nullptr;
  int* gnodes = a.nodes != nullptr ? a.nodes + t * 2 * a.cap : nullptr;

  bool overflowed = false;
  int n_live = descend(a, s, 1 << a.start, 0, false, blo, bhi, bound, slot_id, slot_lb, gkeys,
                       gnodes, &overflowed);
  for (int level = a.start; level < a.levels; ++level) {
    n_live = descend(a, s, 2 * n_live, n_live, true, blo, bhi, bound, slot_id, slot_lb, gkeys,
                     gnodes, &overflowed);
  }
  for (int r = threadIdx.x; r < a.cap; r += blockDim.x) {
    if (r < n_live) {
      slot_id[r] -= a.first_leaf;
    } else {
      slot_id[r] = -1;
      slot_lb[r] = INFINITY;
    }
  }
  if (threadIdx.x == 0) a.overflow[t] = overflowed ? 1 : 0;
}

}  // namespace

// node_lo / node_hi f32[H, D], box_lo / box_hi f32[T, D], bound f32[T] ->
// bucket i32[T, cap] (-1 padding), lb f32[T, cap] (+inf padding), overflow
// u8[T]; contiguous device memory. start = min(floor(log2 cap), levels);
// smem_keys (a power of two) is the most candidates a level sorts in shared
// memory; keys u64[T, 4 cap] and nodes i32[T, 2 cap] are the device-memory
// scratch for levels past it (null when 2 cap <= smem_keys); threads is a
// multiple of 32 up to 512. Returns the CUDA error of the launch (0 =
// cudaSuccess; nothing is launched when T is 0).
extern "C" int frontier_launch(const void* node_lo, const void* node_hi, const void* box_lo,
                               const void* box_hi, const void* bound, void* bucket, void* lb,
                               void* overflow, void* keys, void* nodes, int T, int D, int cap,
                               int start, int levels, int first_leaf, int smem_keys,
                               int threads, void* stream) {
  if (T <= 0) return 0;
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
  a.nodes = static_cast<int*>(nodes);
  a.D = D;
  a.cap = cap;
  a.start = start;
  a.levels = levels;
  a.first_leaf = first_leaf;
  a.smem_keys = smem_keys;
  const size_t smem = static_cast<size_t>(smem_keys) * (8 + 4) +
                      (keys != nullptr ? static_cast<size_t>(threads / 32) * kDigits * 4 : 0) +
                      (kDigits + 32 + 1) * 4;
  cudaError_t err = cudaFuncSetAttribute(frontier_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  frontier_kernel<<<T, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
