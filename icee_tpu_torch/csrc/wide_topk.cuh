// The exact top-k of the wide paths: beam widths and top-ks above KMAX, up
// to V, in K1 (decode_step.cu), K2 (beam.cu), K6 (att_decode_step.cu), K7
// (att_beam.cu), and the rows and candidates of K9 and K10 that do not fit
// one block's shared memory (senticap_beam.cuh).  JAX's kernels take any 1
// <= k <= V (icee_tpu/ops/pallas_decode.py:261, pallas_beam.py:350,
// pallas_att_decode.py:201 and :733); the k <= KMAX paths pick k times by
// warp arg-max from per-tile candidates (decode_common.cuh tile_reduce,
// merge_row), which costs O(k V) a row and holds n_tiles k candidates a
// warp.  Above KMAX the paths select instead, over a whole block:
//
//   block_select the K least of the distinct 64-bit pairs (key(c), c), c
//                < n, key a 32-bit order key, in order: a radix select
//                finds the K-th least pair a byte at a time from the top
//                (a 256-bin histogram a pass, stopping as soon as the
//                chosen bin holds exactly the pairs still wanted: two or
//                three passes unless keys tie across the threshold); the
//                survivors (exactly K) are gathered by a block-wide prefix
//                sum.  Up to KWIDE = 256 survivors sit in the scratch and
//                each one's rank among them is counted (K compares a
//                survivor).  Above it (SCAN) they are sorted in a shared-
//                memory buffer the caller gives where they fit (a bitonic
//                sort of the K distinct pairs padded to a power of two:
//                rank r is the r-th of the sorted pairs, exactly the order
//                a rank count gives; K log^2 K / 2 compares, ~60k at K =
//                2048), else they go to a device-memory scratch of K pairs
//                and their ranks are counted against them streamed through
//                shared memory KWIDE at a time, RANK_ITEMS survivors a
//                thread held in registers (O(K^2) compares, ~4M at K =
//                2048).  The keys are read through key() on every pass,
//                never stored: a row of V logits or an image's k x k beam
//                candidates stay where they are (L2, or a copy the caller
//                staged in shared memory).
//   block_topk   block_select of the K greatest of n values val(c), ties
//                to the lowest index c: key = an order-preserving
//                descending key of the value (-0 counted as +0).
//   wide_row     one row of logits (V floats in device memory): every
//                256-wide tile's max and sum-exp through tile_reduce, logZ
//                through merge_logz -- the same arithmetic, in the same
//                order, as the k <= KMAX paths -- then block_topk, emitting
//                logp = value - logZ.  So a row's log-probs are the same
//                bits at any width and on every kernel's wide path, and
//                K2 = K1 fused-step, K7 = K6 hold at atol 0 there too.
//
// What bounds it: the latency of the passes' reads, a few reads of the row
// (or of the k x k candidates) a selection, so wide_row stages the row in
// shared memory where the caller has room and a grid's tail spreads an
// image's k x k candidates over several blocks (grid_beam.cuh).  No
// atomics touch data: the histogram's counts are counts, the survivors'
// places come from a prefix sum, and the output order from the sort (or
// the ranks), so a selection gives the same result on every run.
#pragma once

#include "decode_common.cuh"

namespace icee {

constexpr int KWIDE = 256;          // most survivors held in shared memory
constexpr int WIDE_THREADS = 512;   // a wide reduce block's threads
constexpr int TOPK_FLOATS = 1024;   // floats a block_topk scratch takes
constexpr int RANK_ITEMS = 4;       // survivors a thread ranks at once (SCAN)

// An order-preserving descending key of v: larger values give smaller
// keys; -0 and +0 give the same key.
__device__ __forceinline__ unsigned desc_key(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.f));
  return (b & 0x80000000u) ? b : ~(b | 0x80000000u);
}

struct alignas(16) TopkScratch {
  unsigned long long cand[KWIDE];  // the survivors' pairs (SCAN: a chunk)
  int hist[256];
  int wsum[32];                    // a block scan's per-warp sums
  int rem, bin, cnt;               // pairs still wanted, the chosen bin
  float logz;                      // wide_row's logZ
};
static_assert(sizeof(TopkScratch) <= sizeof(float) * TOPK_FLOATS,
              "TOPK_FLOATS holds the scratch");

// Exclusive prefix sum over the block of one int a thread; -> this thread's
// offset, with the block's total in `total`.  Every thread must call it.
__device__ __forceinline__ int block_excl_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int off = incl - v;
  total = 0;
  for (int w = 0; w < nw; ++w) {
    if (w < warp) off += wsum[w];
    total += wsum[w];
  }
  __syncthreads();
  return off;
}

// The least power of two >= n (n >= 1).
__host__ __device__ inline int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// v[0 .. n2) ascending in shared memory, n2 a power of two: a bitonic sort
// by the whole block.  Every thread must call it; it ends with a barrier.
__device__ inline void block_sort_pairs(unsigned long long* v, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (j - 1)), hi = lo + j;
        const unsigned long long x = v[lo], y = v[hi];
        if ((x > y) == ((lo & k) == 0)) {
          v[lo] = y;
          v[hi] = x;
        }
      }
    }
  }
  __syncthreads();
}

// The K survivors' pairs, in cand (shared memory where sorted, with room
// for pow2_ceil(K) pairs; else device memory, read through L2 since other
// blocks may have written it), in any order: emit(rank, c) once for each
// in the order of the pairs.  sorted: a sort in place; else the ranks
// counted against the pairs streamed through s->cand.  Every thread must
// call it; it ends with a barrier.
template <class Emit>
__device__ void emit_in_order(int K, unsigned long long* cand, bool sorted,
                              TopkScratch* s, Emit emit) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (sorted) {
    const int n2 = pow2_ceil(K);
    for (int i = K + tid; i < n2; i += nt) cand[i] = ~0ull;  // past every
    block_sort_pairs(cand, n2);                              // pair c < n
    for (int i = tid; i < K; i += nt)
      emit(i, (int)(cand[i] & 0xffffffffull));
    __syncthreads();
    return;
  }
  for (int i0 = 0; i0 < K; i0 += RANK_ITEMS * nt) {
    unsigned long long p[RANK_ITEMS];
    int r[RANK_ITEMS];
#pragma unroll
    for (int u = 0; u < RANK_ITEMS; ++u) {
      const int i = i0 + tid + u * nt;
      p[u] = i < K ? __ldcg(cand + i) : ~0ull;
      r[u] = 0;
    }
    for (int j0 = 0; j0 < K; j0 += KWIDE) {
      const int m = min(KWIDE, K - j0);
      __syncthreads();
      for (int j = tid; j < m; j += nt) s->cand[j] = __ldcg(cand + j0 + j);
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const unsigned long long q = s->cand[j];
#pragma unroll
        for (int u = 0; u < RANK_ITEMS; ++u) r[u] += q < p[u];
      }
    }
#pragma unroll
    for (int u = 0; u < RANK_ITEMS; ++u)
      if (i0 + tid + u * nt < K) emit(r[u], (int)(p[u] & 0xffffffffull));
  }
  __syncthreads();
}

// The bin of a 256-bin histogram h (shared memory) that holds the rem-th
// least pair, by warp 0: s->bin, s->rem (the pairs still wanted within
// it), s->cnt (its count).  The caller syncs after.
__device__ __forceinline__ void pick_bin(const int* h, int rem,
                                        TopkScratch* s) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  int v[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = h[8 * lane + j];
    sum += v[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  int before = incl - sum;
  if (before < rem && rem <= incl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (before + v[j] >= rem) {
        s->bin = 8 * lane + j;
        s->rem = rem - before;
        s->cnt = v[j];
        break;
      }
      before += v[j];
    }
  }
}

// The K (1 <= K <= n; K <= KWIDE unless SCAN) least pairs (key(c), c), c
// < n: emit(rank, c) once for each, rank 0 the least.  SCAN: the survivors
// go to sbuf (shared memory of scap pairs, where pow2_ceil(K) <= scap) and
// are sorted there, else to gcand (K pairs of device memory, this block's
// own) and ranked by counting.  Every thread of the block must call it
// (blockDim.x a multiple of 32); it ends with a barrier.
template <bool SCAN = false, class Key, class Emit>
__device__ void block_select(int n, int K, Key key, TopkScratch* s,
                             Emit emit,
                             unsigned long long* gcand = nullptr,
                             unsigned long long* sbuf = nullptr,
                             int scap = 0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  auto pair = [&](int c) {
    return ((unsigned long long)key(c) << 32) | (unsigned)c;
  };
  unsigned long long prefix = 0, mask = 0;
  if (tid == 0) s->rem = K;
  for (int shift = 56; shift >= 0; shift -= 8) {
    // an index byte above the largest index is 0 in every pair
    if (shift > 0 && shift < 32 && ((unsigned)(n - 1) >> shift) == 0) {
      mask |= 0xffull << shift;
      continue;
    }
    for (int i = tid; i < 256; i += nt) s->hist[i] = 0;
    __syncthreads();
    for (int c = tid; c < n; c += nt) {
      const unsigned long long p = pair(c);
      if ((p & mask) == prefix) atomicAdd(&s->hist[(p >> shift) & 255], 1);
    }
    __syncthreads();
    // the bin that holds the rem-th pair: lane l, bins 8l ..
    if (tid < 32) pick_bin(s->hist, s->rem, s);
    __syncthreads();
    prefix |= (unsigned long long)s->bin << shift;
    mask |= 0xffull << shift;
    if (s->cnt == s->rem) break;  // the whole bin is taken (the same in
  }                               // every thread)
  const unsigned long long tau = prefix | ~mask;  // the K-th least pair's
  int mine = 0;                                    // range: exactly K <= tau
  for (int c = tid; c < n; c += nt) mine += pair(c) <= tau;
  int total;
  int off = block_excl_scan(mine, s->wsum, total);
  const bool sorted = SCAN && sbuf != nullptr && pow2_ceil(K) <= scap;
  unsigned long long* cand = !SCAN ? s->cand : sorted ? sbuf : gcand;
  for (int c = tid; c < n && mine > 0; c += nt) {
    const unsigned long long p = pair(c);
    if (p <= tau) {
      cand[off++] = p;
      --mine;
    }
  }
  __syncthreads();
  if constexpr (!SCAN) {   // K <= KWIDE: K compares a survivor
    for (int i = tid; i < K; i += nt) {
      const unsigned long long p = s->cand[i];
      int r = 0;
      for (int j = 0; j < K; ++j) r += s->cand[j] < p;
      emit(r, (int)(p & 0xffffffffull));
    }
    __syncthreads();
  } else {
    emit_in_order(K, cand, sorted, s, emit);
  }
}

// The K greatest of val(c), c < n, ties to the lowest c: block_select on
// the descending keys.
template <bool SCAN = false, class Val, class Emit>
__device__ __forceinline__ void block_topk(int n, int K, Val val,
                                           TopkScratch* s, Emit emit,
                                           unsigned long long* gcand =
                                               nullptr,
                                           unsigned long long* sbuf = nullptr,
                                           int scap = 0) {
  block_select<SCAN>(
      n, K, [&](int c) { return desc_key(val(c)); }, s, emit, gcand, sbuf,
      scap);
}

// One row of V logits in device memory (read through L2): the tiles' max
// and sum-exp (tile_reduce, a warp a tile, into pm, pse: n_tiles floats
// each), logZ (merge_logz), then the row's K greatest logits, ties to the
// lowest id: emit(rank, id, logit - logZ).  lt holds VT floats a warp;
// SCAN: K > KWIDE, the survivors in sbuf (shared, scap pairs) where they
// fit, else in gcand (K pairs).  stage: V floats of shared memory or null;
// given, the row is copied there once and every pass reads the copy.
// Every thread of the block must call it; it ends with a barrier.
template <bool SCAN = false, class Emit>
__device__ void wide_row(const float* row, int V, int K, float* lt,
                         float* pm, float* pse, TopkScratch* s, Emit emit,
                         unsigned long long* gcand = nullptr,
                         float* stage = nullptr,
                         unsigned long long* sbuf = nullptr, int scap = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, n_tiles = (V + VT - 1) / VT;
  if (stage != nullptr) {
    for (int c = threadIdx.x; c < V; c += blockDim.x)
      stage[c] = __ldcg(row + c);
    __syncthreads();
  }
  auto at = [&](int c) {
    return stage != nullptr ? stage[c] : __ldcg(row + c);
  };
  float* mine = lt + warp * VT;
  for (int t = warp; t < n_tiles; t += nw) {
    float v[VT / 32];
#pragma unroll
    for (int u = 0; u < VT / 32; ++u) {
      const int col = t * VT + lane + 32 * u;
      v[u] = col < V ? at(col) : NEG;
    }
#pragma unroll
    for (int u = 0; u < VT / 32; ++u) mine[lane + 32 * u] = v[u];
    __syncwarp();
    tile_reduce(mine, t * VT, 0, pm + t, pse + t, nullptr, nullptr);
    __syncwarp();
  }
  __syncthreads();
  if (warp == 0) {
    const float z = merge_logz(pm, pse, n_tiles);
    if (lane == 0) s->logz = z;
  }
  __syncthreads();
  const float logz = s->logz;
  block_topk<SCAN>(
      V, K, at, s, [&](int q, int c) { emit(q, c, at(c) - logz); }, gcand,
      sbuf, scap);
}

// Floats of wide_reduce_kernel's shared memory at vocabulary V without its
// extras (the sort buffer, the staged row).
__host__ __device__ inline int wide_reduce_floats(int V) {
  return TOPK_FLOATS + (WIDE_THREADS / 32) * VT + 2 * ((V + VT - 1) / VT);
}

// Bytes of shared memory a wide reduce block takes at most for its extras,
// so that three or four blocks of 512 threads share an SM.
constexpr int WIDE_EXTRA_CAP = 64 * 1024;

// A wide reduce block's layout at (V, k), in floats: the base scratch
// (wide_reduce_floats, rounded up to 8 bytes), then (k > KWIDE) a sort
// buffer of pow2_ceil(k) pairs, then the staged row (V floats), each where
// it still fits WIDE_EXTRA_CAP (sort first).
struct WideLayout {
  int base, sort_pairs, stage, total;
};
__host__ __device__ inline WideLayout wide_layout(int V, int k) {
  WideLayout w;
  w.base = (wide_reduce_floats(V) + 1) & ~1;
  long long cap = WIDE_EXTRA_CAP / 4 > w.base ? WIDE_EXTRA_CAP / 4 : w.base;
  w.sort_pairs = k > KWIDE ? pow2_ceil(k) : 0;
  if (w.base + 2LL * w.sort_pairs > cap) w.sort_pairs = 0;
  w.stage = w.base + 2LL * w.sort_pairs + V <= cap ? V : 0;
  w.total = w.base + 2 * w.sort_pairs + w.stage;
  return w;
}

// One block a row r of logits (R, ld): wide_row, into logp, idx (R, k);
// SCAN (k > KWIDE): row r's survivors in the sort buffer, else in cand +
// r k.  Launched with or without programmatic dependent launch (it waits
// for the previous launch's logits first; without the attribute that is a
// no-op).  Shared memory: wide_layout(V, k).total floats.
template <bool SCAN>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_reduce_kernel(const float* logits, int ld, int V, int k, float* logp,
                   int* idx, unsigned long long* cand) {
  extern __shared__ __align__(16) float smem[];
  const WideLayout wl = wide_layout(V, k);
  TopkScratch* s = reinterpret_cast<TopkScratch*>(smem);
  float* lt = smem + TOPK_FLOATS;
  float* pm = lt + (WIDE_THREADS / 32) * VT;
  float* pse = pm + (V + VT - 1) / VT;
  unsigned long long* sbuf =
      reinterpret_cast<unsigned long long*>(smem + wl.base);
  float* stage = wl.stage ? smem + wl.base + 2 * wl.sort_pairs : nullptr;
  const size_t r = blockIdx.x;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  wide_row<SCAN>(
      logits + r * ld, V, k, lt, pm, pse, s,
      [&](int q, int c, float lp) {
        logp[r * k + q] = lp;
        idx[r * k + q] = c;
      },
      SCAN ? cand + r * k : nullptr, stage, sbuf, wl.sort_pairs);
}

// Pairs of the wide reduce's survivor scratch for R rows of top-k k: R k
// above KWIDE (in device memory, after the logits), else none.
__host__ __device__ inline long long wide_cand_pairs(int R, int k) {
  return k > KWIDE ? (long long)R * k : 0;
}

// The wide reduce launch: R rows of logits (R, ld) -> logp, idx (R, k);
// cand: wide_cand_pairs(R, k) pairs (k > KWIDE).
inline cudaError_t launch_wide_reduce(const float* logits, int ld, int R,
                                      int V, int k, float* logp, int* idx,
                                      unsigned long long* cand,
                                      cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)wide_layout(V, k).total;
  const void* kernel = k > KWIDE
                           ? reinterpret_cast<const void*>(
                                 wide_reduce_kernel<true>)
                           : reinterpret_cast<const void*>(
                                 wide_reduce_kernel<false>);
  if (k > KWIDE && cand == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  if (k > KWIDE)
    wide_reduce_kernel<true><<<R, WIDE_THREADS, smem, s>>>(
        logits, ld, V, k, logp, idx, cand);
  else
    wide_reduce_kernel<false><<<R, WIDE_THREADS, smem, s>>>(
        logits, ld, V, k, logp, idx, nullptr);
  return cudaGetLastError();
}

}  // namespace icee
