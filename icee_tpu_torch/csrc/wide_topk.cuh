// The exact top-k of the wide paths: beam widths and top-ks above KMAX, up
// to KWIDE = 256, in K1 (decode_step.cu), K2 (beam.cu), K6
// (att_decode_step.cu) and K7 (att_beam.cu).  JAX's kernels take any 1 <=
// k <= V (icee_tpu/ops/pallas_decode.py:261, pallas_beam.py:350,
// pallas_att_decode.py:201 and :733); the k <= KMAX paths pick k times by
// warp arg-max from per-tile candidates (decode_common.cuh tile_reduce,
// merge_row), which costs O(k V) a row and holds n_tiles k candidates a
// warp.  Above KMAX the paths select instead, over a whole block:
//
//   block_topk   the K greatest of n values val(c), in order, ties to the
//                lowest index c: the K least of the distinct 64-bit pairs
//                (key, c), key an order-preserving descending key of the
//                value (-0 counted as +0).  A radix select finds the K-th
//                least pair a byte at a time from the top (a 256-bin
//                histogram a pass, stopping as soon as the chosen bin holds
//                exactly the pairs still wanted: two or three passes unless
//                values tie across the threshold); the survivors (exactly
//                K) are gathered by a block-wide prefix sum, and each one's
//                rank among them is counted.  The values are read through
//                val() on every pass, never stored: a row of V logits or an
//                image's k x k beam candidates stay where they are (L2).
//   wide_row     one row of logits (V floats in device memory): every
//                256-wide tile's max and sum-exp through tile_reduce, logZ
//                through merge_logz -- the same arithmetic, in the same
//                order, as the k <= KMAX paths -- then block_topk, emitting
//                logp = value - logZ.  So a row's log-probs are the same
//                bits at any width and on every kernel's wide path, and
//                K2 = K1 fused-step, K7 = K6 hold at atol 0 there too.
//
// What bounds it: bytes through L2, a few reads of the row (or of the k x k
// candidates) a selection.  No atomics touch data: the histogram's counts
// are counts, the survivors' places come from a prefix sum, and the output
// order from the ranks, so a selection gives the same result on every run.
#pragma once

#include "decode_common.cuh"

namespace icee {

constexpr int KWIDE = 256;          // largest beam / top-k of the wide paths
constexpr int WIDE_THREADS = 512;   // a wide reduce block's threads
constexpr int TOPK_FLOATS = 1024;   // floats a block_topk scratch takes

// An order-preserving descending key of v: larger values give smaller
// keys; -0 and +0 give the same key.
__device__ __forceinline__ unsigned desc_key(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.f));
  return (b & 0x80000000u) ? b : ~(b | 0x80000000u);
}

// (key, index) as one 64-bit value in the order (value desc, index asc).
__device__ __forceinline__ unsigned long long desc_pair(float v, int c) {
  return ((unsigned long long)desc_key(v) << 32) | (unsigned)c;
}

struct alignas(16) TopkScratch {
  unsigned long long cand[KWIDE];  // the survivors' pairs
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

// The K (1 <= K <= min(n, KWIDE)) greatest of val(c), c < n, ties to the
// lowest c: emit(rank, c) once for each, rank 0 the greatest.  Every
// thread of the block must call it (blockDim.x a multiple of 32); it ends
// with a barrier.
template <class Val, class Emit>
__device__ void block_topk(int n, int K, Val val, TopkScratch* s, Emit emit) {
  const int tid = threadIdx.x, nt = blockDim.x;
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
      const unsigned long long p = desc_pair(val(c), c);
      if ((p & mask) == prefix) atomicAdd(&s->hist[(p >> shift) & 255], 1);
    }
    __syncthreads();
    if (tid < 32) {  // the bin that holds the rem-th pair: lane l, bins 8l..
      int h[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = s->hist[8 * tid + j];
        sum += h[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (tid >= o) incl += y;
      }
      const int rem = s->rem;
      int before = incl - sum;
      if (before < rem && rem <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (before + h[j] >= rem) {
            s->bin = 8 * tid + j;
            s->rem = rem - before;
            s->cnt = h[j];
            break;
          }
          before += h[j];
        }
      }
    }
    __syncthreads();
    prefix |= (unsigned long long)s->bin << shift;
    mask |= 0xffull << shift;
    if (s->cnt == s->rem) break;  // the whole bin is taken (the same in
  }                               // every thread)
  const unsigned long long tau = prefix | ~mask;  // the K-th least pair's
  int mine = 0;                                    // range: exactly K <= tau
  for (int c = tid; c < n; c += nt) mine += desc_pair(val(c), c) <= tau;
  int total;
  int off = block_excl_scan(mine, s->wsum, total);
  for (int c = tid; c < n && mine > 0; c += nt) {
    const unsigned long long p = desc_pair(val(c), c);
    if (p <= tau) {
      s->cand[off++] = p;
      --mine;
    }
  }
  __syncthreads();
  for (int i = tid; i < K; i += nt) {
    const unsigned long long p = s->cand[i];
    int r = 0;
    for (int j = 0; j < K; ++j) r += s->cand[j] < p;
    emit(r, (int)(p & 0xffffffffull));
  }
  __syncthreads();
}

// One row of V logits in device memory (read through L2): the tiles' max
// and sum-exp (tile_reduce, a warp a tile, into pm, pse: n_tiles floats
// each), logZ (merge_logz), then the row's K greatest logits, ties to the
// lowest id: emit(rank, id, logit - logZ).  lt holds VT floats a warp.
// Every thread of the block must call it; it ends with a barrier.
template <class Emit>
__device__ void wide_row(const float* row, int V, int K, float* lt,
                         float* pm, float* pse, TopkScratch* s, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, n_tiles = (V + VT - 1) / VT;
  float* mine = lt + warp * VT;
  for (int t = warp; t < n_tiles; t += nw) {
    float v[VT / 32];
#pragma unroll
    for (int u = 0; u < VT / 32; ++u) {
      const int col = t * VT + lane + 32 * u;
      v[u] = col < V ? __ldcg(row + col) : NEG;
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
  block_topk(
      V, K, [&](int c) { return __ldcg(row + c); }, s,
      [&](int q, int c) { emit(q, c, __ldcg(row + c) - logz); });
}

// Floats of wide_reduce_kernel's shared memory at vocabulary V.
__host__ __device__ inline int wide_reduce_floats(int V) {
  return TOPK_FLOATS + (WIDE_THREADS / 32) * VT + 2 * ((V + VT - 1) / VT);
}

// One block a row r of logits (R, ld): wide_row, into logp, idx (R, k).
// Launched with or without programmatic dependent launch (it waits for the
// previous launch's logits first; without the attribute that is a no-op).
__global__ void __launch_bounds__(WIDE_THREADS)
wide_reduce_kernel(const float* logits, int ld, int V, int k, float* logp,
                   int* idx) {
  extern __shared__ __align__(16) float smem[];
  TopkScratch* s = reinterpret_cast<TopkScratch*>(smem);
  float* lt = smem + TOPK_FLOATS;
  float* pm = lt + (WIDE_THREADS / 32) * VT;
  float* pse = pm + (V + VT - 1) / VT;
  const size_t r = blockIdx.x;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  wide_row(logits + r * ld, V, k, lt, pm, pse, s,
           [&](int q, int c, float lp) {
             logp[r * k + q] = lp;
             idx[r * k + q] = c;
           });
}

// The wide reduce launch: R rows of logits (R, ld) -> logp, idx (R, k).
inline cudaError_t launch_wide_reduce(const float* logits, int ld, int R,
                                      int V, int k, float* logp, int* idx,
                                      cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)wide_reduce_floats(V);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(wide_reduce_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return e;
  wide_reduce_kernel<<<R, WIDE_THREADS, smem, s>>>(logits, ld, V, k, logp,
                                                   idx);
  return cudaGetLastError();
}

}  // namespace icee
