// Device functions shared by the decode kernels: K1 (decode_step.cu) and
// K6 (att_decode_step.cu), one beam step each, and K2 and K7 (beam.cu,
// att_beam.cu on grid_beam.cuh), the whole beam search.
//
// Every output element is a fixed sequential chain of fmaf/adds (the
// libraries are built with -fmad=false, so the compiler contracts nothing on
// its own): a product's output is one fmaf chain in k order from 0.f, the
// biases added after, the per-tile reduction and the tile merge are
// tile_reduce and merge_row below.  K1's and K6's launches (the many-row
// products of step_kernels.cuh, the column-split ones of split_step.cuh)
// and K2's and K7's stages write the chains out each in its own tiling, but
// as the same chains, so the arithmetic for one row does not depend on how
// many rows a launch holds, and a beam run through K1 step by step gives
// bit-identical scores to the same beam run inside K2: the serving engine's
// serial path and batched path return the same captions.
//
// Layouts are the JAX package's: linear weights (in, out), V_w (E, 4F),
// S_w[style] (4, F, F), U_w (4, F, H), W_w (H, 4H), C_w (H, V); gate order
// [i, f, o, c]; h = o * c with no tanh (stylenet/model.py:153).  The LSTM
// cell: W_ih (E, 4H), W_hh (H, 4H), b_ih, b_hh (4H); gate order
// [i, f, g, o]; h = o * tanh(c).
//
// dot4 (the attention's products, att_common.cuh) reads its weights as
// float4, each thread owning 4 adjacent output columns with 8 rows of k
// (128 bytes) in flight.  F, H and V must be multiples of 4 (the wrappers
// check).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace icee {

constexpr int VT = 256;          // vocab tile width: one partial top-k per tile
constexpr int QT = VT / 4;       // threads per tile (4 columns each)
constexpr int KMAX = 8;          // largest beam / top-k of the k <= 8 paths
                                 // (wider ones: wide_topk.cuh, KWIDE)
constexpr float NEG = -1e30f;    // masked logit / dead-beam score (JAX NEG)
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
struct CellWeights {
  const float* __restrict__ Vw;  // (E, 4F)
  const float* __restrict__ Vb;  // (4, F)
  const float* __restrict__ Sw;  // (4, F, F)  style slice
  const float* __restrict__ Sb;  // (4, F)
  const float* __restrict__ Uw;  // (4, F, H)
  const float* __restrict__ Ub;  // (4, H)
  const float* __restrict__ Ww;  // (H, 4H)
  const float* __restrict__ Wb;  // (4, H)
  int E, F, H;
};

struct LstmWeights {
  const float* __restrict__ Wih;  // (E, 4H)
  const float* __restrict__ bih;  // (4H,)
  const float* __restrict__ Whh;  // (H, 4H)
  const float* __restrict__ bhh;  // (4H,)
  int E, H;
};

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// acc[r][j] = sum_k A[r*lda + k] * W[k*ldw + col + j] for r < rows, j < 4,
// each a sequential fmaf chain in k order.  A lives in shared memory (lda %
// 4 == 0, 16-byte aligned) and is read as float4 broadcasts; W (col % 4 ==
// 0, ldw % 4 == 0) is read as float4, 8 rows of k at a time, coalesced
// across the threads of a warp (consecutive column quads).
template <int MAXR>
__device__ __forceinline__ void dot4(const float* A, int lda, int rows,
                                     const float* __restrict__ W, int ldw,
                                     int col, int K, float (&acc)[MAXR][4]) {
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  const float* wp = W + col;
  int k = 0;
  for (; k + 8 <= K; k += 8) {
    float4 w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      w[u] = __ldg(reinterpret_cast<const float4*>(wp + (size_t)(k + u) * ldw));
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < rows) {
        const float4 a0 = *reinterpret_cast<const float4*>(A + r * lda + k);
        const float4 a1 = *reinterpret_cast<const float4*>(A + r * lda + k + 4);
        fma4(acc[r], a0.x, w[0]);
        fma4(acc[r], a0.y, w[1]);
        fma4(acc[r], a0.z, w[2]);
        fma4(acc[r], a0.w, w[3]);
        fma4(acc[r], a1.x, w[4]);
        fma4(acc[r], a1.y, w[5]);
        fma4(acc[r], a1.z, w[6]);
        fma4(acc[r], a1.w, w[7]);
      }
    }
  }
  for (; k < K; ++k) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(wp + (size_t)k * ldw));
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows) fma4(acc[r], A[r * lda + k], w);
  }
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// (value desc, key asc) arg-max across the warp; every lane ends with the
// winner.  `slot` rides along.
__device__ __forceinline__ void warp_argmax(float& v, int& key, int& slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int ok = __shfl_xor_sync(FULL, key, off);
    const int os = __shfl_xor_sync(FULL, slot, off);
    if (ov > v || (ov == v && ok < key)) {
      v = ov;
      key = ok;
      slot = os;
    }
  }
}

// One warp reduces one row of one logits tile (VT values in shared memory,
// consumed: picked entries are overwritten) to its partials: the tile max,
// the sum of exp(logit - max), and the tile's exact top-k (value desc,
// lowest vocab index on ties).  Lane 0 writes the outputs.
__device__ void tile_reduce(float* lt, int col0, int k, float* om, float* ose,
                            float* ov, int* oi) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < VT / 32; ++i) m = fmaxf(m, lt[lane + 32 * i]);
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VT / 32; ++i) s += expf(lt[lane + 32 * i] - m);
  s = warp_sum(s);
  if (lane == 0) {
    *om = m;
    *ose = s;
  }
  for (int q = 0; q < k; ++q) {
    float bv = -INFINITY;
    int bc = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < VT / 32; ++i) {
      const float v = lt[lane + 32 * i];
      if (v > bv) {  // ascending columns: ties keep the lowest
        bv = v;
        bc = lane + 32 * i;
      }
    }
    int slot = bc;
    warp_argmax(bv, bc, slot);
    if (lane == 0) {
      ov[q] = bv;
      oi[q] = col0 + bc;
    }
    if ((bc & 31) == lane) lt[bc] = -INFINITY;
    __syncwarp();
  }
}

// One warp: a row's logZ from its per-tile partials, M + log(sum_t se_t *
// exp(m_t - M)) summed in tile order; every lane returns it.  The k <=
// KMAX merge (merge_row) and the wide paths (wide_topk.cuh) both take it
// from here, so a row's log-probs are the same bits on either.
__device__ __forceinline__ float merge_logz(const float* pm, const float* pse,
                                            int n_tiles) {
  const int lane = threadIdx.x & 31;
  float M = -INFINITY;
  for (int t = lane; t < n_tiles; t += 32) M = fmaxf(M, pm[t]);
  M = warp_max(M);
  float S = 0.f;
  for (int t = 0; t < n_tiles; ++t) S += pse[t] * expf(pm[t] - M);
  return M + logf(S);
}

// One warp merges a row's per-tile partials: logZ (merge_logz), then the
// exact top-k of the n_tiles*k candidates (value desc, lowest vocab index
// on ties).  cand_v is consumed.  Lane 0 writes logp[q] = value - logZ and
// idx[q].
__device__ void merge_row(const float* pm, const float* pse, float* cand_v,
                          const int* cand_i, int n_tiles, int k, float* logp,
                          int* idx) {
  const int lane = threadIdx.x & 31;
  const float logz = merge_logz(pm, pse, n_tiles);
  const int n = n_tiles * k;
  for (int q = 0; q < k; ++q) {
    float bv = -INFINITY;
    int bkey = 0x7fffffff, bslot = -1;
    for (int c = lane; c < n; c += 32) {
      const float v = cand_v[c];
      const int key = cand_i[c];
      if (v > bv || (v == bv && key < bkey)) {
        bv = v;
        bkey = key;
        bslot = c;
      }
    }
    warp_argmax(bv, bkey, bslot);
    if (lane == 0) {
      logp[q] = bv - logz;
      idx[q] = bkey;
    }
    if (bslot >= 0 && (bslot & 31) == lane) cand_v[bslot] = -INFINITY;
    __syncwarp();
  }
}

}  // namespace icee
