// Device functions shared by the decode kernels: decode_step.cu (one
// FactoredLSTM beam step, K1) and beam.cu (the whole beam search, K2, with
// the FactoredLSTM or the NIC decoder's torch LSTM cell).
//
// Both kernels call the SAME functions for the cell, the vocab head, the
// per-tile reduction and the tile merge, and every output element is a fixed
// sequential chain of fmaf/adds (the library is built with -fmad=false, so
// the compiler contracts nothing on its own).  The arithmetic for one row
// therefore does not depend on how many rows a block holds, and a beam run
// through K1 step by step gives bit-identical scores to the same beam run
// inside K2 — the serving engine's serial path (K1) and batched path (K2)
// return the same captions.  The column-split path of K1 and K6
// (split_step.cuh) writes each product out itself, column by column over
// the whole card, but as the same chains: the same k order from 0.f, the
// same bias adds after; only tile_reduce and merge_row it calls as they are.
//
// Layouts are the JAX package's: linear weights (in, out), V_w (E, 4F),
// S_w[style] (4, F, F), U_w (4, F, H), W_w (H, 4H), C_w (H, V); gate order
// [i, f, o, c]; h = o * c with no tanh (stylenet/model.py:153).  The LSTM
// cell: W_ih (E, 4H), W_hh (H, 4H), b_ih, b_hh (4H); gate order
// [i, f, g, o]; h = o * tanh(c).
//
// What bounds the matmuls: the weights stream from L2 to the SM (every
// weight element is read once per block per step), so the products are
// written for bytes in flight: each thread owns 4 adjacent output columns,
// reads the weights as float4 and keeps 8 rows of k (128 bytes) in flight.
// F, H and V must be multiples of 4 (the wrappers check).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace icee {

constexpr int VT = 256;          // vocab tile width: one partial top-k per tile
constexpr int QT = VT / 4;       // threads per tile (4 columns each)
constexpr int KMAX = 8;          // largest beam / top-k the kernels take
constexpr float NEG = -1e30f;    // masked logit / dead-beam score (JAX NEG)
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
// Row stride of the cell's scratch planes: one row holds 4F or 4H floats.
__host__ __device__ inline int cell_ld(int F, int H) {
  return round4(4 * (F > H ? F : H));
}

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

// Width of the cell's scratch planes for each weight set.
__host__ __device__ inline int cell_width(const CellWeights& w) {
  return cell_ld(w.F, w.H);
}
__host__ __device__ inline int cell_width(const LstmWeights& w) {
  return cell_ld(w.H, w.H);
}

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

// Block-level FactoredLSTM cell for `rows` (<= MAXR) rows.  xs (rows x ldx)
// and hs (rows x ldh) are in shared memory; s1 and s2 are shared scratch
// planes (rows x ld, ld = cell_ld(F, H)); c_in may be shared or global.
// Each stage spans all four gates, so every thread has column quads to work
// on: v = x V -> s1, s = v S[style] -> s2, z = s U + h W -> s1, then the
// gates.  h_out / c_out may be global or alias s2 (dead by then).  All
// threads of the block must call it; it ends with a barrier.
template <int MAXR>
__device__ void factored_cell(const float* xs, int ldx, const float* hs,
                              int ldh, const float* c_in, int ldc,
                              const CellWeights& w, float* s1, float* s2,
                              int ld, int rows, float* h_out, int ldho,
                              float* c_out, int ldco) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int F = w.F, H = w.H;
  float acc[MAXR][4];
  // v_g = x @ V_w[:, gF:(g+1)F] + V_b[g], all gates: 4F columns
  for (int q = tid; q < F; q += nt) {
    const int col = 4 * q;
    dot4<MAXR>(xs, ldx, rows, w.Vw, 4 * F, col, w.E, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j) s1[r * ld + col + j] = acc[r][j] + w.Vb[col + j];
  }
  __syncthreads();
  // s_g = v_g @ S_w[style, g] + S_b[style, g]
  for (int q = tid; q < F; q += nt) {
    const int g = (4 * q) / F, col = (4 * q) % F;
    dot4<MAXR>(s1 + g * F, ld, rows, w.Sw + (size_t)g * F * F, F, col, F, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s2[r * ld + g * F + col + j] = acc[r][j] + w.Sb[g * F + col + j];
  }
  __syncthreads();
  // z_g = (s_g @ U_w[g] + U_b[g]) + (h @ W_w[:, gH:(g+1)H] + W_b[g]); the
  // first sum parks in s1 (v is dead) while the second is formed
  for (int q = tid; q < H; q += nt) {
    const int g = (4 * q) / H, col = (4 * q) % H, o = g * H + col;
    dot4<MAXR>(s2 + g * F, ld, rows, w.Uw + (size_t)g * F * H, H, col, F, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j) s1[r * ld + o + j] = acc[r][j] + w.Ub[o + j];
    dot4<MAXR>(hs, ldh, rows, w.Ww, 4 * H, o, H, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s1[r * ld + o + j] = s1[r * ld + o + j] + (acc[r][j] + w.Wb[o + j]);
  }
  __syncthreads();
  for (int i = tid; i < rows * H; i += nt) {
    const int r = i / H, j = i % H;
    const float* z = s1 + r * ld + j;
    const float i_t = sigmoid(z[0]), f_t = sigmoid(z[H]);
    const float o_t = sigmoid(z[2 * H]), g_t = tanhf(z[3 * H]);
    const float c_new = f_t * c_in[r * ldc + j] + i_t * g_t;
    c_out[r * ldco + j] = c_new;
    h_out[r * ldho + j] = o_t * c_new;  // no tanh: reference quirk
  }
  __syncthreads();
}

// Block-level torch LSTMCell (the NIC decoder, nic/model.py:51) with the
// factored_cell interface: z = ((x W_ih + b_ih) + h W_hh) + b_hh over all
// 4H columns into the s1 plane (the XLA cell's float order, ops/cells.py:
// 79), then the gates [i, f, g, o], c' = f c + i g, h' = o tanh(c').  s2 is
// not used, so h_out / c_out may alias it.  All threads of the block must
// call it; it ends with a barrier.
template <int MAXR>
__device__ void lstm_cell(const float* xs, int ldx, const float* hs, int ldh,
                          const float* c_in, int ldc, const LstmWeights& w,
                          float* s1, float* /*s2*/, int ld, int rows,
                          float* h_out, int ldho, float* c_out, int ldco) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int H = w.H;
  float acc[MAXR][4];
  for (int q = tid; q < H; q += nt) {
    const int col = 4 * q;
    dot4<MAXR>(xs, ldx, rows, w.Wih, 4 * H, col, w.E, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j) s1[r * ld + col + j] = acc[r][j] + w.bih[col + j];
    dot4<MAXR>(hs, ldh, rows, w.Whh, 4 * H, col, H, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s1[r * ld + col + j] = (s1[r * ld + col + j] + acc[r][j]) + w.bhh[col + j];
  }
  __syncthreads();
  for (int i = tid; i < rows * H; i += nt) {
    const int r = i / H, j = i % H;
    const float* z = s1 + r * ld + j;
    const float i_t = sigmoid(z[0]), f_t = sigmoid(z[H]);
    const float g_t = tanhf(z[2 * H]), o_t = sigmoid(z[3 * H]);
    const float c_new = f_t * c_in[r * ldc + j] + i_t * g_t;
    c_out[r * ldco + j] = c_new;
    h_out[r * ldho + j] = o_t * tanhf(c_new);
  }
  __syncthreads();
}

// One cell step through the weight set's cell (overloads for the mega
// kernel's template).
template <int MAXR>
__device__ __forceinline__ void cell_step(
    const float* xs, int ldx, const float* hs, int ldh, const float* c_in,
    int ldc, const CellWeights& w, float* s1, float* s2, int ld, int rows,
    float* h_out, int ldho, float* c_out, int ldco) {
  factored_cell<MAXR>(xs, ldx, hs, ldh, c_in, ldc, w, s1, s2, ld, rows, h_out,
                      ldho, c_out, ldco);
}
template <int MAXR>
__device__ __forceinline__ void cell_step(
    const float* xs, int ldx, const float* hs, int ldh, const float* c_in,
    int ldc, const LstmWeights& w, float* s1, float* s2, int ld, int rows,
    float* h_out, int ldho, float* c_out, int ldco) {
  lstm_cell<MAXR>(xs, ldx, hs, ldh, c_in, ldc, w, s1, s2, ld, rows, h_out,
                  ldho, c_out, ldco);
}

// Logits of vocab columns col..col+3 for `rows` rows: h (shared, rows x ldh)
// @ C_w[:, col:col+4] + C_b, written to dst[r * ldd + j]; columns past V
// hold NEG so they never win and add exp(NEG - m) = 0 to the normalizer.
template <int MAXR>
__device__ __forceinline__ void head_quad(const float* hs, int ldh, int rows,
                                          const float* __restrict__ Cw,
                                          const float* __restrict__ Cb,
                                          int H, int V, int col, float* dst,
                                          int ldd) {
  if (col < V) {  // V % 4 == 0: a quad is wholly inside or outside
    float acc[MAXR][4];
    dot4<MAXR>(hs, ldh, rows, Cw, V, col, H, acc);
    const float4 b = __ldg(reinterpret_cast<const float4*>(Cb + col));
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < rows) {
        dst[r * ldd + 0] = acc[r][0] + b.x;
        dst[r * ldd + 1] = acc[r][1] + b.y;
        dst[r * ldd + 2] = acc[r][2] + b.z;
        dst[r * ldd + 3] = acc[r][3] + b.w;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[r * ldd + j] = NEG;
  }
}

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

// One warp merges a row's per-tile partials: logZ = M + log(sum_t se_t *
// exp(m_t - M)) summed in tile order, then the exact top-k of the n_tiles*k
// candidates (value desc, lowest vocab index on ties).  cand_v is consumed.
// Lane 0 writes logp[q] = value - logZ and idx[q].
__device__ void merge_row(const float* pm, const float* pse, float* cand_v,
                          const int* cand_i, int n_tiles, int k, float* logp,
                          int* idx) {
  const int lane = threadIdx.x & 31;
  float M = -INFINITY;
  for (int t = lane; t < n_tiles; t += 32) M = fmaxf(M, pm[t]);
  M = warp_max(M);
  float S = 0.f;
  for (int t = 0; t < n_tiles; ++t) S += pse[t] * expf(pm[t] - M);
  const float logz = M + logf(S);
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
