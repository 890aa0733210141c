// The SentiCap beam searches' device functions, shared by K9
// (senticap_beam.cu, the base mRNN) and K10 (senticap_switched_beam.cu, the
// switched two-LSTM model).  Both compute
// jax.vmap(senticap/beam.py::make_device_beam(...).run) element for element.
//
// Rows r = image * beam + slot.  A model with P paths (1 for the base
// model, 2 for the switched one: background, then sentiment) keeps each
// path's state as its own (R, .) block: xh (P, R, E + H) holds [x; h] for
// the cells, c, hn, cn (P, R, H), z (P, R, 4H), logits (P, R, V).  The
// search state is per row: seqs (R, L), lp (R,) and, with a trace, trace
// (R, L); the results per image start as the all-stop sequence of length 1
// with an infinite score (and a zero trace).
//
//   sb_gates_kernel       one thread per cell element: gates [i, f, o, c],
//                         c' = f c + i g, h' = o c' (no tanh);
//   sb_row_topk_kernel    one block per row: the exact softmax of one head
//                         (MIX = false) or the DA_SUM mixture of two,
//                         (1 - att) (e_o / se_o) + att (e_n / se_n) in that
//                         operation order (MIX = true), then nll =
//                         -log2(p + 1e-37) in shared memory and the beam
//                         lowest (nll, token) pairs, ties to the lowest
//                         token: every token with p < ~1e-38 sits on the
//                         same plateau, so the rank is by nll then index,
//                         never by logit;
//   sb_select_kernel      one block per image: the beam^2 candidate totals
//                         lp[parent] + nll; the best completed one (token 0
//                         or the last step) by lp / (t + 1), lowest
//                         candidate index among equals, replaces the
//                         running best only if strictly lower; the
//                         survivors are the beam lowest totals among the
//                         others, ties to the lowest candidate index
//                         (ranks by counting, no sort); then every path's
//                         h, c, the sequences (and the trace, whose [t] is
//                         the gate of the parent row at this step: the gate
//                         of the step that emitted the token) are gathered
//                         from each survivor's parent and the next word
//                         embedded per path.
// No atomics: a search gives the same bits on every run.
#pragma once

#include <math.h>

#include "gemm_f32.cuh"
#include "scan_step.cuh"  // ICEE_TRY

namespace icee {

constexpr int TOPK_THREADS = 256;
constexpr int TOPK_WARPS = TOPK_THREADS / 32;
constexpr int SEL_THREADS = 512;

__device__ __forceinline__ float sb_sigm(float z) {
  return 1.f / (1.f + expf(-z));
}

// (v, i) < (w, j) in the order (value, then index).
__device__ __forceinline__ bool lex_less(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// x0 (P, n_img, E) -> xh's x columns for every beam slot, h = c = 0; the
// search state and the results as above.  trace and att_trace may be null.
__global__ void sb_init_kernel(const float* __restrict__ x0, float* xh,
                               float* c, int* seqs, float* lp, int* tok,
                               int* len, float* score, float* trace,
                               float* att_trace, int n_img, int beam, int E,
                               int H, int L, int stop, int paths) {
  const long long R = (long long)n_img * beam, W = E + H;
  const long long PR = paths * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long i = i0; i < PR * W; i += stride) {
    const long long r = i / W, col = i % W;
    const long long path = r / R, img = (r % R) / beam;
    xh[i] = col < E ? x0[(path * n_img + img) * E + col] : 0.f;
  }
  for (long long i = i0; i < PR * H; i += stride) c[i] = 0.f;
  for (long long i = i0; i < R * L; i += stride) {
    seqs[i] = stop;
    if (trace) trace[i] = 0.f;
  }
  for (long long i = i0; i < R; i += stride)
    lp[i] = (i % beam) == 0 ? 0.f : INFINITY;
  for (long long i = i0; i < (long long)n_img * L; i += stride) {
    tok[i] = stop;
    if (att_trace) att_trace[i] = 0.f;
  }
  for (long long i = i0; i < n_img; i += stride) {
    len[i] = 1;
    score[i] = INFINITY;
  }
}

// z (R, 4H) pre-activations, c (R, H) -> hn, cn (R, H).
__global__ void sb_gates_kernel(const float* __restrict__ z,
                                const float* __restrict__ c, float* hn,
                                float* cn, long long R, int H) {
  const long long n = R * H;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / H;
    const int j = (int)(i % H);
    const float* zr = z + r * 4 * H;
    const float ig = sb_sigm(zr[j]);
    const float fg = sb_sigm(zr[H + j]);
    const float og = sb_sigm(zr[2 * H + j]);
    const float cc = fg * c[i] + ig * tanhf(zr[3 * H + j]);
    cn[i] = cc;
    hn[i] = og * cc;  // no tanh: reference quirk
  }
}

__device__ __forceinline__ float tk_block_reduce(float v, bool is_max,
                                                 float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int q = 1; q < TOPK_WARPS; ++q) t = is_max ? fmaxf(t, red[q]) : t + red[q];
  return t;
}

// The row's max and sum of exp(l - max), block-wide.
__device__ __forceinline__ void tk_max_sum(const float* l, int V, float* red,
                                           float* m_out, float* s_out) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  for (int c = tid; c < V; c += TOPK_THREADS) m = fmaxf(m, l[c]);
  m = tk_block_reduce(m, true, red);
  float s = 0.f;
  for (int c = tid; c < V; c += TOPK_THREADS) s += expf(l[c] - m);
  s = tk_block_reduce(s, false, red);
  *m_out = m;
  *s_out = s;
}

// One block per row r < R of logits (R, V) (with MIX, of the two heads'
// logits (2, R, V) mixed by att (R,)): the row's nll in shared memory, then
// the K smallest (nll, token) pairs in order into top_nll / top_tok (R, K).
template <bool MIX>
__global__ void __launch_bounds__(TOPK_THREADS)
sb_row_topk_kernel(const float* __restrict__ logits,
                   const float* __restrict__ att, long long R, int V, int K,
                   float* top_nll, int* top_tok) {
  extern __shared__ float nll[];  // (V,)
  __shared__ float red[TOPK_WARPS];
  __shared__ float wv[TOPK_WARPS];
  __shared__ int wi[TOPK_WARPS];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float* l = logits + row * V;
  float m, s;
  tk_max_sum(l, V, red, &m, &s);
  if (MIX) {
    const float* ln = logits + (R + row) * V;
    float mn, sn;
    tk_max_sum(ln, V, red, &mn, &sn);
    const float a = att[row], one_m_a = 1.f - a;
    for (int c = tid; c < V; c += TOPK_THREADS) {
      const float p = one_m_a * (expf(l[c] - m) / s)
                      + a * (expf(ln[c] - mn) / sn);
      nll[c] = -log2f(p + 1e-37f);
    }
  } else {
    for (int c = tid; c < V; c += TOPK_THREADS) {
      const float p = expf(l[c] - m) / s;
      nll[c] = -log2f(p + 1e-37f);
    }
  }
  __syncthreads();
  // the next smallest pair is the least one above the last taken
  float lv = -INFINITY;
  int li = -1;
  for (int k = 0; k < K; ++k) {
    float bv = INFINITY;
    int bi = 0x7fffffff;
    for (int c = tid; c < V; c += TOPK_THREADS) {
      const float v = nll[c];
      if (lex_less(lv, li, v, c) && lex_less(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (lex_less(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    bv = wv[0];
    bi = wi[0];
    for (int q = 1; q < TOPK_WARPS; ++q)
      if (lex_less(wv[q], wi[q], bv, bi)) {
        bv = wv[q];
        bi = wi[q];
      }
    __syncthreads();  // wv / wi are rewritten next round
    if (tid == 0) {
      top_nll[row * K + k] = bv;
      top_tok[row * K + k] = bi;
    }
    lv = bv;
    li = bi;
  }
}

// Shared memory of one selection block (bytes).
inline long long sb_select_smem(int beam, int max_len, bool with_trace) {
  const long long K2 = (long long)beam * beam, L = max_len + 1;
  return 4 * (2 * K2 + 3 * (long long)beam + beam * L * (with_trace ? 2 : 1));
}

// One block per image: candidate totals, best completed, survivors, then
// the next step's [x; h], c of each of the PATHS paths (emb[p] the path's
// word embedding (V, E)), the sequences and scores; with TRACE also the
// traces, from att (R,), the gate each row computed at this step.
template <int PATHS, bool TRACE>
__global__ void __launch_bounds__(SEL_THREADS)
sb_select_kernel(const float* __restrict__ top_nll,
                 const int* __restrict__ top_tok, const float* __restrict__ hn,
                 const float* __restrict__ cn, const float* __restrict__ emb0,
                 const float* __restrict__ emb1, const float* __restrict__ att,
                 float* xh, float* c, int* seqs, float* lp, float* trace,
                 int* tok, int* len, float* score, float* att_trace,
                 long long R, int beam, int E, int H, int L, int t,
                 int max_len, int stop) {
  extern __shared__ float sm[];
  const int K2 = beam * beam;
  float* tot = sm;                                  // (K2,)
  float* slp = tot + K2;                            // (beam,) new scores
  int* ctok = reinterpret_cast<int*>(slp + beam);   // (K2,)
  int* sseq = ctok + K2;                            // (beam, L) old sequences
  int* par = sseq + beam * L;                       // (beam,)
  int* wrd = par + beam;                            // (beam,)
  float* strace = reinterpret_cast<float*>(wrd + beam);  // (beam, L), TRACE
  __shared__ float best_v;
  __shared__ int best_c, improves;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long img = blockIdx.x, r0 = img * beam;
  const bool last = (t == max_len);
  for (int i = tid; i < K2; i += nt) {
    const int p = i / beam;
    tot[i] = lp[r0 + p] + top_nll[(r0 + p) * beam + i % beam];
    ctok[i] = top_tok[(r0 + p) * beam + i % beam];
  }
  for (int i = tid; i < beam * L; i += nt) {
    sseq[i] = seqs[r0 * L + i];
    if (TRACE) strace[i] = trace[r0 * L + i];
  }
  __syncthreads();
  // best completed: the first minimum of lp / (t + 1) over stop candidates
  if (tid == 0) {
    float bv = INFINITY;
    int bc = 0;
    const float denom = (float)(t + 1);
    for (int i = 0; i < K2; ++i) {
      const float v = (ctok[i] == stop || last) ? tot[i] / denom : INFINITY;
      if (v < bv) {
        bv = v;
        bc = i;
      }
    }
    best_v = bv;
    best_c = bc;
    improves = bv < score[img];  // strict: the first best stays on ties
  }
  // survivors: the rank of each candidate among the non-stop totals
  for (int i = tid; i < K2; i += nt) {
    const float vi = (ctok[i] == stop || last) ? INFINITY : tot[i];
    int rank = 0;
    for (int j = 0; j < K2 && rank < beam; ++j) {
      const float vj = (ctok[j] == stop || last) ? INFINITY : tot[j];
      rank += lex_less(vj, j, vi, i);
    }
    if (rank < beam) {
      slp[rank] = vi;
      par[rank] = i / beam;
      wrd[rank] = ctok[i];
    }
  }
  __syncthreads();
  if (improves) {
    const int p = best_c / beam;
    for (int pos = tid; pos < L; pos += nt) {
      tok[img * L + pos] = pos == t ? ctok[best_c] : sseq[p * L + pos];
      if (TRACE)
        att_trace[img * L + pos] = pos == t ? att[r0 + p]
                                            : strace[p * L + pos];
    }
    if (tid == 0) {
      score[img] = best_v;
      len[img] = t + 1;
    }
  }
  if (last) return;
  const int W = E + H;
  for (int path = 0; path < PATHS; ++path) {
    const float* emb = path == 0 ? emb0 : emb1;
    const long long off = path * R;
    for (int i = tid; i < beam * W; i += nt) {
      const int q = i / W, col = i % W;
      const long long src = off + r0 + par[q];
      xh[(off + r0 + q) * W + col] =
          col < E ? emb[(long long)wrd[q] * E + col] : hn[src * H + col - E];
    }
    for (int i = tid; i < beam * H; i += nt) {
      const int q = i / H;
      c[(off + r0 + q) * H + i % H] = cn[(off + r0 + par[q]) * H + i % H];
    }
  }
  for (int i = tid; i < beam * L; i += nt) {
    const int q = i / L, pos = i % L;
    seqs[r0 * L + i] = pos == t ? wrd[q] : sseq[par[q] * L + pos];
    if (TRACE)
      trace[r0 * L + i] = pos == t ? att[r0 + par[q]]
                                   : strace[par[q] * L + pos];
  }
  if (tid < beam) lp[r0 + tid] = slp[tid];
}

}  // namespace icee
