// K9: the SentiCap base mRNN's whole beam search (beam 20, 21 steps) for a
// batch of images.
//
// Replaces icee_tpu/ops/pallas_senticap_decode.py::mega_senticap_beam_decode
// (the Pallas kernel _kernel :265, call :480).  It computes
// jax.vmap(senticap/beam.py::make_device_beam(...).run) element for element:
// for each image, beam slot 0 starts live (lp = [0, inf, ...]) from the
// visual pseudo-word x0 = v wvm + bmv (a plain product outside the kernel,
// as the JAX wrapper computes it) with h = c = 0; every step t = 0..max_len
//   1. the cell: z = [x; h] @ w_lstm (no bias), gates [i, f, o, c],
//      c' = f c + i g, h' = o c' (no tanh);
//   2. logits = h' @ w + b;
//   3. an exact two-pass softmax (max, then the sum of exp(l - m)),
//      p = e / se, nll = -log2(p + 1e-37);
//   4. per row the beam lowest (nll, token) pairs, ties to the lowest token:
//      every token with p < ~1e-38 sits on the same -log2(1e-37) plateau,
//      so the rank is by nll then index, never by logit;
//   5. per image, the beam^2 candidate totals lp[parent] + nll: the best
//      completed one (token 0 or the last step) by lp / (t + 1), lowest
//      candidate index among equals, replaces the running best only if
//      strictly lower; the survivors are the beam lowest totals among the
//      other candidates, ties to the lowest candidate index; then h, c and
//      the sequences are gathered from each survivor's parent and the next
//      word embedded.
// Every image runs all max_len + 1 steps: the search has no early end.
//
// What bounds it on the H100: float32 operations.  At 64 images x 20 beams
// = 1280 rows, E = H = 512, V = 8800, one step is 2 * 1280 * 1024 * 2048 =
// 5.4 GFLOP of cell and 2 * 1280 * 512 * 8800 = 11.5 GFLOP of head: 355
// GFLOP over 21 steps, 5.3 ms at 67 TFLOP/s, against ~30 MB of weights.
// The TPU kernel kept the weights resident in VMEM for a block of images and
// selected with one-hot matmuls; here the host loops over the steps inside
// one C call, and each step is five launches over all images at once:
// the cell and head products are gemm_f32.cuh's tiled SIMT products (one
// fmaf chain per output, in k order: the cell's chain runs over [x; h] as
// the JAX dot does), the gates are one thread per element, the softmax and
// top-k are one block per row (the row's nll in shared memory, the beam
// smallest picked one after another by block-wide argmin), and the
// selection is one block per image (candidate ranks by counting, no sort).
// No atomics: a search gives the same bits on every run.
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

// Rows r = image * beam + slot: xh (R, E + H) holds [x; h] for the cell,
// c (R, H); seqs (R, L); lp (R,); the results per image start as the
// all-stop sequence of length 1 with an infinite score.
__global__ void sb_init_kernel(const float* __restrict__ x0, float* xh,
                               float* c, int* seqs, float* lp, int* tok,
                               int* len, float* score, int n_img, int beam,
                               int E, int H, int L, int stop) {
  const long long R = (long long)n_img * beam, W = E + H;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < R * W;
       i += stride) {
    const long long r = i / W, col = i % W;
    xh[i] = col < E ? x0[(r / beam) * E + col] : 0.f;
  }
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < R * H;
       i += stride)
    c[i] = 0.f;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < R * L;
       i += stride)
    seqs[i] = stop;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < R;
       i += stride)
    lp[i] = (i % beam) == 0 ? 0.f : INFINITY;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (long long)n_img * L; i += stride)
    tok[i] = stop;
  for (long long i = blockIdx.x * blockDim.x + threadIdx.x; i < n_img;
       i += stride) {
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

// One block per row of logits (R, V): the row's nll in shared memory, then
// the K smallest (nll, token) pairs in order into top_nll / top_tok (R, K).
__global__ void __launch_bounds__(TOPK_THREADS)
sb_row_topk_kernel(const float* __restrict__ logits, int V, int K,
                   float* top_nll, int* top_tok) {
  extern __shared__ float nll[];  // (V,)
  __shared__ float red[TOPK_WARPS];
  __shared__ float wv[TOPK_WARPS];
  __shared__ int wi[TOPK_WARPS];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float* l = logits + row * V;
  float m = -INFINITY;
  for (int c = tid; c < V; c += TOPK_THREADS) m = fmaxf(m, l[c]);
  m = tk_block_reduce(m, true, red);
  float s = 0.f;
  for (int c = tid; c < V; c += TOPK_THREADS) s += expf(l[c] - m);
  s = tk_block_reduce(s, false, red);
  for (int c = tid; c < V; c += TOPK_THREADS) {
    const float p = expf(l[c] - m) / s;
    nll[c] = -log2f(p + 1e-37f);
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

// One block per image: candidate totals, best completed, survivors, then
// the next step's [x; h], c, sequences and scores.
__global__ void __launch_bounds__(SEL_THREADS)
sb_select_kernel(const float* __restrict__ top_nll,
                 const int* __restrict__ top_tok, const float* __restrict__ hn,
                 const float* __restrict__ cn, const float* __restrict__ emb,
                 float* xh, float* c, int* seqs, float* lp, int* tok,
                 int* len, float* score, int beam, int E, int H, int L, int t,
                 int max_len, int stop) {
  extern __shared__ float sm[];
  const int K2 = beam * beam;
  float* tot = sm;                                  // (K2,)
  float* slp = tot + K2;                            // (beam,) new scores
  int* ctok = reinterpret_cast<int*>(slp + beam);   // (K2,)
  int* sseq = ctok + K2;                            // (beam, L) old sequences
  int* par = sseq + beam * L;                       // (beam,)
  int* wrd = par + beam;                            // (beam,)
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
  for (int i = tid; i < beam * L; i += nt) sseq[i] = seqs[r0 * L + i];
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
    for (int pos = tid; pos < L; pos += nt)
      tok[img * L + pos] = pos == t ? ctok[best_c] : sseq[p * L + pos];
    if (tid == 0) {
      score[img] = best_v;
      len[img] = t + 1;
    }
  }
  if (last) return;
  const int W = E + H;
  for (int i = tid; i < beam * W; i += nt) {
    const int q = i / W, col = i % W;
    const long long src = r0 + par[q];
    xh[(r0 + q) * W + col] = col < E ? emb[(long long)wrd[q] * E + col]
                                     : hn[src * H + col - E];
  }
  for (int i = tid; i < beam * H; i += nt) {
    const int q = i / H;
    c[(r0 + q) * H + i % H] = cn[(r0 + par[q]) * H + i % H];
  }
  for (int i = tid; i < beam * L; i += nt) {
    const int q = i / L, pos = i % L;
    seqs[r0 * L + i] = pos == t ? wrd[q] : sseq[par[q] * L + pos];
  }
  if (tid < beam) lp[r0 + tid] = slp[tid];
}

}  // namespace icee

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of one selection block (bytes).
long long icee_senticap_select_smem(int beam, int max_len) {
  const long long K2 = (long long)beam * beam, L = max_len + 1;
  return 4 * (2 * K2 + 3 * (long long)beam + beam * L);
}

// x0 (n_img, E) visual pseudo-words; emb (V, E), W (E + H, 4H), w (H, V),
// b (V,).  Scratch: xh (R, E + H), c, hn, cn (R, H), z (R, 4H), logits
// (R, V), top_nll / top_tok (R, beam), seqs (R, L), lp (R,), with R =
// n_img * beam and L = max_len + 1.  Results: tok (n_img, L), len, score
// (n_img,).
int icee_senticap_beam(const float* x0, const float* emb, const float* W,
                       const float* w, const float* b, float* xh, float* c,
                       float* z, float* hn, float* cn, float* logits,
                       float* top_nll, int* top_tok, int* seqs, float* lp,
                       int* tok, int* len, float* score, int n_img, int beam,
                       int E, int H, int V, int max_len, int stop,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_img <= 0 || beam < 1 || beam > V || E < 1 || H < 1)
    return cudaErrorInvalidValue;
  const int R = n_img * beam, L = max_len + 1, H4 = 4 * H;
  const size_t topk_smem = sizeof(float) * (size_t)V;
  const size_t sel_smem = (size_t)icee_senticap_select_smem(beam, max_len);
  ICEE_TRY(cudaFuncSetAttribute(sb_row_topk_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)topk_smem));
  ICEE_TRY(cudaFuncSetAttribute(sb_select_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sel_smem));
  sb_init_kernel<<<264, 256, 0, st>>>(x0, xh, c, seqs, lp, tok, len, score,
                                      n_img, beam, E, H, L, stop);
  ICEE_TRY(cudaGetLastError());
  const long long cells = (long long)R * H;
  const int gate_blocks = (int)((cells + 255) / 256 < 4096
                                    ? (cells + 255) / 256 : 4096);
  for (int t = 0; t <= max_len; ++t) {
    ICEE_TRY(gemm('N', xh, E + H, W, H4, z, H4, nullptr, R, H4, E + H, 1, 0,
                  0, 0, 0, st));
    sb_gates_kernel<<<gate_blocks, 256, 0, st>>>(z, c, hn, cn, R, H);
    ICEE_TRY(cudaGetLastError());
    ICEE_TRY(gemm('N', hn, H, w, V, logits, V, b, R, V, H, 1, 0, 0, 0, 0,
                  st));
    sb_row_topk_kernel<<<R, TOPK_THREADS, topk_smem, st>>>(logits, V, beam,
                                                          top_nll, top_tok);
    ICEE_TRY(cudaGetLastError());
    sb_select_kernel<<<n_img, SEL_THREADS, sel_smem, st>>>(
        top_nll, top_tok, hn, cn, emb, xh, c, seqs, lp, tok, len, score,
        beam, E, H, L, t, max_len, stop);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
