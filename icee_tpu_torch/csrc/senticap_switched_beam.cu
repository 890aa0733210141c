// K10: the SentiCap switched two-LSTM model's whole beam search (beam 20,
// 21 steps, the styled decode with its switch-gate trace) for a batch of
// images.
//
// Replaces icee_tpu/ops/pallas_senticap_switched_decode.py::
// mega_senticap_switched_decode (the Pallas kernel _kernel :64, call :341).
// It computes jax.vmap(senticap/beam.py::make_device_beam(one_step(senti =
// +1), 2H, with_attention=True).run) element for element, in the DA_SUM
// test regime: for each image, beam slot 0 starts live from the two visual
// pseudo-words x0_o = v wvm + bmv and x0_n = v wvm_sw + bmv_sw (products
// outside the kernel, as the JAX wrapper computes them) with h = c = 0;
// every step t = 0..max_len, for all images at once,
//   1. both cells: z = [x_o; h_o] w_lstm and z_sw = [x_n; h_n] w_lstm_sw
//      (no bias), gates [i, f, o, c], c' = f c + i g, h' = o c' (no tanh);
//   2. the switch gate att = sigmoid([h'_o; h'_n] . att_w + att_b), one warp
//      a row;
//   3. both heads h'_o w + b and h'_n w_sw + b_sw;
//   4. one block a row: both exact softmaxes, the mixture (1 - att) p_o +
//      att p_n in the JAX step's operation order, nll = -log2(p + 1e-37),
//      and the row's beam lowest (nll, token) pairs;
//   5. one block an image: K9's candidate selection, which also carries the
//      trace (a token's entry is the gate of the step that emitted it);
//   6. the next inputs x_o = wemb[w], x_n = wemb_sw[w], gathered with both
//      paths' h and c from each survivor's parent.
// Steps 4 and 5 are senticap_beam.cuh's device functions, shared with K9.
// Every image runs all max_len + 1 steps: the search has no early end.
//
// What bounds it on the H100: float32 operations.  At 64 images x 20 beams
// = 1280 rows, E = H = 512, V = 8800, one step is 2 x 5.37 GFLOP of cells
// and 2 x 11.5 GFLOP of heads: 710 GFLOP over 21 steps, 10.6 ms at 67
// TFLOP/s, against ~60 MB of weights a step.  The TPU kernel kept both
// weight sets resident in VMEM for a block of images and gathered with
// one-hot matmuls; here the host loops over the steps inside one C call,
// each step eight launches over all images: the four products are
// gemm_f32.cuh's tiled SIMT products (one fmaf chain per output in k
// order), the softmax pair, the mixture and the top-k one block per row
// with the row's nll in shared memory (4 V bytes), the selection one block
// per image (ranks by counting, no sort).  No atomics: a search gives the
// same bits on every run.
#include "senticap_beam.cuh"

namespace icee {

// att (R,) = sigmoid(hn_o[r] . aw[:H] + hn_n[r] . aw[H:] + ab): one warp a
// row, lanes strided over H, then a fixed shuffle tree.
__global__ void sw_gate_kernel(const float* __restrict__ hn,
                               const float* __restrict__ aw,
                               const float* __restrict__ ab, float* att,
                               long long R, int H) {
  const long long row =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // whole warps leave together
  const float* ho = hn + row * H;
  const float* hs = hn + (R + row) * H;
  float s = 0.f;
  for (int j = lane; j < H; j += 32) s += ho[j] * aw[j];
  for (int j = lane; j < H; j += 32) s += hs[j] * aw[H + j];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) att[row] = sb_sigm(s + ab[0]);
}

}  // namespace icee

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of one selection block (bytes).
long long icee_senticap_switched_select_smem(int beam, int max_len) {
  return sb_select_smem(beam, max_len, true);
}

// x0 (2, n_img, E) visual pseudo-words [background; sentiment]; emb_o,
// emb_n (V, E), W_o, W_n (E + H, 4H), w_o, w_n (H, V), b_o, b_n (V,), aw
// (2H,), ab (1,).  Scratch: xh (2, R, E + H), c, hn, cn (2, R, H), z (2, R,
// 4H), att (R,), logits (2, R, V), top_nll / top_tok (R, beam), seqs (R,
// L), lp (R,), trace (R, L), with R = n_img * beam and L = max_len + 1.
// Results: tok (n_img, L), len, score (n_img,), att_trace (n_img, L).
int icee_senticap_switched_beam(
    const float* x0, const float* emb_o, const float* emb_n, const float* W_o,
    const float* W_n, const float* w_o, const float* w_n, const float* b_o,
    const float* b_n, const float* aw, const float* ab, float* xh, float* c,
    float* z, float* hn, float* cn, float* att, float* logits,
    float* top_nll, int* top_tok, int* seqs, float* lp, float* trace,
    int* tok, int* len, float* score, float* att_trace, int n_img, int beam,
    int E, int H, int V, int max_len, int stop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_img <= 0 || beam < 1 || beam > V || E < 1 || H < 1)
    return cudaErrorInvalidValue;
  const long long R = (long long)n_img * beam;
  const int L = max_len + 1, H4 = 4 * H, W = E + H;
  const size_t topk_smem = sizeof(float) * (size_t)V;
  const size_t sel_smem = (size_t)sb_select_smem(beam, max_len, true);
  ICEE_TRY(cudaFuncSetAttribute(sb_row_topk_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)topk_smem));
  ICEE_TRY(cudaFuncSetAttribute(sb_select_kernel<2, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sel_smem));
  sb_init_kernel<<<264, 256, 0, st>>>(x0, xh, c, seqs, lp, tok, len, score,
                                      trace, att_trace, n_img, beam, E, H, L,
                                      stop, 2);
  ICEE_TRY(cudaGetLastError());
  const long long cells = 2 * R * H;
  const int gate_blocks = (int)((cells + 255) / 256 < 4096
                                    ? (cells + 255) / 256 : 4096);
  const int att_blocks = (int)((R * 32 + 255) / 256);
  const int Ri = (int)R;
  for (int t = 0; t <= max_len; ++t) {
    ICEE_TRY(gemm('N', xh, W, W_o, H4, z, H4, nullptr, Ri, H4, W, 1, 0, 0,
                  0, 0, st));
    ICEE_TRY(gemm('N', xh + R * W, W, W_n, H4, z + R * H4, H4, nullptr, Ri,
                  H4, W, 1, 0, 0, 0, 0, st));
    sb_gates_kernel<<<gate_blocks, 256, 0, st>>>(z, c, hn, cn, 2 * R, H);
    ICEE_TRY(cudaGetLastError());
    sw_gate_kernel<<<att_blocks, 256, 0, st>>>(hn, aw, ab, att, R, H);
    ICEE_TRY(cudaGetLastError());
    ICEE_TRY(gemm('N', hn, H, w_o, V, logits, V, b_o, Ri, V, H, 1, 0, 0, 0,
                  0, st));
    ICEE_TRY(gemm('N', hn + R * H, H, w_n, V, logits + R * V, V, b_n, Ri, V,
                  H, 1, 0, 0, 0, 0, st));
    sb_row_topk_kernel<true><<<Ri, TOPK_THREADS, topk_smem, st>>>(
        logits, att, R, V, beam, top_nll, top_tok);
    ICEE_TRY(cudaGetLastError());
    sb_select_kernel<2, true><<<n_img, SEL_THREADS, sel_smem, st>>>(
        top_nll, top_tok, hn, cn, emb_o, emb_n, att, xh, c, seqs, lp, trace,
        tok, len, score, att_trace, R, beam, E, H, L, t, max_len, stop);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
