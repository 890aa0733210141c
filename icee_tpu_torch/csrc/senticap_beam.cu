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
// one C call, and each step is five launches over all images at once
// (the device functions are senticap_beam.cuh's, shared with K10):
// the cell and head products are gemm_f32.cuh's tiled SIMT products (one
// fmaf chain per output, in k order: the cell's chain runs over [x; h] as
// the JAX dot does), the gates are one thread per element, the softmax and
// top-k are one block per row (the row's nll in shared memory, the beam
// smallest picked one after another by block-wide argmin), and the
// selection is one block per image (candidate ranks by counting, no sort).
// No atomics: a search gives the same bits on every run.
#include "senticap_beam.cuh"

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory of one selection block (bytes).
long long icee_senticap_select_smem(int beam, int max_len) {
  return sb_select_smem(beam, max_len, false);
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
  ICEE_TRY(cudaFuncSetAttribute(sb_row_topk_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)topk_smem));
  ICEE_TRY(cudaFuncSetAttribute(sb_select_kernel<1, false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)sel_smem));
  sb_init_kernel<<<264, 256, 0, st>>>(x0, xh, c, seqs, lp, tok, len, score,
                                      nullptr, nullptr, n_img, beam, E, H, L,
                                      stop, 1);
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
    sb_row_topk_kernel<false><<<R, TOPK_THREADS, topk_smem, st>>>(
        logits, nullptr, R, V, beam, top_nll, top_tok);
    ICEE_TRY(cudaGetLastError());
    sb_select_kernel<1, false><<<n_img, SEL_THREADS, sel_smem, st>>>(
        top_nll, top_tok, hn, cn, emb, nullptr, nullptr, xh, c, seqs, lp,
        nullptr, tok, len, score, nullptr, R, beam, E, H, L, t, max_len,
        stop);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
