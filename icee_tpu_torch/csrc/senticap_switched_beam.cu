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
//   2. both heads h'_o w + b and h'_n w_sw + b_sw;
//   3. one block a row: the switch gate att = sigmoid([h'_o; h'_n] . att_w
//      + att_b) (one warp), both exact softmaxes, the mixture (1 - att) p_o
//      + att p_n in the JAX step's operation order, nll = -log2(p + 1e-37),
//      and the row's beam lowest (nll, token) pairs;
//   4. one block an image: K9's candidate selection, which also carries the
//      trace (a token's entry is the gate of the step that emitted it);
//   5. the next inputs x_o = wemb[w], x_n = wemb_sw[w], gathered with both
//      paths' h and c from each survivor's parent.
// Every stage is senticap_beam.cuh's, shared with K9.
// Every image runs all max_len + 1 steps: the search has no early end.
//
// What bounds it on the H100: operations.  At 64 images x 20 beams = 1280
// rows, E = H = 512, V = 8800, one step is 2 x 5.37 GFLOP of cells and 2 x
// 11.5 GFLOP of heads: 710 GFLOP over 21 steps, 10.6 ms at the CUDA cores'
// 67 TFLOP/s float32, 4.3 ms at 165 (three TF32 passes on the tensor
// cores), against ~60 MB of weights.  The TPU kernel kept both weight sets
// resident in VMEM for a block of images and gathered with one-hot
// matmuls; here, as in K9 (senticap_beam.cu; senticap_beam.cuh says why
// wgmma), the four weights are laid out once a call as TF32 hi / lo
// planes, both paths' planes in one buffer, and the host loops over the
// steps inside one C call, five launches a step over all images: both
// cells in one 3xTF32 product launch (a path a blockIdx.z), the gates of
// both paths, both heads in one launch, the row pass (the switch gate, the
// mixture, the top-k: the rows read once into shared memory, 8 V bytes),
// the selection (one block an image, ranks by counting, no sort).  No
// atomics: a search gives the same bits on every run.
#include "senticap_beam.cuh"

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// plan: ops/senticap_decode.py::launch_plan (paths 2).  x0 (2, n_img, E)
// visual pseudo-words [background; sentiment]; emb_o, emb_n (V, E), W_o,
// W_n (E + H, 4H), w_o, w_n (H, V), b_o, b_n (V,), aw (2H,), ab (1,).
// Scratch: planes (2 (cell_planes + head_planes) floats: both cells', then
// both heads'), xh (2, R, E + H), c, hn, cn (2, R, H), z (cell_splits,
// 2, R, 4H), att (R,), logits (2, R, V), top_nll / top_tok (R, beam), seqs
// (R, L), lp (R,), trace (R, L), with R = n_img * beam and L = max_len + 1.
// Results: tok (n_img, L), len, score (n_img,), att_trace (n_img, L).
int icee_senticap_switched_beam(
    const SbPlan* plan, const float* x0, const float* emb_o,
    const float* emb_n, const float* W_o, const float* W_n, const float* w_o,
    const float* w_n, const float* b_o, const float* b_n, const float* aw,
    const float* ab, float* planes, float* xh, float* c, float* z, float* hn,
    float* cn, float* att, float* logits, float* top_nll, int* top_tok,
    int* seqs, float* lp, float* trace, int* tok, int* len, float* score,
    float* att_trace, int n_img, int beam, int E, int H, int V, int max_len,
    int stop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_img <= 0 || E < 1 || H < 1 || max_len < 0)
    return cudaErrorInvalidValue;
  const SbPlan p = *plan;
  ICEE_TRY((cudaError_t)sb_check_plan(p, beam, E, H, V, max_len, 2));
  const long long R = (long long)n_img * beam;
  const int L = max_len + 1, H4 = 4 * H, W = E + H, Ri = (int)R;
  float* cell_w = planes;
  float* head_w = planes + 2 * p.cell_planes;
  ICEE_TRY(cudaFuncSetAttribute(sb_row_topk_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)p.topk_smem));
  ICEE_TRY(cudaFuncSetAttribute(sb_select_kernel<2, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)p.select_smem));
  ICEE_TRY(sb_prepare(W_o, W, H4, cell_w, st));
  ICEE_TRY(sb_prepare(W_n, W, H4, cell_w + p.cell_planes, st));
  ICEE_TRY(sb_prepare(w_o, H, V, head_w, st));
  ICEE_TRY(sb_prepare(w_n, H, V, head_w + p.head_planes, st));
  sb_init_kernel<<<264, 256, 0, st>>>(x0, xh, c, seqs, lp, tok, len, score,
                                      trace, att_trace, n_img, beam, E, H, L,
                                      stop, 2);
  ICEE_TRY(cudaGetLastError());
  const long long cells = 2 * R * H;
  const int gate_blocks = (int)((cells + 255) / 256 < 4096
                                    ? (cells + 255) / 256 : 4096);
  const float* heads[2] = {b_o, b_n};   // the two paths' head biases
  for (int t = 0; t <= max_len; ++t) {
    ICEE_TRY(sb_product(xh, W, R * W, cell_w, p.cell_planes, p.cell_kp,
                        nullptr, z, H4, R * H4, 2 * R * H4, Ri, H4, W, 2,
                        p.cell_splits, st));
    sb_gates_kernel<<<gate_blocks, 256, 0, st>>>(z, 2 * R * H4, p.cell_splits,
                                                 c, hn, cn, 2 * R, H);
    ICEE_TRY(cudaGetLastError());
    ICEE_TRY(sb_product(hn, H, R * H, head_w, p.head_planes, p.head_kp,
                        heads, logits, V, R * V, 0, Ri, V, H, 2, 1, st));
    sb_row_topk_kernel<true><<<Ri, TOPK_THREADS, p.topk_smem, st>>>(
        logits, hn, aw, ab, att, R, V, H, beam, p.topk_cap, top_nll,
        top_tok);
    ICEE_TRY(cudaGetLastError());
    sb_select_kernel<2, true><<<n_img, SEL_THREADS, p.select_smem, st>>>(
        top_nll, top_tok, hn, cn, emb_o, emb_n, att, xh, c, seqs, lp, trace,
        tok, len, score, att_trace, R, beam, E, H, L, t, max_len, stop);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
