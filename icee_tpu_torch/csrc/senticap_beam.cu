// K9: the SentiCap base mRNN's whole beam search (beam 20, 21 steps) for a
// batch of images.
//
// Replaces icee_tpu/ops/pallas_senticap_decode.py::mega_senticap_beam_decode
// (the Pallas kernel _kernel :288, call :480).  It computes
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
// What bounds it on the H100: operations.  At 64 images x 20 beams = 1280
// rows, E = H = 512, V = 8800, one step is 2 * 1280 * 1024 * 2048 = 5.4
// GFLOP of cell and 2 * 1280 * 512 * 8800 = 11.5 GFLOP of head: 355 GFLOP
// over 21 steps, 5.3 ms at the CUDA cores' 67 TFLOP/s float32, 2.15 ms at
// 165 (the tensor cores' 495 TF32 over three passes), against ~30 MB of
// weights.  The TPU kernel kept the weights resident in VMEM for a block of
// images and streamed the head over vocabulary tiles; an SM holds 227 KB,
// so here the lever is the tensor cores and the fact that the weights are
// the same for all 21 steps.  The host loops over the steps inside one C
// call; first w_lstm and w are laid out once, k-contiguous and split into
// TF32 hi / lo planes (senticap_beam.cuh); then each step is five launches
// over all images at once: the cell product and the head product at
// float32 accuracy on the tensor cores (3xTF32 by wgmma, A from registers
// and the planes from shared memory; the header says why wgmma), the gates
// (one thread an element), the softmax and top-k (one block a row: the row
// read once into shared memory, the beam least pairs by a threshold and an
// exact order of its few survivors), the selection (one block an image,
// the best completed candidate by a block argmin, the survivors' ranks by
// counting, no sort).
// No atomics: a search gives the same bits on every run.
#include "senticap_beam.cuh"

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// W (K, N) -> planes (Np, 2 Kp) (planes_product.cuh), P 16-byte aligned.
int icee_sb_prepare(const float* W, int K, int N, float* P, void* stream) {
  return (int)sb_prepare(W, K, N, P, static_cast<cudaStream_t>(stream));
}

// C (z, M, N) = A (z, M, K) W_z [+ bias_z] with W_z prepared as planes at
// P + z zp (depth kp), z < batch <= 2; with splits 2 (no bias) the two k
// ranges' partial sums at C and C + zs.
int icee_sb_product(const float* A, long long lda, long long za,
                    const float* P, long long zp, int kp, const float* bias0,
                    const float* bias1, float* C, long long ldc,
                    long long zc, long long zs, int M, int N, int K,
                    int batch, int splits, void* stream) {
  if (batch > 2) return cudaErrorInvalidValue;
  const float* bias[2] = {bias0, bias1 ? bias1 : bias0};
  return (int)sb_product(A, lda, za, P, zp, kp, bias0 ? bias : nullptr, C,
                         ldc, zc, zs, M, N, K, batch, splits,
                         static_cast<cudaStream_t>(stream));
}

// The beam least (nll, token) pairs of each row of nll (R, V), in order
// (the row selection K9 and K10 run, alone).
int icee_sb_row_select(const float* nll, int R, int V, int K, float* top_nll,
                       int* top_tok, void* stream) {
  if (R < 1 || K < 1 || K > V || K > TOPK_THREADS)
    return cudaErrorInvalidValue;
  const int cap = sb_topk_cap(V, K);
  const size_t smem = (size_t)sb_topk_smem(V, K, 1);
  ICEE_TRY(cudaFuncSetAttribute(sb_row_select_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem));
  sb_row_select_kernel<<<R, TOPK_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      nll, V, K, cap, top_nll, top_tok);
  return (int)cudaGetLastError();
}

// plan: ops/senticap_decode.py::launch_plan (paths 1).  x0 (n_img, E)
// visual pseudo-words; emb (V, E), W (E + H, 4H), w (H, V), b (V,).
// Scratch: planes (cell_planes + head_planes floats), xh (R, E + H), c,
// hn, cn (R, H), z (cell_splits, R, 4H), logits (R, V), top_nll / top_tok
// (R, beam),
// seqs (R, L), lp (R,), with R = n_img * beam and L = max_len + 1.
// Results: tok (n_img, L), len, score (n_img,).
int icee_senticap_beam(const SbPlan* plan, const float* x0, const float* emb,
                       const float* W, const float* w, const float* b,
                       float* planes, float* xh, float* c, float* z,
                       float* hn, float* cn, float* logits, float* top_nll,
                       int* top_tok, int* seqs, float* lp, int* tok, int* len,
                       float* score, int n_img, int beam, int E, int H, int V,
                       int max_len, int stop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_img <= 0 || E < 1 || H < 1 || max_len < 0)
    return cudaErrorInvalidValue;
  const SbPlan p = *plan;
  ICEE_TRY((cudaError_t)sb_check_plan(p, beam, E, H, V, max_len, 1));
  const int R = n_img * beam, L = max_len + 1, H4 = 4 * H;
  float* cell_w = planes;
  float* head_w = planes + p.cell_planes;
  ICEE_TRY(cudaFuncSetAttribute(sb_row_topk_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)p.topk_smem));
  ICEE_TRY(cudaFuncSetAttribute(sb_select_kernel<1, false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)p.select_smem));
  ICEE_TRY(sb_prepare(W, E + H, H4, cell_w, st));
  ICEE_TRY(sb_prepare(w, H, V, head_w, st));
  sb_init_kernel<<<264, 256, 0, st>>>(x0, xh, c, seqs, lp, tok, len, score,
                                      nullptr, nullptr, n_img, beam, E, H, L,
                                      stop, 1);
  ICEE_TRY(cudaGetLastError());
  const long long cells = (long long)R * H;
  const int gate_blocks = (int)((cells + 255) / 256 < 4096
                                    ? (cells + 255) / 256 : 4096);
  for (int t = 0; t <= max_len; ++t) {
    ICEE_TRY(sb_product(xh, E + H, 0, cell_w, 0, p.cell_kp, nullptr, z, H4,
                        0, (long long)R * H4, R, H4, E + H, 1, p.cell_splits,
                        st));
    sb_gates_kernel<<<gate_blocks, 256, 0, st>>>(
        z, (long long)R * H4, p.cell_splits, c, hn, cn, R, H);
    ICEE_TRY(cudaGetLastError());
    ICEE_TRY(sb_product(hn, H, 0, head_w, 0, p.head_kp, &b, logits, V, 0, 0,
                        R, V, H, 1, 1, st));
    sb_row_topk_kernel<false><<<R, TOPK_THREADS, p.topk_smem, st>>>(
        logits, nullptr, nullptr, nullptr, nullptr, R, V, H, beam,
        p.topk_cap, top_nll, top_tok);
    ICEE_TRY(cudaGetLastError());
    sb_select_kernel<1, false><<<n_img, SEL_THREADS, p.select_smem, st>>>(
        top_nll, top_tok, hn, cn, emb, nullptr, nullptr, xh, c, seqs, lp,
        nullptr, tok, len, score, nullptr, R, beam, E, H, L, t, max_len,
        stop);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
