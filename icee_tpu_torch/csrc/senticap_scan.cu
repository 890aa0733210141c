// K8: the teacher-forced SentiCap mRNN training scan, forward and backward.
//
// Replaces icee_tpu/ops/pallas_senticap_train.py::fused_senticap_scan (a
// custom_vjp around the Pallas kernels _fwd_kernel :61 and _bwd_kernel :79,
// calls :173 and :224): T steps of the SentiCap cell (mrnn.py:404-440) from
// zero state, z = [x; h] @ w_lstm with no bias, gate order [i, f, o, c],
// c = f c + i g, h = o c (no tanh); the backward returns dx and dW, and
// clamps the gradient flowing into h_{t-1} THROUGH THE CELL to +-gclip
// (the reference's GradClip on h), not the output cotangent.
//
// What bounds it on the H100: float32 operations.  At the training shape
// (N = B * T = 128 * 22 = 2816 rows, E = H = 512) the forward is
// 2 N (E + H) 4H = 11.8 GFLOP and the backward twice that, against ~8 MB of
// weights and ~20 MB of activations.  The TPU kernel kept w_lstm resident in
// VMEM across a sequential grid and accumulated dW there; an SM has 228 KB
// and its blocks run in no order.  The design is K4's (nic_scan.cu):
//   forward (a): P = x W_x (W_x = w_lstm[:E]) for all N rows as one tiled
//     product (gemm_f32.cuh), parked in the gates buffer;
//   forward (b): one launch per step (scan_step.cuh), z = P_t + h W_h and
//     the gates (cell_gates.cuh SentiGates), saved for the backward;
//   backward (c): one launch per reverse step for the (dh, dc) chain from
//     the saved gates, writing dZ (N, 4H), with clamp(dZ_{t+1} W_h^T) fused
//     in;
//   backward (d): dW[:E] = x^T dZ, dW[E:] = H_prev^T dZ (h shifted one
//     step, zero at t = 0) and dx = dZ W_x^T as products over all N rows.
// The input side is summed before the recurrent side (the TPU kernel sums
// one [x; h] dot in k order): a rounding-level difference.  No atomics
// anywhere: a step gives the same bits on every run.  CUDA-core fmaf only
// (no TF32), so the port holds the JAX package's float32 numerics.
#include "gemm_f32.cuh"
#include "cell_gates.cuh"

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, T, E); W (E + H, 4H).  Outputs h_seq, c_seq (B, T, H); saved for
// the backward: gates (N, 4H) = the [i, f, o, c] activations.
int icee_senticap_scan_fwd(const float* x, const float* W, float* h_seq,
                           float* c_seq, float* gates, int B, int T, int E,
                           int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * T, H4 = 4 * H;
  const float* Wh = W + (long long)E * H4;
  // P = x W_x, parked in gates until each step overwrites it
  ICEE_TRY(gemm('N', x, E, W, H4, gates, H4, nullptr, N, H4, E, 1, 0, 0, 0, 0,
                st));
  const dim3 grid((H + SJ - 1) / SJ, (B + SR - 1) / SR);
  const int vec = H % 4 == 0 && aligned16(h_seq) && aligned16(Wh);
  for (int t = 0; t < T; ++t) {
    fwd_step_kernel<SentiGates><<<grid, S_THREADS, 0, st>>>(
        Wh, nullptr, gates, h_seq, c_seq, B, T, H, t, vec);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

// From the forward's saved gates and dh_seq (B, T, H): dx (N, E) and dW
// (E + H, 4H).  h_prev (N, H) is h_seq shifted one step (zero at t = 0).
// Scratch: dZ (N, 4H), dc (B, H).
int icee_senticap_scan_bwd(const float* x, const float* W,
                           const float* h_prev, const float* c_seq,
                           const float* gates, const float* dh_seq,
                           float* dx, float* dW, float* dZ, float* dc, int B,
                           int T, int E, int H, float gclip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * T, H4 = 4 * H;
  const float* Wh = W + (long long)E * H4;
  const dim3 grid((H + SJ - 1) / SJ, (B + SR - 1) / SR);
  for (int t = T - 1; t >= 0; --t) {
    bwd_step_kernel<SentiGates><<<grid, S_THREADS, 0, st>>>(
        Wh, gates, c_seq, dh_seq, dZ, dc, B, T, H, t, gclip);
    ICEE_TRY(cudaGetLastError());
  }
  // dW[:E] = x^T dZ, dW[E:] = h_prev^T dZ, dx = dZ W_x^T
  ICEE_TRY(gemm('A', x, E, dZ, H4, dW, H4, nullptr, E, H4, N, 1, 0, 0, 0, 0,
                st));
  ICEE_TRY(gemm('A', h_prev, H, dZ, H4, dW + (long long)E * H4, H4, nullptr,
                H, H4, N, 1, 0, 0, 0, 0, st));
  ICEE_TRY(gemm('T', dZ, H4, W, H4, dx, E, nullptr, N, E, H4, 1, 0, 0, 0, 0,
                st));
  return 0;
}

}  // extern "C"
