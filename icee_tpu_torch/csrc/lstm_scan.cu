// K3: the teacher-forced FactoredLSTM training scan, forward and backward.
//
// Replaces icee_tpu/ops/pallas_lstm.py::fused_factored_scan (a custom_vjp
// around the Pallas kernels _fwd_kernel :66 and _bwd_kernel :91): T steps of
// the factored cell from zero state, h = o * c with no tanh, gate order
// [i, f, o, c]; the backward returns dx and the grads of V_w, V_b, the S
// style slice, its bias, U_w, U_b, W_w and W_b.
//
// What bounds it on the H100: float32 operations.  At the flagship shapes
// (N = B * T = 64 * 25 = 1600 rows, E = 300, F = H = 512) the forward is
// 2 N (E 4F + 4F F + 4F H + H 4H) = 12.0 GFLOP and the backward twice that,
// against ~15 MB of weights and ~50 MB of activations: far above the card's
// operations-per-byte line.  The TPU kernel kept every weight resident in
// VMEM for all T steps; 228 KB of shared memory per SM cannot.  What the
// design does about it: only the W branch is recurrent, so
//   forward (a): v = x V + V_b, s_g = v_g S_g + S_b, u_g = s_g U_g + U_b for
//     all N rows at once, as large tiled products (gemm_f32.cuh);
//   forward (b): one launch per step, z = u_t + (h_{t-1} W + W_b) and the
//     gates (scan_step.cuh, shared with K4), each block owning 8 hidden
//     units (all four gate columns) for 32 rows, so the recurrence reads W
//     once per block per step;
//   backward (c): one launch per reverse step, dh_carry = dz_{s+1} W^T and
//     the gate derivatives, writing dZ (N, 4H) from the saved gates
//     (k tiles of 128 as float4, the next tile prefetched);
//   backward (d): every weight grad and dx as large products over N, and
//     the bias grads as fixed-order column sums.
// The forward saves v, s and the gate activations, so the backward
// recomputes nothing.  Every sum runs in a fixed order with no atomics: a
// step gives the same bits on every run.  CUDA-core fmaf only (no TF32), so
// the port holds the JAX package's float32 numerics.
#include "gemm_f32.cuh"
#include "cell_gates.cuh"

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, T, E); weights in the JAX layout with S_w / S_b the style slice
// (4, F, F) / (4, F).  Outputs h_seq, c_seq (B, T, H); saved for the
// backward: v, s (N, 4F) and gates (N, 4H) = [i, f, o, g] activations.
int icee_lstm_scan_fwd(const float* x, const float* Vw, const float* Vb,
                       const float* Sw, const float* Sb, const float* Uw,
                       const float* Ub, const float* Ww, const float* Wb,
                       float* h_seq, float* c_seq, float* v, float* s,
                       float* gates, int B, int T, int E, int F, int H,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * T, F4 = 4 * F, H4 = 4 * H;
  // v = x V_w + V_b
  ICEE_TRY(gemm('N', x, E, Vw, F4, v, F4, Vb, N, F4, E, 1, 0, 0, 0, 0, st));
  // s_g = v_g S_g + S_b[g]
  ICEE_TRY(gemm('N', v, F4, Sw, F, s, F4, Sb, N, F, F, 4, F,
                (long long)F * F, F, F, st));
  // u_g = s_g U_g + U_b[g], parked in gates until each step overwrites it
  ICEE_TRY(gemm('N', s, F4, Uw, H, gates, H4, Ub, N, H, F, 4, F,
                (long long)F * H, H, H, st));
  const dim3 grid((H + SJ - 1) / SJ, (B + SR - 1) / SR);
  const int vec = H % 4 == 0 && aligned16(h_seq) && aligned16(Ww);
  for (int t = 0; t < T; ++t) {
    fwd_step_kernel<FactoredGates><<<grid, S_THREADS, 0, st>>>(Ww, Wb, gates, h_seq, c_seq,
                                                B, T, H, t, vec);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

// From the forward's saved tensors and dh_seq (B, T, H): dx (N, E) and the
// grads dVw (E, 4F), dVb (4F), dSw (4, F, F), dSb (4F), dUw (4, F, H), dUb
// (4H), dWw (H, 4H), dWb (4H).  h_prev (N, H) is h_seq shifted one step
// (zero at t = 0).  Scratch: dZ (N, 4H), dS (N, 4F), dv (N, 4F), dc (B, H).
int icee_lstm_scan_bwd(const float* x, const float* Vw, const float* Sw,
                       const float* Uw, const float* Ww, const float* h_prev,
                       const float* c_seq, const float* v, const float* s,
                       const float* gates, const float* dh_seq, float* dx,
                       float* dVw, float* dVb, float* dSw, float* dSb,
                       float* dUw, float* dUb, float* dWw, float* dWb,
                       float* dZ, float* dS, float* dv, float* dc, int B,
                       int T, int E, int F, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * T, F4 = 4 * F, H4 = 4 * H;
  const dim3 grid((H + SJ - 1) / SJ, (B + SR - 1) / SR);
  for (int t = T - 1; t >= 0; --t) {
    bwd_step_kernel<FactoredGates><<<grid, S_THREADS, 0, st>>>(Ww, gates, c_seq, dh_seq, dZ,
                                                dc, B, T, H, t, 0.f);
    ICEE_TRY(cudaGetLastError());
  }
  // W branch: dW_w = h_prev^T dZ, dW_b = sum dZ; U branch: dU_b is the
  // same sum
  ICEE_TRY(gemm('A', h_prev, H, dZ, H4, dWw, H4, nullptr, H, H4, N, 1, 0, 0,
                0, 0, st));
  ICEE_TRY(colsum(dZ, H4, N, H4, dWb, 0, st));
  ICEE_TRY(cudaMemcpyAsync(dUb, dWb, sizeof(float) * H4,
                           cudaMemcpyDeviceToDevice, st));
  // dU_g = s_g^T dz_g
  ICEE_TRY(gemm('A', s, F4, dZ, H4, dUw, H, nullptr, F, H, N, 4, F, H,
                (long long)F * H, 0, st));
  // ds_g = dz_g U_g^T
  ICEE_TRY(gemm('T', dZ, H4, Uw, H, dS, F4, nullptr, N, F, H, 4, H,
                (long long)F * H, F, 0, st));
  // dS_g = v_g^T ds_g, dS_b = sum ds
  ICEE_TRY(gemm('A', v, F4, dS, F4, dSw, F, nullptr, F, F, N, 4, F, F,
                (long long)F * F, 0, st));
  ICEE_TRY(colsum(dS, F4, N, F4, dSb, 0, st));
  // dv_g = ds_g S_g^T
  ICEE_TRY(gemm('T', dS, F4, Sw, F, dv, F4, nullptr, N, F, F, 4, F,
                (long long)F * F, F, 0, st));
  // V branch: dV_w = x^T dv, dV_b = sum dv, dx = dv V_w^T
  ICEE_TRY(gemm('A', x, E, dv, F4, dVw, F4, nullptr, E, F4, N, 1, 0, 0, 0, 0,
                st));
  ICEE_TRY(colsum(dv, F4, N, F4, dVb, 0, st));
  ICEE_TRY(gemm('T', dv, F4, Vw, F4, dx, E, nullptr, N, E, F4, 1, 0, 0, 0, 0,
                st));
  return 0;
}

}  // extern "C"
