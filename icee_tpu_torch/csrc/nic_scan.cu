// K4: the teacher-forced NIC (torch-order LSTM) training scan, forward and
// backward.
//
// Replaces icee_tpu/ops/pallas_nic_train.py::fused_nic_scan (a custom_vjp
// around the Pallas kernels _fwd_kernel :63 and _bwd_kernel :83): T steps
// of torch's nn.LSTMCell from zero state, gate order [i, f, g, o],
// z = ((x W_ih + b_ih) + h W_hh) + b_hh (the XLA cell's float order),
// c = f c + i g, h = o tanh(c); the backward returns dx, dW_ih, dW_hh and
// one db that b_ih and b_hh share.
//
// What bounds it on the H100: float32 operations.  At the flagship shapes
// (N = B * T = 64 * 25 = 1600 rows, E = 300, H = 512) the forward is
// 2 N (E + H) 4H = 5.3 GFLOP and the backward about twice that, against
// ~5 MB of weights and ~20 MB of activations: far above the card's
// operations-per-byte line.  The TPU kernel kept W_ih and W_hh resident in
// VMEM for all T steps and accumulated dW in VMEM across a sequential grid;
// an SM has 228 KB and its blocks run in no order.  The design is K3's
// (lstm_scan.cu):
//   forward (a): P = x W_ih + b_ih for all N rows as one tiled product
//     (gemm_f32.cuh), parked in the gates buffer;
//   forward (b): one launch per step (scan_step.cuh), z = (P_t + h W_hh) +
//     b_hh and the gates, saved for the backward;
//   backward (c): one launch per reverse step for the (dh, dc) chain from
//     the saved gates, writing dZ (N, 4H), with dZ_{t+1} W_hh^T fused in;
//   backward (d): dW_ih = x^T dZ, dW_hh = H_prev^T dZ (h shifted one step,
//     zero at t = 0) and dx = dZ W_ih^T as products over all N rows, db as a
//     fixed-order column sum of dZ.
// No atomics anywhere: a step gives the same bits on every run.  CUDA-core
// fmaf only (no TF32), so the port holds the JAX package's float32 numerics.
#include "gemm_f32.cuh"
#include "scan_step.cuh"

namespace icee {

// torch's LSTMCell gates, [i, f, g, o]; h = o * tanh(c).  The formulas of
// _gates :49-60, _fwd_kernel :75-76 and _bwd_kernel :111-125.
struct NicGates {
  static __device__ __forceinline__ void forward(float* z, const float* bhh,
                                                 const float (&acc)[4], int H,
                                                 int j, float c_prev,
                                                 float& c_new, float& h_new) {
    float zz[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) zz[g] = (z[g * H + j] + acc[g]) + bhh[g * H + j];
    const float i_t = sigm(zz[0]), f_t = sigm(zz[1]);
    const float g_t = tanhf(zz[2]), o_t = sigm(zz[3]);
    c_new = f_t * c_prev + i_t * g_t;
    z[j] = i_t;
    z[H + j] = f_t;
    z[2 * H + j] = g_t;
    z[3 * H + j] = o_t;
    h_new = o_t * tanhf(c_new);
  }

  static __device__ __forceinline__ float backward(const float* gt, float* dz,
                                                   int H, int j, float c_new,
                                                   float c_prev,
                                                   float dh_total,
                                                   float dc_in) {
    const float i_t = gt[j], f_t = gt[H + j], g_t = gt[2 * H + j];
    const float o_t = gt[3 * H + j];
    const float tanh_c = tanhf(c_new);
    const float d_o = dh_total * tanh_c;
    const float dc_new = dh_total * o_t * (1.f - tanh_c * tanh_c) + dc_in;
    const float d_i = dc_new * g_t;
    const float d_f = dc_new * c_prev;
    const float d_g = dc_new * i_t;
    dz[j] = d_i * i_t * (1.f - i_t);
    dz[H + j] = d_f * f_t * (1.f - f_t);
    dz[2 * H + j] = d_g * (1.f - g_t * g_t);
    dz[3 * H + j] = d_o * o_t * (1.f - o_t);
    return dc_new * f_t;
  }
};

}  // namespace icee

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, T, E); W_ih (E, 4H), b_ih (4H), W_hh (H, 4H), b_hh (4H).  Outputs
// h_seq, c_seq (B, T, H); saved for the backward: gates (N, 4H) = the
// [i, f, g, o] activations.
int icee_nic_scan_fwd(const float* x, const float* Wih, const float* bih,
                      const float* Whh, const float* bhh, float* h_seq,
                      float* c_seq, float* gates, int B, int T, int E, int H,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * T, H4 = 4 * H;
  // P = x W_ih + b_ih, parked in gates until each step overwrites it
  ICEE_TRY(gemm('N', x, E, Wih, H4, gates, H4, bih, N, H4, E, 1, 0, 0, 0, 0,
                st));
  const dim3 grid((H + SJ - 1) / SJ, (B + SR - 1) / SR);
  const int vec = H % 4 == 0 && aligned16(h_seq) && aligned16(Whh);
  for (int t = 0; t < T; ++t) {
    fwd_step_kernel<NicGates><<<grid, S_THREADS, 0, st>>>(
        Whh, bhh, gates, h_seq, c_seq, B, T, H, t, vec);
    ICEE_TRY(cudaGetLastError());
  }
  return 0;
}

// From the forward's saved gates and dh_seq (B, T, H): dx (N, E), dWih
// (E, 4H), dWhh (H, 4H), db (4H).  h_prev (N, H) is h_seq shifted one step
// (zero at t = 0).  Scratch: dZ (N, 4H), dc (B, H).
int icee_nic_scan_bwd(const float* x, const float* Wih, const float* Whh,
                      const float* h_prev, const float* c_seq,
                      const float* gates, const float* dh_seq, float* dx,
                      float* dWih, float* dWhh, float* db, float* dZ,
                      float* dc, int B, int T, int E, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = B * T, H4 = 4 * H;
  const dim3 grid((H + SJ - 1) / SJ, (B + SR - 1) / SR);
  for (int t = T - 1; t >= 0; --t) {
    bwd_step_kernel<NicGates><<<grid, S_THREADS, 0, st>>>(
        Whh, gates, c_seq, dh_seq, dZ, dc, B, T, H, t);
    ICEE_TRY(cudaGetLastError());
  }
  // dW_ih = x^T dZ, dW_hh = h_prev^T dZ, db = sum dZ, dx = dZ W_ih^T
  ICEE_TRY(gemm('A', x, E, dZ, H4, dWih, H4, nullptr, E, H4, N, 1, 0, 0, 0, 0,
                st));
  ICEE_TRY(gemm('A', h_prev, H, dZ, H4, dWhh, H4, nullptr, H, H4, N, 1, 0, 0,
                0, 0, st));
  ICEE_TRY(colsum(dZ, H4, N, H4, db, 0, st));
  ICEE_TRY(gemm('T', dZ, H4, Wih, H4, dx, E, nullptr, N, E, H4, 1, 0, 0, 0, 0,
                st));
  return 0;
}

}  // extern "C"
