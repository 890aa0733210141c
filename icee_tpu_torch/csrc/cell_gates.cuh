// The gate policies of the training scans: K3 (lstm_scan.cu, the
// FactoredLSTM), K4 (nic_scan.cu, the torch-order LSTM), K5 (att_scan.cu,
// the attention decoders, whose cells are these two) and K8
// (senticap_scan.cu, the SentiCap mRNN).  Each is the Gates interface of
// scan_grid.cuh's recurrence (K5 calls the same functions from its own
// step loop):
//   forward(z, b, acc, H, j, c_prev, &c_new, &h_new): z points at the row's
//     4H input-side values, acc[g] = (h_{t-1} W)[g H + j]; overwrites
//     z[g H + j] with the gate activations the backward reads;
//   backward(gates, dz, H, j, c_new, c_prev, dh_total, dc_in) -> dc carried
//     to step t - 1; writes dz[g H + j];
//   kClipCarry: whether the recurrent dh is clamped to [-gclip, gclip]
//     before it joins the next reverse step.
// scan_grid.cuh's backward gate pass hands both functions its shared
// memory tiles with a stride in place of H (H = per, j = the element), and
// dz aliases gates there: a policy reads every gate before it writes dz.
#pragma once

#include "scan_step.cuh"   // sigm, ICEE_TRY

namespace icee {

// The factored cell's gates, [i, f, o, c]; z = u + (h W_w + W_b); h = o * c
// with no tanh (reference quirk).  The formulas of pallas_lstm.py's
// _fwd_kernel and _bwd_kernel :132-144.
struct FactoredGates {
  static constexpr bool kClipCarry = false;

  static __device__ __forceinline__ void forward(float* z, const float* Wb,
                                                 const float (&acc)[4], int H,
                                                 int j, float c_prev,
                                                 float& c_new, float& h_new) {
    float zz[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) zz[g] = z[g * H + j] + (acc[g] + Wb[g * H + j]);
    gates_ifoc(zz, z, H, j, c_prev, c_new, h_new);
  }

  // [i, f, o, c] gates from the pre-activations zz; saves the activations
  // into z; c' = f c + i g, h' = o c'.
  static __device__ __forceinline__ void gates_ifoc(const float (&zz)[4],
                                                    float* z, int H, int j,
                                                    float c_prev,
                                                    float& c_new,
                                                    float& h_new) {
    const float i_t = sigm(zz[0]), f_t = sigm(zz[1]);
    const float o_t = sigm(zz[2]), g_t = tanhf(zz[3]);
    c_new = f_t * c_prev + i_t * g_t;
    z[j] = i_t;
    z[H + j] = f_t;
    z[2 * H + j] = o_t;
    z[3 * H + j] = g_t;
    h_new = o_t * c_new;  // no tanh: reference quirk
  }

  static __device__ __forceinline__ float backward(const float* gt, float* dz,
                                                   int H, int j, float c_new,
                                                   float c_prev,
                                                   float dh_total,
                                                   float dc_in) {
    const float i_t = gt[j], f_t = gt[H + j], o_t = gt[2 * H + j];
    const float g_t = gt[3 * H + j];
    const float d_o = dh_total * c_new;
    const float dc_new = dh_total * o_t + dc_in;
    const float d_f = dc_new * c_prev;
    const float d_i = dc_new * g_t;
    const float d_g = dc_new * i_t;
    dz[j] = d_i * i_t * (1.f - i_t);
    dz[H + j] = d_f * f_t * (1.f - f_t);
    dz[2 * H + j] = d_o * o_t * (1.f - o_t);
    dz[3 * H + j] = d_g * (1.f - g_t * g_t);
    return dc_new * f_t;
  }
};

// The SentiCap mRNN's gates (mrnn.py:404-440): the factored cell's [i, f,
// o, c] with h = o * c, but z = [x; h] @ w_lstm with no bias (the input
// side x W_x comes in z, acc is h W_h), and the recurrent dh clamped to
// +-gclip in the backward (GradClip on h).  The formulas of
// pallas_senticap_train.py's _gates :44-56, _fwd_kernel :69-73 and
// _bwd_kernel :108-137.
struct SentiGates : FactoredGates {
  static constexpr bool kClipCarry = true;

  static __device__ __forceinline__ void forward(float* z, const float*,
                                                 const float (&acc)[4], int H,
                                                 int j, float c_prev,
                                                 float& c_new, float& h_new) {
    float zz[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) zz[g] = z[g * H + j] + acc[g];
    gates_ifoc(zz, z, H, j, c_prev, c_new, h_new);
  }
};

// torch's LSTMCell gates, [i, f, g, o]; h = o * tanh(c).  The formulas of
// pallas_nic_train.py's _gates :49-60, _fwd_kernel :75-76 and _bwd_kernel
// :111-125.
struct NicGates {
  static constexpr bool kClipCarry = false;

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
