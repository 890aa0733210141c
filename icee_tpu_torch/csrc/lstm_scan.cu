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
//     gates, each block owning 8 hidden units (all four gate columns) for
//     32 rows, so the recurrence reads W once per block per step;
//   backward (c): one launch per reverse step, dh_carry = dz_{s+1} W^T and
//     the gate derivatives, writing dZ (N, 4H) from the saved gates.
//     The step products are latency-bound (a few hundred FMAs per thread
//     between L2 reads), so they stage k tiles of 128 as float4 and each
//     thread loads its share of the next tile while the block computes;
//   backward (d): every weight grad and dx as large products over N, and
//     the bias grads as fixed-order column sums.
// The forward saves v, s and the gate activations, so the backward
// recomputes nothing.  Every sum runs in a fixed order with no atomics: a
// step gives the same bits on every run.  CUDA-core fmaf only (no TF32), so
// the port holds the JAX package's float32 numerics.
#include "gemm_f32.cuh"

#include <math.h>

namespace icee {

constexpr int SJ = 8;     // hidden units per step block
constexpr int SR = 32;    // batch rows per step block
constexpr int SK = 128;   // k tile of the step products
constexpr int SKP = SK + 1;
constexpr int S_THREADS = SJ * SR;
constexpr int SQ = SK / 4;  // float4 quads per tile row

__device__ __forceinline__ float sigm(float z) { return 1.f / (1.f + expf(-z)); }

// Quad q of row `row` (k = k0 + 4 q) of a row-major matrix with K columns:
// a float4 where `vec` (K % 4 == 0, aligned rows), else scalars; zeros
// outside the matrix.
__device__ __forceinline__ float4 load_quad(const float* __restrict__ rowp,
                                            bool row_ok, int k, int K,
                                            bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!row_ok || k >= K) return v;
  if (vec) return *reinterpret_cast<const float4*>(rowp + k);
  v.x = rowp[k];
  if (k + 1 < K) v.y = rowp[k + 1];
  if (k + 2 < K) v.z = rowp[k + 2];
  if (k + 3 < K) v.w = rowp[k + 3];
  return v;
}

__device__ __forceinline__ void put4(float* dst, float4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Step t: zg rows (b, t) hold u on entry and the gates [i, f, o, g] on exit;
// h_seq / c_seq (B, T, H) get h_t, c_t.  h_{t-1}, c_{t-1} are read from the
// same sequences (zero at t = 0).  The product h_{t-1} W_w runs over k
// tiles of SK, each thread holding its share of the next tile in registers
// while the block computes on the current one.
__global__ void __launch_bounds__(S_THREADS)
fwd_step_kernel(const float* __restrict__ Ww, const float* __restrict__ Wb,
                float* zg, float* h_seq, float* c_seq, int B, int T, int H,
                int t, int vec) {
  __shared__ float hs[SR][SKP];
  __shared__ float ws[SK][4 * SJ];
  const int tid = threadIdx.x, r = tid / SJ, jj = tid % SJ;
  const int b0 = blockIdx.y * SR, j0 = blockIdx.x * SJ;
  const int b = b0 + r, j = j0 + jj;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (t > 0) {
    float4 rh[4], rw[4];
    // 4 quads of the h tile (SR x SK) and 4 of the W tile (SK x 4 gates x
    // SJ units, two quads per gate) per thread
    auto load = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tid + q * S_THREADS;
        const int rr = i / SQ, kq = i % SQ, bb = b0 + rr;
        rh[q] = load_quad(h_seq + ((long long)bb * T + t - 1) * H, bb < B,
                          k0 + 4 * kq, H, vec);
        const int kk = i / (2 * 4), c = i % (2 * 4);
        const int g = c / 2, jq = j0 + 4 * (c % 2), k = k0 + kk;
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < H) {
          const float* wp = Ww + (long long)k * 4 * H + g * H;
          if (vec) {
            if (jq < H) w = *reinterpret_cast<const float4*>(wp + jq);
          } else {
            if (jq < H) w.x = wp[jq];
            if (jq + 1 < H) w.y = wp[jq + 1];
            if (jq + 2 < H) w.z = wp[jq + 2];
            if (jq + 3 < H) w.w = wp[jq + 3];
          }
        }
        rw[q] = w;
      }
    };
    load(0);
    for (int k0 = 0; k0 < H; k0 += SK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tid + q * S_THREADS;
        put4(&hs[i / SQ][4 * (i % SQ)], rh[q]);
        const int kk = i / 8, c = i % 8;
        put4(&ws[kk][(c / 2) * SJ + 4 * (c % 2)], rw[q]);
      }
      __syncthreads();
      if (k0 + SK < H) load(k0 + SK);
      const int kmax = min(SK, H - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float a = hs[r][kk];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = fmaf(a, ws[kk][g * SJ + jj], acc[g]);
      }
      __syncthreads();
    }
  }
  if (b < B && j < H) {
    const long long row = (long long)b * T + t;
    float* z = zg + row * 4 * H;
    float zz[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) zz[g] = z[g * H + j] + (acc[g] + Wb[g * H + j]);
    const float i_t = sigm(zz[0]), f_t = sigm(zz[1]);
    const float o_t = sigm(zz[2]), g_t = tanhf(zz[3]);
    const float c_prev = t > 0 ? c_seq[(row - 1) * H + j] : 0.f;
    const float c_new = f_t * c_prev + i_t * g_t;
    z[j] = i_t;
    z[H + j] = f_t;
    z[2 * H + j] = o_t;
    z[3 * H + j] = g_t;
    c_seq[row * H + j] = c_new;
    h_seq[row * H + j] = o_t * c_new;  // no tanh: reference quirk
  }
}

// Reverse step s: dh_carry = dz_{s+1} W_w^T (zero at s = T - 1), then the
// gate derivatives of _bwd_kernel :132-144; writes dZ rows (b, s) and the
// carried dc.  dc_carry (B, H) is read and written by its owning thread.
// Rows of dZ and W_w are 4H long, so every quad is a float4.
__global__ void __launch_bounds__(S_THREADS)
bwd_step_kernel(const float* __restrict__ Ww, const float* __restrict__ gates,
                const float* __restrict__ c_seq,
                const float* __restrict__ dh_seq, float* dZ, float* dc_carry,
                int B, int T, int H, int s) {
  __shared__ float ds[SR][SKP];
  __shared__ float ws[SJ][SKP];
  const int tid = threadIdx.x, r = tid / SJ, jj = tid % SJ;
  const int b0 = blockIdx.y * SR, j0 = blockIdx.x * SJ;
  const int b = b0 + r, j = j0 + jj;
  const int H4 = 4 * H;
  float acc = 0.f;
  if (s < T - 1) {
    float4 rd[4], rw;
    auto load = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tid + q * S_THREADS;
        const int rr = i / SQ, kq = i % SQ, bb = b0 + rr;
        rd[q] = load_quad(dZ + ((long long)bb * T + s + 1) * H4, bb < B,
                          k0 + 4 * kq, H4, true);
      }
      const int rr = tid / SQ, kq = tid % SQ, jq = j0 + rr;
      rw = load_quad(Ww + (long long)jq * H4, jq < H, k0 + 4 * kq, H4, true);
    };
    load(0);
    for (int k0 = 0; k0 < H4; k0 += SK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tid + q * S_THREADS;
        put4(&ds[i / SQ][4 * (i % SQ)], rd[q]);
      }
      put4(&ws[tid / SQ][4 * (tid % SQ)], rw);
      __syncthreads();
      if (k0 + SK < H4) load(k0 + SK);
      const int kmax = min(SK, H4 - k0);
      for (int kk = 0; kk < kmax; ++kk) acc = fmaf(ds[r][kk], ws[jj][kk], acc);
      __syncthreads();
    }
  }
  if (b < B && j < H) {
    const long long row = (long long)b * T + s;
    const float* gt = gates + row * H4;
    const float i_t = gt[j], f_t = gt[H + j], o_t = gt[2 * H + j];
    const float g_t = gt[3 * H + j];
    const float c_new = c_seq[row * H + j];
    const float c_prev = s > 0 ? c_seq[(row - 1) * H + j] : 0.f;
    const float dc_in = s < T - 1 ? dc_carry[(long long)b * H + j] : 0.f;
    const float dh_total = dh_seq[row * H + j] + acc;
    const float d_o = dh_total * c_new;
    const float dc_new = dh_total * o_t + dc_in;
    const float d_f = dc_new * c_prev;
    const float d_i = dc_new * g_t;
    const float d_g = dc_new * i_t;
    dc_carry[(long long)b * H + j] = dc_new * f_t;
    float* dz = dZ + row * H4;
    dz[j] = d_i * i_t * (1.f - i_t);
    dz[H + j] = d_f * f_t * (1.f - f_t);
    dz[2 * H + j] = d_o * o_t * (1.f - o_t);
    dz[3 * H + j] = d_g * (1.f - g_t * g_t);
  }
}

}  // namespace icee

using namespace icee;

#define ICEE_TRY(expr)                   \
  do {                                   \
    const cudaError_t e_ = (expr);       \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

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
    fwd_step_kernel<<<grid, S_THREADS, 0, st>>>(Ww, Wb, gates, h_seq, c_seq,
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
    bwd_step_kernel<<<grid, S_THREADS, 0, st>>>(Ww, gates, c_seq, dh_seq, dZ,
                                                dc, B, T, H, t);
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
