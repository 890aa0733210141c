// The per-step kernels of the two teacher-forced training scans:
// lstm_scan.cu (K3, the FactoredLSTM) and nic_scan.cu (K4, the torch-order
// LSTM).  Both scans keep the same structure: the input side of every step
// is one product over all B * T rows before the recurrence, so a step is
//   forward:  z = (input side)_t  (+)  h_{t-1} W + b, then the gates;
//   backward: dh_carry = dZ_{t+1} W^T, then the gate derivatives -> dZ_t,
// with W (H, 4H).  The products are the same for both cells; what differs
// (gate order, where the biases are added, h = o * c or o * tanh(c)) is a
// Gates policy with two static device functions:
//   forward(z, b, acc, H, j, c_prev, &c_new, &h_new): z points at the row's
//     4H input-side values; acc[g] = (h_{t-1} W)[g H + j]; overwrites
//     z[g H + j] with the gate activations the backward reads;
//   backward(gates, dz, H, j, c_new, c_prev, dh_total, dc_in) -> dc carried
//     to step t - 1; writes dz[g H + j].
//
// Each step block owns SJ = 8 hidden units (all four gate columns of each)
// for SR = 32 batch rows, so the recurrence reads W once per block per step.
// The step products are latency-bound (a few hundred FMAs per thread between
// L2 reads), so they stage k tiles of SK = 128 as float4 and each thread
// loads its share of the next tile while the block computes on the current
// one.  Every sum is a fixed sequential fmaf chain (the libraries are built
// with -fmad=false): a step gives the same bits on every run.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Return the CUDA error of `expr` from the enclosing C entry point.
#define ICEE_TRY(expr)                     \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

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

// Step t: zg rows (b, t) hold the input side on entry and the gates on
// exit; h_seq / c_seq (B, T, H) get h_t, c_t.  h_{t-1}, c_{t-1} are read
// from the same sequences (zero at t = 0).  The product h_{t-1} W runs over
// k tiles of SK, each thread holding its share of the next tile in
// registers while the block computes on the current one.
template <class Gates>
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
    const float c_prev = t > 0 ? c_seq[(row - 1) * H + j] : 0.f;
    float c_new, h_new;
    Gates::forward(zg + row * 4 * H, Wb, acc, H, j, c_prev, c_new, h_new);
    c_seq[row * H + j] = c_new;
    h_seq[row * H + j] = h_new;
  }
}

// Reverse step s: dh_carry = dz_{s+1} W^T (zero at s = T - 1), then the
// gate derivatives; writes dZ rows (b, s) and the carried dc.  dc_carry
// (B, H) is read and written by its owning thread.  Rows of dZ and W are 4H
// long, so every quad is a float4.
template <class Gates>
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
    const float c_new = c_seq[row * H + j];
    const float c_prev = s > 0 ? c_seq[(row - 1) * H + j] : 0.f;
    const float dc_in = s < T - 1 ? dc_carry[(long long)b * H + j] : 0.f;
    const float dh_total = dh_seq[row * H + j] + acc;
    dc_carry[(long long)b * H + j] = Gates::backward(
        gates + row * H4, dZ + row * H4, H, j, c_new, c_prev, dh_total, dc_in);
  }
}

}  // namespace icee
