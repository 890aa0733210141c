// Float32 products and fixed-order column sums for the training kernels:
// nic_scan.cu (K4, forward and backward), chunked_ce.cu (the chunked
// cross-entropy's bias gradient), lstm_scan.cu (K3's bias grads: the column
// sums only) and att_scan.cu (the CUDA-core yardstick of the tensor-core
// products' error).
//
// gemm_kernel: C(m, n) = sum_k A(m, k) B(k, n) [+ bias(n)],
// batched over blockIdx.z with a stride per operand.  The operands are read
// through element strides, and the three forms the scan needs are template
// instances that say which dimension is contiguous:
//   NN  A (M, K) rows, B (K, N) rows;
//   NT  A (M, K) rows, B (N, K) rows   (C = A B^T);
//   TN  A (K, M) rows, B (K, N) rows   (C = A^T B).
// Tiles of 64 x 64 outputs, 16 deep, are staged in shared memory; each of
// 256 threads keeps a 4 x 4 register tile and reads its A and B quads as
// float4 from shared memory.  Global loads are float4 along the contiguous
// dimension where the host says the operand is 16-byte aligned and the quad
// lies inside the matrix, and scalar otherwise (ragged edges, E % 4 != 0).
// Every output is one sequential fmaf chain in k order, then + bias: no
// split over k and no atomics, so a product gives the same bits
// on every run.  The library is built with -fmad=false, so the compiler
// contracts nothing else.
//
// What bounds it on the H100: float32 operations on the CUDA cores (67
// TFLOP/s at 700 W).  The 4 x 4 register tile does 16 FMAs for every 8
// floats read from shared memory.  K3, K5, K8, K9 and K10 moved their
// products to the tensor cores at float32 accuracy (gemm_tf32x3.cuh,
// planes_product.cuh); K4 is next.
//
// colsum_kernel: out(c) [+]= sum_r X(r, c), each column summed by 8 fixed
// row groups then added in group order: no atomics, same bits every run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace icee {

constexpr int GM = 64, GN = 64, GK = 16, G_THREADS = 256;

struct GemmArgs {
  const float* A;       // A(m, k) = A[m * sam + k * sak]
  const float* B;       // B(k, n) = B[k * sbk + n * sbn]
  float* C;             // C(m, n) = C[m * ldc + n]
  const float* bias;    // (N,) or null
  long long sam, sak, sbk, sbn, ldc;
  long long za, zb, zc, zbias;  // per-batch offsets (blockIdx.z)
  int M, N, K;
  int vec_a, vec_b;     // 1: float4 loads along the contiguous dimension
};

// A_KC: A is contiguous along k (NN, NT), else along m (TN).
// B_NC: B is contiguous along n (NN, TN), else along k (NT).
template <bool A_KC, bool B_NC>
__global__ void __launch_bounds__(G_THREADS) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[GK][GM + 4];
  __shared__ __align__(16) float Bs[GK][GN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const float* A = g.A + blockIdx.z * g.za;
  const float* B = g.B + blockIdx.z * g.zb;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += GK) {
    // A tile -> As[k][m]
    if (A_KC) {
      const int m = tid / 4, kk = (tid % 4) * 4;
      const int gm = m0 + m, gk = k0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gm < g.M) {
        const float* p = A + gm * g.sam + (long long)gk;
        if (g.vec_a && gk + 3 < g.K) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gk + j < g.K) v[j] = p[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) As[kk + j][m] = v[j];
    } else {
      const int kk = tid / 16, m = (tid % 16) * 4;
      const int gm = m0 + m, gk = k0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gk < g.K) {
        const float* p = A + gk * g.sak + (long long)gm;
        if (g.vec_a && gm + 3 < g.M) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gm + j < g.M) v[j] = p[j];
        }
      }
      *reinterpret_cast<float4*>(&As[kk][m]) = make_float4(v[0], v[1], v[2], v[3]);
    }
    // B tile -> Bs[k][n]
    if (B_NC) {
      const int kk = tid / 16, n = (tid % 16) * 4;
      const int gn = n0 + n, gk = k0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gk < g.K) {
        const float* p = B + gk * g.sbk + (long long)gn;
        if (g.vec_b && gn + 3 < g.N) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < g.N) v[j] = p[j];
        }
      }
      *reinterpret_cast<float4*>(&Bs[kk][n]) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const int n = tid / 4, kk = (tid % 4) * 4;
      const int gn = n0 + n, gk = k0 + kk;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gn < g.N) {
        const float* p = B + gn * g.sbn + (long long)gk;
        if (g.vec_b && gk + 3 < g.K) {
          const float4 q = *reinterpret_cast<const float4*>(p);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gk + j < g.K) v[j] = p[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[kk + j][n] = v[j];
    }
    __syncthreads();
    const int kmax = min(GK, g.K - k0);
    for (int k = 0; k < kmax; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* C = g.C + blockIdx.z * g.zc;
  const float* bias = g.bias ? g.bias + blockIdx.z * g.zbias : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      float v = acc[i][j];
      if (bias) v = v + bias[n];
      C[m * g.ldc + n] = v;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Forms: 'N' (NN), 'T' (NT: B given as (N, K) rows), 'A' (TN: A given as
// (K, M) rows).  lda / ldb / ldc are row strides in floats of the matrices
// as stored; batch offsets za.. in floats.  Returns the launch error.
inline cudaError_t gemm(char form, const float* A, long long lda,
                        const float* B, long long ldb, float* C,
                        long long ldc, const float* bias, int M, int N,
                        int K, int batch, long long za, long long zb,
                        long long zc, long long zbias, cudaStream_t st) {
  GemmArgs g;
  g.A = A; g.B = B; g.C = C; g.bias = bias; g.ldc = ldc;
  g.za = za; g.zb = zb; g.zc = zc; g.zbias = zbias;
  g.M = M; g.N = N; g.K = K;
  if (form == 'A') {  // A stored (K, M)
    g.sam = 1; g.sak = lda;
  } else {
    g.sam = lda; g.sak = 1;
  }
  if (form == 'T') {  // B stored (N, K)
    g.sbk = 1; g.sbn = ldb;
  } else {
    g.sbk = ldb; g.sbn = 1;
  }
  g.vec_a = aligned16(A) && lda % 4 == 0 && za % 4 == 0;
  g.vec_b = aligned16(B) && ldb % 4 == 0 && zb % 4 == 0;
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, batch);
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (form == 'N')
    gemm_kernel<true, true><<<grid, G_THREADS, 0, st>>>(g);
  else if (form == 'T')
    gemm_kernel<true, false><<<grid, G_THREADS, 0, st>>>(g);
  else
    gemm_kernel<false, true><<<grid, G_THREADS, 0, st>>>(g);
  return cudaGetLastError();
}

constexpr int CS_COLS = 32, CS_GROUPS = 8;

// out(c) = [out(c) +] sum_r X[r * ldx + c] for c < C, r < R.
__global__ void __launch_bounds__(CS_COLS * CS_GROUPS)
colsum_kernel(const float* __restrict__ X, long long ldx, int R, int C,
              float* out, int accumulate) {
  __shared__ float part[CS_GROUPS][CS_COLS];
  const int lc = threadIdx.x % CS_COLS, grp = threadIdx.x / CS_COLS;
  const int c = blockIdx.x * CS_COLS + lc;
  float s = 0.f;
  if (c < C)
    for (int r = grp; r < R; r += CS_GROUPS) s += X[r * ldx + c];
  part[grp][lc] = s;
  __syncthreads();
  if (grp == 0 && c < C) {
    float t = part[0][lc];
#pragma unroll
    for (int q = 1; q < CS_GROUPS; ++q) t += part[q][lc];
    out[c] = accumulate ? out[c] + t : t;
  }
}

inline cudaError_t colsum(const float* X, long long ldx, int R, int C,
                          float* out, int accumulate, cudaStream_t st) {
  if (C <= 0) return cudaSuccess;
  colsum_kernel<<<(C + CS_COLS - 1) / CS_COLS, CS_COLS * CS_GROUPS, 0, st>>>(
      X, ldx, R, C, out, accumulate);
  return cudaGetLastError();
}

}  // namespace icee
