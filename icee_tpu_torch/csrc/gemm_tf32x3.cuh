// Float32-accurate products on the H100's tensor cores ("3xTF32") for K5
// (att_scan.cu): every per-step product of the attention training scan,
// forward and backward, and the backward's weight grads.
//
// tf32x3_gemm: C(m, n) = sum_k A(m, k) B(k, n) [+ bias(n)], batched over
// blockIdx.z with a per-operand offset, with gemm_f32.cuh's forms and row
// strides:
//   'N'  A (M, K) rows, B (K, N) rows;
//   'T'  A (M, K) rows, B (N, K) rows   (C = A B^T);
//   'A'  A (K, M) rows, B (K, N) rows   (C = A^T B).
//
// Arithmetic.  Each operand value x is split into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi); the subtraction is exact (a plain __fsub_rn,
// which -fmad=false leaves alone).  The rounding (to nearest, ties away from
// zero, 10 mantissa bits) is done on the bit pattern with integer
// operations: cvt.rna's bits, ~10% less time for the product
// (scripts/probe_tf32x3.py; the conversion is a slow instruction).  Each
// output adds lo_a hi_b, hi_a lo_b and hi_a hi_b, small terms first, with
// mma.sync m16n8k8 TF32 into float32 fragments.  The dropped lo_a lo_b and
// the rounding of lo are ~2^-22 of a term, the size of a float32 fmaf
// chain's error.  The tensor core's float32 sum is not IEEE
// round-to-nearest (it truncates), so the mmas of one 32-deep k tile (12
// per output fragment) go into a fragment zeroed for that tile, which is
// then added to the float32 accumulator with a rounded add: the truncation
// stays relative to a 32-term sum and does not grow with the running total
// over K (up to 4,608 here; adding the mmas straight into the accumulator
// measured 10-40x the error).
//
// Where the split happens: as a fragment is loaded from shared memory, in
// registers.  An A value is split by the 2 warps that share its rows and a
// B value by the 4 that share its columns, 5 instructions each; splitting as
// the tile lands would cost a second pass over shared memory, double the
// tile's footprint, and a barrier per k tile.
//
// Tiles.  A block of 8 warps computes a 128 x 64 output tile (4 x 2 warps of
// 32 x 32: 2 x 4 m16n8 fragments each), so M = B = 128 is one block row.
// k tiles of 32 stream into a 3-stage ring in shared memory by cp.async: 16
// bytes a copy where the operand's rows are 16-byte aligned, else 4, with a
// source size of 0 (zero fill) past the ragged edges of M, N and K.  Rows are
// padded so that every fragment load is free of bank conflicts: a tile
// stored k-contiguous has rows of 36 floats (banks 4 g + t for the lane's
// group g and thread t), one stored m- or n-contiguous rows of 136 / 72
// (banks 8 t + g).  82,944 bytes of shared memory a block, two blocks an SM.
//
// Filling 132 SMs at M = 128.  tc_plan, a function of the shape alone, cuts
// K into chunks (multiples of the k tile, each at least TC_MIN_DEPTH deep)
// so that tiles x chunks come near two blocks an SM (two fit, and one an SM
// leaves the mma latency exposed); a product whose tiles already put a block
// on nearly every SM splits only into chunks of TC_DEEP_CHUNK or more, where
// the extra launch and partials pay for themselves.  Each chunk's block
// writes its partial tile, and tf32x3_sum_parts_kernel adds the partials in
// chunk order (then the bias).  No atomics: the same inputs give the same
// bits on every run.
//
// What bounds it: with K5's per-step shapes (M = 128, a 0.27-1.2 GFLOP
// product) the fixed cost of a launch, its pipeline's fill and the partial
// sums, not bytes; on deep products the loop's issue (fragment loads, the
// split, 3 mmas) at ~40 TFLOP/s float32-equivalent.  mma.sync TF32 alone
// peaks at ~320 TFLOP/s on the H100 (probe), so 3xTF32 by mma.sync tops out
// near 107.  wgmma is not used: TF32 wgmma wants both operands k-contiguous
// in shared memory, and most of K5's operands are not (the 'N' and 'A'
// forms).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace icee {

constexpr int TC_BM = 128, TC_BN = 64, TC_BK = 32, TC_STAGES = 3;
constexpr int TC_THREADS = 256;      // 8 warps: 4 along m x 2 along n
constexpr int TC_SMS = 132;          // H100 SXM
constexpr int TC_MIN_DEPTH = 128;    // least k depth of one split chunk
constexpr int TC_DEEP_CHUNK = 1024;  // ... where the tiles fill a wave
constexpr int TC_LDK = TC_BK + 4;    // rows of a k-contiguous tile
constexpr int TC_LDM = TC_BM + 8;    // rows of A stored m-contiguous ('A')
constexpr int TC_LDN = TC_BN + 8;    // rows of B stored n-contiguous
constexpr int TC_A_FLOATS = TC_BM * TC_LDK;  // >= TC_BK * TC_LDM
constexpr int TC_B_FLOATS = TC_BN * TC_LDK;  // == TC_BK * TC_LDN
constexpr int TC_STAGE_FLOATS = TC_A_FLOATS + TC_B_FLOATS;
constexpr size_t TC_SMEM = sizeof(float) * TC_STAGES * TC_STAGE_FLOATS;
constexpr int TC_SUM_THREADS = 256;

static_assert(TC_A_FLOATS >= TC_BK * TC_LDM, "A stage too small");
static_assert(TC_B_FLOATS == TC_BK * TC_LDN, "B stage size");

struct Tf32x3Args {
  const float* A;       // A(m, k) = A[m * sam + k * sak]
  const float* B;       // B(k, n) = B[k * sbk + n * sbn]
  float* C;             // C(m, n) = C[m * ldc + n]
  const float* bias;    // (N,) or null
  float* part;          // splits > 1: (batch * splits, M, N) partials
  long long lda, ldb, ldc;
  long long za, zb, zc, zbias;  // per-batch offsets
  int M, N, K;
  int kc, splits;       // k chunk length and chunk count
  int vec_a, vec_b;     // 1: 16-byte copies along the contiguous dimension
};

// The split-K schedule of an (M, N, K) x batch product: the chunk count
// nearest to two blocks an SM, each chunk a multiple of TC_BK and at least
// TC_MIN_DEPTH deep (TC_DEEP_CHUNK where the tiles alone nearly fill one
// wave); one chunk of K where that is no split.
struct TcPlan {
  int splits, kc;
};

inline TcPlan tc_plan(int M, int N, int K, int batch) {
  const long long tiles = (long long)((M + TC_BM - 1) / TC_BM) *
                          ((N + TC_BN - 1) / TC_BN) * batch;
  long long ns = tiles > 0 ? (2 * TC_SMS + tiles / 2) / tiles : 1;
  const int least = tiles >= TC_SMS * 7 / 8 ? TC_DEEP_CHUNK : TC_MIN_DEPTH;
  if (ns > K / least) ns = K / least;
  if (ns <= 1) return {1, K};
  int kc = (int)((K + ns - 1) / ns);
  kc = (kc + TC_BK - 1) / TC_BK * TC_BK;
  return {(K + kc - 1) / kc, kc};
}

// Floats of partials tf32x3_gemm needs for this shape (0: no split).
inline long long tf32x3_part_floats(int M, int N, int K, int batch) {
  const TcPlan p = tc_plan(M, N, K, batch);
  return p.splits > 1 ? (long long)p.splits * batch * M * N : 0;
}

__device__ __forceinline__ unsigned tc_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes (bytes <= 16 of them read, the rest zero) or 4 bytes (bytes 0
// or 4) from global to shared memory, asynchronously.
__device__ __forceinline__ void tc_copy16(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tc_smem(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void tc_copy4(float* dst, const float* src,
                                         int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc_smem(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void tc_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void tc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 on the bit pattern: add half of the 13 dropped bits to
// the magnitude (the sign bit is apart) and clear them; a carry moves into
// the exponent as rounding up to the next binade should.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 x): both TF32, rounded to nearest, ties away.
__device__ __forceinline__ void tf32_split(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on one m16n8k8 fragment (PTX ISA, "Matrix Fragments for
// mma.m16n8k8", .tf32: with g = lane / 4 and t = lane % 4, a0..a3 hold
// A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); b0, b1 hold B(t, g),
// B(t + 4, g); d0..d3 hold C(g, 2t), C(g, 2t + 1), C(g + 8, 2t),
// C(g + 8, 2t + 1)).
__device__ __forceinline__ void tc_mma(float (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k tile [k0, k0 + TC_BK) of A and B into a stage, zero past k_end and
// past M and N.  A_KC: A contiguous along k ('N', 'T'), kept As[m][k]; else
// along m ('A'), kept As[k][m].  B_NC: B contiguous along n ('N', 'A'), kept
// Bs[k][n]; else along k ('T'), kept Bs[n][k].
template <bool A_KC, bool B_NC>
__device__ __forceinline__ void tc_load(const Tf32x3Args& g, const float* A,
                                        const float* B, float* As, float* Bs,
                                        int m0, int n0, int k0, int k_end) {
  const int tid = threadIdx.x;
  if (A_KC) {
    if (g.vec_a) {
      for (int i = tid; i < TC_BM * TC_BK / 4; i += TC_THREADS) {
        const int m = i / (TC_BK / 4), k = (i % (TC_BK / 4)) * 4;
        const int gm = m0 + m, gk = k0 + k;
        const bool in = gm < g.M && gk < k_end;
        tc_copy16(As + m * TC_LDK + k,
                  in ? A + gm * g.lda + gk : A,
                  in ? 4 * min(4, k_end - gk) : 0);
      }
    } else {
      for (int i = tid; i < TC_BM * TC_BK; i += TC_THREADS) {
        const int m = i / TC_BK, k = i % TC_BK;
        const int gm = m0 + m, gk = k0 + k;
        const bool in = gm < g.M && gk < k_end;
        tc_copy4(As + m * TC_LDK + k, in ? A + gm * g.lda + gk : A,
                 in ? 4 : 0);
      }
    }
  } else {
    if (g.vec_a) {
      for (int i = tid; i < TC_BK * TC_BM / 4; i += TC_THREADS) {
        const int k = i / (TC_BM / 4), m = (i % (TC_BM / 4)) * 4;
        const int gm = m0 + m, gk = k0 + k;
        const bool in = gm < g.M && gk < k_end;
        tc_copy16(As + k * TC_LDM + m,
                  in ? A + gk * g.lda + gm : A,
                  in ? 4 * min(4, g.M - gm) : 0);
      }
    } else {
      for (int i = tid; i < TC_BK * TC_BM; i += TC_THREADS) {
        const int k = i / TC_BM, m = i % TC_BM;
        const int gm = m0 + m, gk = k0 + k;
        const bool in = gm < g.M && gk < k_end;
        tc_copy4(As + k * TC_LDM + m, in ? A + gk * g.lda + gm : A,
                 in ? 4 : 0);
      }
    }
  }
  if (B_NC) {
    if (g.vec_b) {
      for (int i = tid; i < TC_BK * TC_BN / 4; i += TC_THREADS) {
        const int k = i / (TC_BN / 4), n = (i % (TC_BN / 4)) * 4;
        const int gn = n0 + n, gk = k0 + k;
        const bool in = gn < g.N && gk < k_end;
        tc_copy16(Bs + k * TC_LDN + n,
                  in ? B + gk * g.ldb + gn : B,
                  in ? 4 * min(4, g.N - gn) : 0);
      }
    } else {
      for (int i = tid; i < TC_BK * TC_BN; i += TC_THREADS) {
        const int k = i / TC_BN, n = i % TC_BN;
        const int gn = n0 + n, gk = k0 + k;
        const bool in = gn < g.N && gk < k_end;
        tc_copy4(Bs + k * TC_LDN + n, in ? B + gk * g.ldb + gn : B,
                 in ? 4 : 0);
      }
    }
  } else {
    if (g.vec_b) {
      for (int i = tid; i < TC_BN * TC_BK / 4; i += TC_THREADS) {
        const int n = i / (TC_BK / 4), k = (i % (TC_BK / 4)) * 4;
        const int gn = n0 + n, gk = k0 + k;
        const bool in = gn < g.N && gk < k_end;
        tc_copy16(Bs + n * TC_LDK + k,
                  in ? B + gn * g.ldb + gk : B,
                  in ? 4 * min(4, k_end - gk) : 0);
      }
    } else {
      for (int i = tid; i < TC_BN * TC_BK; i += TC_THREADS) {
        const int n = i / TC_BK, k = i % TC_BK;
        const int gn = n0 + n, gk = k0 + k;
        const bool in = gn < g.N && gk < k_end;
        tc_copy4(Bs + n * TC_LDK + k, in ? B + gn * g.ldb + gk : B,
                 in ? 4 : 0);
      }
    }
  }
}

// The warp's 32 x 32 share of one k tile: 4 k8 steps of 2 x 4 fragments,
// 3 mmas each, into t; then acc += t, rounded.
template <bool A_KC, bool B_NC>
__device__ __forceinline__ void tc_tile(const float* As, const float* Bs,
                                        int wm, int wn, int gr, int tq,
                                        float (&acc)[2][4][4]) {
  float t[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) t[i][j][q] = 0.f;
#pragma unroll
  for (int kk = 0; kk < TC_BK; kk += 8) {
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + 16 * i + gr;
      float v[4];
      if (A_KC) {
        v[0] = As[r * TC_LDK + kk + tq];
        v[1] = As[(r + 8) * TC_LDK + kk + tq];
        v[2] = As[r * TC_LDK + kk + tq + 4];
        v[3] = As[(r + 8) * TC_LDK + kk + tq + 4];
      } else {
        v[0] = As[(kk + tq) * TC_LDM + r];
        v[1] = As[(kk + tq) * TC_LDM + r + 8];
        v[2] = As[(kk + tq + 4) * TC_LDM + r];
        v[3] = As[(kk + tq + 4) * TC_LDM + r + 8];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) tf32_split(v[q], ah[i][q], al[i][q]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + 8 * j + gr;
      float v[2];
      if (B_NC) {
        v[0] = Bs[(kk + tq) * TC_LDN + c];
        v[1] = Bs[(kk + tq + 4) * TC_LDN + c];
      } else {
        v[0] = Bs[c * TC_LDK + kk + tq];
        v[1] = Bs[c * TC_LDK + kk + tq + 4];
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) tf32_split(v[q], bh[j][q], bl[j][q]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tc_mma(t[i][j], al[i], bh[j]);
        tc_mma(t[i][j], ah[i], bl[j]);
        tc_mma(t[i][j], ah[i], bh[j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[i][j][q] = __fadd_rn(acc[i][j][q], t[i][j][q]);
}

template <bool A_KC, bool B_NC>
__global__ void __launch_bounds__(TC_THREADS, 2)
tf32x3_kernel(Tf32x3Args g) {
  extern __shared__ __align__(16) float tc_sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
  const int z = blockIdx.z / g.splits, s = blockIdx.z % g.splits;
  const int k_begin = s * g.kc, k_end = min(g.K, k_begin + g.kc);
  const float* A = g.A + z * g.za;
  const float* B = g.B + z * g.zb;
  const int nk = (k_end - k_begin + TC_BK - 1) / TC_BK;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    if (st < nk) {
      float* As = tc_sm + st * TC_STAGE_FLOATS;
      tc_load<A_KC, B_NC>(g, A, B, As, As + TC_A_FLOATS, m0, n0,
                          k_begin + st * TC_BK, k_end);
    }
    tc_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc_wait<TC_STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();           // ... and everyone's; stage kt - 1 is free
    const int nxt = kt + TC_STAGES - 1;
    if (nxt < nk) {
      float* As = tc_sm + (nxt % TC_STAGES) * TC_STAGE_FLOATS;
      tc_load<A_KC, B_NC>(g, A, B, As, As + TC_A_FLOATS, m0, n0,
                          k_begin + nxt * TC_BK, k_end);
    }
    tc_commit();
    const float* As = tc_sm + (kt % TC_STAGES) * TC_STAGE_FLOATS;
    tc_tile<A_KC, B_NC>(As, As + TC_A_FLOATS, wm, wn, gr, tq, acc);
  }
  tc_wait<0>();

  float* out;
  long long ldo;
  const float* bias = nullptr;
  if (g.splits > 1) {  // this chunk's partial tile
    out = g.part + (long long)blockIdx.z * g.M * g.N;
    ldo = g.N;
  } else {
    out = g.C + z * g.zc;
    ldo = g.ldc;
    if (g.bias) bias = g.bias + z * g.zbias;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + gr + 8 * h;
      if (m >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn + 8 * j + 2 * tq + q;
          if (n >= g.N) continue;
          float v = acc[i][j][2 * h + q];
          if (bias) v = __fadd_rn(v, bias[n]);
          out[m * ldo + n] = v;
        }
    }
}

// C(z, m, n) = sum over chunks q = 0.. in order of part(z, q, m, n)
// [+ bias(z, n)].
__global__ void __launch_bounds__(TC_SUM_THREADS)
tf32x3_sum_parts_kernel(const float* __restrict__ part, int splits, int M,
                        int N, int batch, float* C, long long ldc,
                        long long zc, const float* __restrict__ bias,
                        long long zbias) {
  const long long mn = (long long)M * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn * batch) return;
  const int z = (int)(i / mn);
  const long long r = i - z * mn;
  const float* p = part + (long long)z * splits * mn + r;
  float s = p[0];
  for (int q = 1; q < splits; ++q) s = __fadd_rn(s, p[q * mn]);
  const int m = (int)(r / N), n = (int)(r % N);
  if (bias) s = __fadd_rn(s, bias[z * zbias + n]);
  C[z * zc + m * ldc + n] = s;
}

inline bool tc_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool A_KC, bool B_NC>
inline cudaError_t tc_launch(const Tf32x3Args& g, dim3 grid,
                             cudaStream_t st) {
  // set at every launch, as the other kernels here do: a flag kept in a
  // static would be one process-wide object (a GNU unique symbol) shared by
  // every library that includes this header, each with its own kernel
  const cudaError_t e = cudaFuncSetAttribute(
      tf32x3_kernel<A_KC, B_NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TC_SMEM);
  if (e != cudaSuccess) return e;
  tf32x3_kernel<A_KC, B_NC><<<grid, TC_THREADS, TC_SMEM, st>>>(g);
  return cudaGetLastError();
}

// gemm()'s arguments (forms 'N', 'T', 'A'; row strides lda / ldb / ldc and
// batch offsets in floats), plus `part`, room for
// tf32x3_part_floats(M, N, K, batch) floats (unused when that is 0).
// Returns the launch error.
inline cudaError_t tf32x3_gemm(char form, const float* A, long long lda,
                               const float* B, long long ldb, float* C,
                               long long ldc, const float* bias, int M,
                               int N, int K, int batch, long long za,
                               long long zb, long long zc, long long zbias,
                               float* part, cudaStream_t st) {
  if (M <= 0 || N <= 0 || batch <= 0) return cudaSuccess;
  if (K < 0 || (form != 'N' && form != 'T' && form != 'A'))
    return cudaErrorInvalidValue;
  const TcPlan plan = tc_plan(M, N, K, batch);
  if (plan.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  if ((long long)batch * plan.splits > 65535 || (M + TC_BM - 1) / TC_BM > 65535)
    return cudaErrorInvalidConfiguration;
  Tf32x3Args g;
  g.A = A; g.B = B; g.C = C; g.bias = bias; g.part = part;
  g.lda = lda; g.ldb = ldb; g.ldc = ldc;
  g.za = za; g.zb = zb; g.zc = zc; g.zbias = zbias;
  g.M = M; g.N = N; g.K = K;
  g.kc = plan.kc; g.splits = plan.splits;
  g.vec_a = tc_aligned16(A) && lda % 4 == 0 && za % 4 == 0;
  g.vec_b = tc_aligned16(B) && ldb % 4 == 0 && zb % 4 == 0;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM,
                  batch * plan.splits);
  cudaError_t e = form == 'N'   ? tc_launch<true, true>(g, grid, st)
                  : form == 'T' ? tc_launch<true, false>(g, grid, st)
                                : tc_launch<false, true>(g, grid, st);
  if (e != cudaSuccess || plan.splits == 1) return e;
  const long long total = (long long)batch * M * N;
  tf32x3_sum_parts_kernel<<<(unsigned)((total + TC_SUM_THREADS - 1) /
                                       TC_SUM_THREADS),
                            TC_SUM_THREADS, 0, st>>>(
      part, plan.splits, M, N, batch, C, ldc, zc, bias, zbias);
  return cudaGetLastError();
}

}  // namespace icee
