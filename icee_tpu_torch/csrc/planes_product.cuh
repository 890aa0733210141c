// The planes product: C = A W [+ bias] at float32 accuracy on the H100's
// tensor cores (3xTF32 by wgmma), where W is one weight that many products
// of a call share.  Used by K9 and K10 (senticap_beam.cuh: the cell and
// head products of every search step) and by K3 and K8 (lstm_scan.cu,
// senticap_scan.cu: the products over all B * T rows whose B operand is a
// weight, 'N' form C = A W and 'T' form C = A W^T).
//
// The weights are the same for every product of a call, so the call lays
// each one out once (sb_prepare_kernel) in the form the tensor cores read:
// W (K, N) becomes planes (Np, 2 Kp), Np = N rounded up to 64 and Kp = K
// rounded up to 32 (zeros past N and K), row n holding column n of W
// k-contiguous, each 32-deep k tile as its 32 hi values, then its 32 lo
// values, hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
// (gemm_tf32x3.cuh's tf32_split, bit for bit).  The preparation reads W
// through element strides, so the planes of W^T (the 'T' form: row n of
// the planes is row n of W, already k-contiguous) come from the same
// kernel.  A tile's rows are then 128 contiguous bytes a plane, copied into
// shared memory in wgmma's K-major 128-byte swizzle (16-byte chunk c of row
// r at c ^ (r % 8) in 1024-byte atoms), and no thread splits B.  A (the
// activations, new every product) is split in registers as gemm_tf32x3.cuh
// splits it and fed to wgmma from registers.  Each output adds lo_a hi_b,
// hi_a lo_b, hi_a hi_b (small terms first) for each 8-deep step into a
// fragment that the k tile's first wgmma starts from 0 (scale-d false),
// then a rounded add into the float32 accumulator (the tensor core's
// float32 sum truncates; gemm_tf32x3.cuh's header), then + bias:
// gemm_tf32x3.cuh's arithmetic on the warpgroup instruction.  No atomics:
// where a product is cut into k ranges, their partial sums are written
// apart and the caller adds them in range order.
//
// Why wgmma: the planes make both operands k-major, as TF32 wgmma requires,
// and the first design, gemm_tf32x3.cuh's mma.sync loop on the planes
// (128 x 64 tiles, two blocks an SM), ran the products at 30-44 TFLOP/s:
// its arithmetic alone, without copies, at 50-60, its copies alone at ~5
// TB/s from L2 (scripts/probe_sb_product.py): the issue of 24 mmas, 8
// fragment loads and 40 split instructions a warp an 8-deep step held it.
// A warpgroup's wgmma does a 64 x 64 x 8 step in one instruction from
// shared memory, which leaves the copies from L2 as the larger cost.
//
// Tiles: 128 rows x 64 columns, two warpgroups of 64 rows, two blocks an
// SM (128 x 128 tiles, one block an SM, copy 25% fewer bytes a flop but
// ran 10-20% slower: one block's wgmma waits and barriers leave the tensor
// cores idle; with one copy warp and mbarriers instead of the barriers,
// slower still: that warp's cp.async issue could not feed two warpgroups),
// k tiles of 32 in a 3-stage cp.async ring; A rows of 36 floats (fragment
// loads free of bank conflicts).  A launch takes up to SP_MAX_BATCH
// products of one shape (blockIdx.z: K10's two paths, K3's four gates),
// each with its own A, planes, C and bias at fixed offsets.
#pragma once

#include "gemm_tf32x3.cuh"  // tf32_split, tc_copy16/4, tc_commit, tc_wait

namespace icee {

constexpr int SP_BM = 128, SP_BN = 64, SP_BK = 32, SP_STAGES = 3;
constexpr int SP_THREADS = 256;        // two warpgroups
constexpr int SP_LDA = SP_BK + 4;      // A rows in shared memory
constexpr int SP_NP = 64;              // planes' rows: a multiple of this
constexpr int SP_MAX_BATCH = 4;        // products of one launch

// W (K, N), W(k, n) = W[k sk + n sn] (the z-th of blockIdx.y at W + z zw)
// -> planes (Np, 2 Kp) at P + z zp, as the header says; one thread a
// 16-byte group (n, k tile, plane, 4 k), n fastest where W's rows are
// n-contiguous (sn 1) and the group fastest where they are k-contiguous,
// so that W is read in order either way.
__global__ void sb_prepare_kernel(const float* __restrict__ W, int K, int N,
                                  long long sk, long long sn, long long zw,
                                  int Kp, int Np, float* P, long long zp) {
  const long long total = (long long)Np * (Kp / 2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int groups = Kp / 2;   // 16-byte groups of a planes row
  W += blockIdx.y * zw;
  P += blockIdx.y * zp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int n = sn == 1 ? (int)(i % Np) : (int)(i / groups);
    const int r = sn == 1 ? (int)(i / Np) : (int)(i % groups);
    const int kt = r >> 4, lo = (r >> 3) & 1, k0 = SP_BK * kt + 4 * (r & 7);
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + q;
      const float x = n < N && k < K ? W[k * sk + n * sn] : 0.f;
      unsigned h, l;
      tf32_split(x, h, l);
      v[q] = __uint_as_float(lo ? l : h);
    }
    *reinterpret_cast<float4*>(P + (long long)n * 2 * Kp + 4 * r) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

struct SbProduct {
  const float* A;      // A(z, m, k) = A[z * za + m * lda + k]
  const float* P;      // planes of product z at P + z * zp, rows of 2 kp
  const float* bias[SP_MAX_BATCH];  // (N,) of product z (BIAS only)
  float* C;            // C(z, m, n) = C[z * zc + m * ldc + n] (+ s zs)
  long long lda, za, zp, ldc, zc, zs;
  int M, N, K, kp;
  int splits;          // k ranges a product (their partial sums apart)
  int vec_a;           // 1: 16-byte copies of A's rows
};

// Bytes of one ring stage: B's hi and lo tiles (64 rows of 128 bytes each,
// in 1024-byte swizzle atoms), then A's 128 rows of SP_LDA floats.
__host__ __device__ constexpr int sp_stage_bytes() {
  return 2 * SP_BN * 128 + 4 * SP_BM * SP_LDA;
}

__host__ __device__ constexpr int sp_smem_bytes() {
  return SP_STAGES * sp_stage_bytes() + 1024;   // + aligning the ring
}

// The shared-memory descriptor of a K-major tile of rows of 128 bytes (32
// TF32 values) in the 128-byte swizzle: 8-row atoms of 1024 bytes, 16-byte
// chunk c of row r at c ^ (r % 8); the leading offset unused, the stride
// between atoms 1024 bytes.
__device__ __forceinline__ unsigned long long wg_desc(unsigned saddr) {
  return (unsigned long long)((saddr & 0x3ffff) >> 4) |
         (1ull << 16) | ((unsigned long long)(1024 >> 4) << 32) |
         (1ull << 62);
}

// t (+)= a b on a 64 x 64 tile: a (64 x 8, TF32) from registers in the
// m16n8k8 A layout a warp a 16-row slice; b (8 x 64, TF32) from shared
// memory by its descriptor; acc = 0: t = a b (scale-d false).
__device__ __forceinline__ void wg_mma_n64(float (&t)[32],
                                          const unsigned (&a)[4],
                                          unsigned long long b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      :
        "+f"(t[0]), "+f"(t[1]), "+f"(t[2]), "+f"(t[3]),
        "+f"(t[4]), "+f"(t[5]), "+f"(t[6]), "+f"(t[7]),
        "+f"(t[8]), "+f"(t[9]), "+f"(t[10]), "+f"(t[11]),
        "+f"(t[12]), "+f"(t[13]), "+f"(t[14]), "+f"(t[15]),
        "+f"(t[16]), "+f"(t[17]), "+f"(t[18]), "+f"(t[19]),
        "+f"(t[20]), "+f"(t[21]), "+f"(t[22]), "+f"(t[23]),
        "+f"(t[24]), "+f"(t[25]), "+f"(t[26]), "+f"(t[27]),
        "+f"(t[28]), "+f"(t[29]), "+f"(t[30]), "+f"(t[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// One k tile [k0, k0 + 32) of A (zero past M and K) and of the planes'
// hi and lo tiles (in bounds by construction: Np and Kp padded) into a
// stage.
__device__ __forceinline__ void sp_load(const SbProduct& g, const float* A,
                                        const float* P, unsigned char* stage,
                                        int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * SP_BN * 8; i += SP_THREADS) {
    const int n = i >> 4, lo = (i >> 3) & 1, c = i & 7;
    unsigned char* dst = stage + lo * SP_BN * 128 + (n >> 3) * 1024 +
                         (n & 7) * 128 + ((c ^ (n & 7)) << 4);
    tc_copy16(reinterpret_cast<float*>(dst),
              P + (long long)(n0 + n) * 2 * g.kp + 2 * k0 + 32 * lo + 4 * c,
              16);
  }
  float* As = reinterpret_cast<float*>(stage + 2 * SP_BN * 128);
  if (g.vec_a) {
    for (int i = tid; i < SP_BM * SP_BK / 4; i += SP_THREADS) {
      const int m = i / (SP_BK / 4), k = (i % (SP_BK / 4)) * 4;
      const int gm = m0 + m, gk = k0 + k;
      const bool in = gm < g.M && gk < g.K;
      tc_copy16(As + m * SP_LDA + k, in ? A + gm * g.lda + gk : A,
                in ? 4 * min(4, g.K - gk) : 0);
    }
  } else {
    for (int i = tid; i < SP_BM * SP_BK; i += SP_THREADS) {
      const int m = i / SP_BK, k = i % SP_BK;
      const int gm = m0 + m, gk = k0 + k;
      const bool in = gm < g.M && gk < g.K;
      tc_copy4(As + m * SP_LDA + k, in ? A + gm * g.lda + gk : A,
               in ? 4 : 0);
    }
  }
}

// C = A W [+ bias] for batch entry z and k range s of blockIdx.z = z
// splits + s (the range's partial sum at C + s zs; BIAS only where splits
// is 1); tile (blockIdx.y, blockIdx.x) of 128 x 64, two warpgroups of 64
// rows.  Each k tile: the warpgroup's A fragments from shared memory,
// split in registers; then for each 8-deep step lo_a hi_b, hi_a lo_b,
// hi_a hi_b by wgmma into t (the first of the tile with scale-d false, so
// t starts from 0); then acc += t, rounded.  BIAS also tells K9's head
// products from its cell products in a profile.
template <bool BIAS>
__global__ void __launch_bounds__(SP_THREADS, 2)
sb_product_kernel(SbProduct g) {
  extern __shared__ unsigned char sp_raw[];
  const unsigned raw = (unsigned)__cvta_generic_to_shared(sp_raw);
  unsigned char* ring = sp_raw + ((1024 - (raw & 1023)) & 1023);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int row = 16 * warp + gr;   // warpgroup warp / 4 holds rows 64 wg..
  const int m0 = blockIdx.y * SP_BM, n0 = blockIdx.x * SP_BN;
  const int z = blockIdx.z / g.splits, sp = blockIdx.z % g.splits;
  const float* A = g.A + z * g.za;
  const float* P = g.P + z * g.zp;
  const int nk_all = (g.K + SP_BK - 1) / SP_BK;
  const int per = (nk_all + g.splits - 1) / g.splits;
  const int kt0 = sp * per, nk = min(nk_all, kt0 + per) - kt0;
  constexpr int STAGE = sp_stage_bytes();

  float acc[SP_BN / 2], t[SP_BN / 2];
#pragma unroll
  for (int i = 0; i < SP_BN / 2; ++i) acc[i] = t[i] = 0.f;

#pragma unroll
  for (int st = 0; st < SP_STAGES - 1; ++st) {
    if (st < nk)
      sp_load(g, A, P, ring + st * STAGE, m0, n0, (kt0 + st) * SP_BK);
    tc_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc_wait<SP_STAGES - 2>();  // tile kt has landed (this thread's copies)
    // the copies' writes, made visible to wgmma's reads (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();           // ... and everyone's; stage kt - 1 is free
    const int nxt = kt + SP_STAGES - 1;
    if (nxt < nk)
      sp_load(g, A, P, ring + (nxt % SP_STAGES) * STAGE, m0, n0,
              (kt0 + nxt) * SP_BK);
    tc_commit();
    const int so = (kt % SP_STAGES) * STAGE;
    const float* As =
        reinterpret_cast<const float*>(ring + so + 2 * SP_BN * 128);
    unsigned ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 8 * s + tq;
      float v[4];
      v[0] = As[row * SP_LDA + k];
      v[1] = As[(row + 8) * SP_LDA + k];
      v[2] = As[row * SP_LDA + k + 4];
      v[3] = As[(row + 8) * SP_LDA + k + 4];
#pragma unroll
      for (int q = 0; q < 4; ++q) tf32_split(v[q], ah[s][q], al[s][q]);
    }
    const unsigned long long dh = wg_desc(ring_s + so);
    const unsigned long long dl = wg_desc(ring_s + so + SP_BN * 128);
#pragma unroll
    for (int i = 0; i < SP_BN / 2; ++i)
      asm volatile("" : "+f"(t[i])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s) {   // + 32 bytes (2 x 16) a k8 step
      wg_mma_n64(t, al[s], dh + 2 * s, s);
      wg_mma_n64(t, ah[s], dl + 2 * s, 1);
      wg_mma_n64(t, ah[s], dh + 2 * s, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < SP_BN / 2; ++i) {   // t is read only after the wait
      asm volatile("" : "+f"(t[i])::"memory");
      acc[i] = __fadd_rn(acc[i], t[i]);
    }
  }
  tc_wait<0>();

  // acc[4 j + 2 h + q] holds C(row + 8 h, 8 j + 2 tq + q) of the tile
  float* C = g.C + z * g.zc + sp * g.zs;
  // constant indices: a kernel parameter indexed at run time would be
  // copied to local memory
  const float* bias = !BIAS    ? nullptr
                      : z == 0 ? g.bias[0]
                      : z == 1 ? g.bias[1]
                      : z == 2 ? g.bias[2]
                               : g.bias[3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row + 8 * h;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < SP_BN / 8; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 8 * j + 2 * tq + q;
        if (n >= g.N) continue;
        float v = acc[4 * j + 2 * h + q];
        if (BIAS) v = __fadd_rn(v, bias[n]);
        C[(long long)m * g.ldc + n] = v;
      }
  }
}

template <bool BIAS>
inline cudaError_t sp_launch(const SbProduct& g, int batch,
                             cudaStream_t st) {
  const int smem = sp_smem_bytes();
  // set at every launch, as gemm_tf32x3.cuh does (no process-wide flag)
  const cudaError_t e = cudaFuncSetAttribute(
      sb_product_kernel<BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.N + SP_BN - 1) / SP_BN, (g.M + SP_BM - 1) / SP_BM,
                  batch * g.splits);
  sb_product_kernel<BIAS><<<grid, SP_THREADS, smem, st>>>(g);
  return cudaGetLastError();
}

inline bool sp_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline int sp_round_up(int x, int to) { return (x + to - 1) / to * to; }

// Floats of the planes of a (K, N) weight.
inline long long sp_planes_floats(int K, int N) {
  return (long long)sp_round_up(N, SP_NP) * 2 * sp_round_up(K, SP_BK);
}

// C = A W_z [+ bias_z] for z < batch (<= SP_MAX_BATCH) with W_z prepared
// as planes at P + z zp (kp = W's padded depth), each product's k tiles
// cut into `splits` (1 or 2) ranges whose partial sums go to C + s zs (no
// bias then: the caller adds them in range order).  bias: null, or one
// pointer a product.
inline cudaError_t sb_product(const float* A, long long lda, long long za,
                              const float* P, long long zp, int kp,
                              const float* const* bias, float* C,
                              long long ldc, long long zc, long long zs,
                              int M, int N, int K, int batch, int splits,
                              cudaStream_t st) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K < 1 || kp < K || kp % SP_BK != 0 || batch < 1 ||
      batch > SP_MAX_BATCH || splits < 1 || splits > 2 ||
      (splits > 1 && bias != nullptr) || !sp_aligned16(P) || zp % 4 != 0)
    return cudaErrorInvalidValue;
  if ((M + SP_BM - 1) / SP_BM > 65535) return cudaErrorInvalidConfiguration;
  SbProduct g;
  g.A = A; g.P = P; g.C = C;
  for (int z = 0; z < SP_MAX_BATCH; ++z)
    g.bias[z] = bias && z < batch ? bias[z] : nullptr;
  if (bias)
    for (int z = 0; z < batch; ++z)
      if (bias[z] == nullptr) return cudaErrorInvalidValue;
  g.lda = lda; g.za = za; g.zp = zp; g.ldc = ldc; g.zc = zc;
  g.zs = zs; g.M = M; g.N = N; g.K = K; g.kp = kp; g.splits = splits;
  g.vec_a = sp_aligned16(A) && lda % 4 == 0 && za % 4 == 0;
  return bias ? sp_launch<true>(g, batch, st)
              : sp_launch<false>(g, batch, st);
}

// Lays out `batch` weights W_z (K, N), W_z(k, n) = W[z zw + k sk + n sn],
// as planes (Np, 2 Kp) at P + z * sp_planes_floats(K, N) (the header).
inline cudaError_t sb_prepare_strided(const float* W, int K, int N,
                                      long long sk, long long sn,
                                      long long zw, int batch, float* P,
                                      cudaStream_t st) {
  if (K < 1 || N < 1 || batch < 1 || batch > 65535 || !sp_aligned16(P))
    return cudaErrorInvalidValue;
  const int Kp = sp_round_up(K, SP_BK), Np = sp_round_up(N, SP_NP);
  const long long total = (long long)Np * (Kp / 2);
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                      : 4096);
  sb_prepare_kernel<<<dim3(blocks, batch), 256, 0, st>>>(
      W, K, N, sk, sn, zw, Kp, Np, P, sp_planes_floats(K, N));
  return cudaGetLastError();
}

// W (K, N) rows -> planes (Np, 2 Kp).
inline cudaError_t sb_prepare(const float* W, int K, int N, float* P,
                              cudaStream_t st) {
  return sb_prepare_strided(W, K, N, N, 1, 0, 1, P, st);
}

}  // namespace icee
