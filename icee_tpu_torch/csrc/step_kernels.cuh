// The many-row decode step of K1 (decode_step.cu, the FactoredLSTM step)
// and K6 (att_decode_step.cu, whose cell input is [emb; gated context]):
// every shape the column-split path (split_step.cuh, one image's k <= 8
// rows) does not take.
//
// What bounds it on the H100: operations.  At R = 320 rows and H = F =
// 2048 a K1 step is 44.5 GFLOP of float32 multiply-adds against ~100 MB of
// weights, so a design that reads the weights once per few rows is bound
// by those reads from L2 instead.
//
// Design: each product of the step is one register-tiled float32 SIMT
// product over ALL R rows (step_gemm_kernel): a block owns a BM x BN tile
// of (row, column) outputs (128 x 128, 64 x 128, 64 x 64 or 32 x 64,
// chosen per launch by gemm_pick so that the card is filled), each thread
// an 8 x 8 block of them in registers; the rows' and the weight's k tiles
// (8 deep) are double-buffered in shared memory, the next one loaded into
// registers while the block works on this one.  So each weight tile is
// read once per tile of BM rows, and a
// block's row tiles of one weight tile run side by side (row tile fastest
// in the grid), so that the weight comes from device memory once.  The
// products are float32 fmaf on the CUDA cores, not 3xTF32 wgmma: every
// output stays ONE fmaf chain in k order from 0.f, then + bias, as
// decode_common.cuh's dot4 and the cell's sums make it (the library is
// built with -fmad=false), so a row's bits do not depend on the tile
// that holds it, and K2 = K1 and K7 = K6 stay exact.  A k tile past K is
// zero-filled: fmaf(0, 0, acc) = acc for every acc a chain from +0 can
// reach, so the padding adds nothing.
//
// The step's launches (the caller's stream):
//   K1: {v = x V_w + V_b, hwb = h W_w + W_b} -> s_g = v_g S_g + S_b ->
//       z_g = (s_g U_g + U_b) + hwb -> gates -> logits = h' C_w + C_b ->
//       tile partials + merge (k <= KMAX) or the wide reduce.
//   K6: {att2, gate pre-activation, hwb or hh} -> scores -> context ->
//       (factored) v = x V_w + V_b -> s -> z -> gates, (lstm) z = ((x W_ih
//       + b_ih) + h W_hh) + b_hh -> gates -> logits -> reduce
//       (att_decode_step.cu holds the attention launches).
// The logits (R, V) go to device memory; the reduce takes each 256-wide
// tile through tile_reduce and each row through merge_row, or through the
// wide reduce (wide_topk.cuh) above KMAX: the functions the column-split
// path and K2 and K7 call, so the log-probs are the same bits.
#pragma once

#include "decode_common.cuh"
#include "wide_topk.cuh"

namespace icee {

constexpr int GEMM_BK = 8;              // k tile
constexpr int GEMM_CONFIGS = 4;         // tile shapes, largest first
constexpr int MAX_GEMM_JOBS = 3;        // products in one launch
constexpr int GATE_THREADS = 256;
constexpr int PART_WARPS = 8;           // tile partials: a warp a (row, tile)
constexpr size_t STEP_SMEM_MAX = 232448;  // bytes of shared memory a block

__host__ __device__ constexpr int gemm_bm(int cfg) {
  return cfg == 0 ? 128 : cfg == 3 ? 32 : 64;
}
__host__ __device__ constexpr int gemm_bn(int cfg) {
  return cfg <= 1 ? 128 : 64;
}
// Bytes of shared memory of a product block of tile shape cfg: two k
// tiles (the one read, the one being written) of its rows, k-major (BK x
// BM + 4), and of the weight (BK x BN).
__host__ __device__ constexpr size_t gemm_smem(int cfg) {
  return sizeof(float) * 2 * GEMM_BK *
         ((size_t)gemm_bm(cfg) + 4 + (size_t)gemm_bn(cfg));
}

// One product of a launch: for segments s < nseg, rows r < M (the
// launch's), columns n < N: out[r ldo + s N + n] = ((acc + b1[s N + n]) +
// add[r ldo + s N + n]) + b2[s N + n], each term only where its pointer is
// not null, acc = sum_k A[r lda + s aseg + k] W[s wseg + k ldw + n] one
// fmaf chain in k order from 0.
struct GemmJob {
  const float* A;
  const float* W;
  const float* b1;
  const float* add;
  const float* b2;
  float* out;
  long long wseg;
  int N, K, nseg, lda, aseg, ldw, ldo;
  int vecA;  // A's rows load as 16-byte quads (set by launch_gemm)
};

struct GemmLaunch {
  GemmJob job[MAX_GEMM_JOBS];
  int n_jobs, M;
};

// Blocks of a launch at tile shape cfg: row tiles x column tiles x
// segments, summed over its products.
__host__ __device__ inline long long gemm_blocks(int cfg, int M, int n_jobs,
                                                 const int* N,
                                                 const int* nseg) {
  const long long mt = (M + gemm_bm(cfg) - 1) / gemm_bm(cfg);
  long long b = 0;
  for (int j = 0; j < n_jobs; ++j)
    b += mt * nseg[j] * ((N[j] + gemm_bn(cfg) - 1) / gemm_bn(cfg));
  return b;
}

// The tile shape of a launch: the least work on the busiest SM, ceil(blocks
// / sms) x (BM BN + 8 (BM + BN)): its blocks' outputs (every block of a
// launch resident at once), and a charge for the k tiles a block copies
// through L2 (BM + BN floats a k step for BM BN outputs); ties to the
// larger tile.
__host__ __device__ inline int gemm_pick(int M, int n_jobs, const int* N,
                                         const int* nseg, int sms) {
  int best = 0;
  long long best_cost = -1;
  for (int cfg = 0; cfg < GEMM_CONFIGS; ++cfg) {
    const long long blocks = gemm_blocks(cfg, M, n_jobs, N, nseg);
    const long long bm = gemm_bm(cfg), bn = gemm_bn(cfg);
    const long long cost =
        (blocks + sms - 1) / sms * (bm * bn + 8 * (bm + bn));
    if (best_cost < 0 || cost < best_cost) {
      best = cfg;
      best_cost = cost;
    }
  }
  return best;
}

// Thread (tx, ty) of BM x BN / 64 threads owns rows 4 ty + i and 4 ty +
// BM / 2 + i, columns 4 tx + j and 4 tx + BN / 2 + j (i, j < 4): at each k
// four 16-byte shared loads (its rows' values of the k-major row tile, its
// columns' of the weight tile) feed 64 fmafs.  The next k tile is loaded
// from device memory into registers while this one is used, then stored
// into the other shared buffer (the row tile transposed on the way).
// Registers: the 128 x 128 and 64 x 64 tiles are held to 128 a thread (two
// and eight blocks an SM: 16 warps); at R = 320 rows and H = 2048 that took
// K1 from 1.85 to 1.57 ms, where capping the 64 x 128 and 32 x 64 tiles
// too made those slower (scripts/probe_step_gemm.py; NVIDIA H100 80GB
// HBM3, 700.00 W).
template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 64,
                                  BM == 128 ? 2 : (BM == 64 && BN == 64) ? 8
                                                                         : 1)
step_gemm_kernel(const GemmLaunch L) {
  constexpr int NT = BM * BN / 64, TX = BN / 8, LDA = BM + 4;
  constexpr int AQ = BM * GEMM_BK / 4 / NT;   // row-tile quads a thread
  constexpr int WQ = GEMM_BK * BN / 4 / NT;   // weight-tile quads a thread
  static_assert(AQ >= 1 && WQ >= 1, "a quad of each tile a thread");
  __shared__ __align__(16) float As[2][GEMM_BK][LDA];
  __shared__ __align__(16) float Ws[2][GEMM_BK][BN];
  const int tid = threadIdx.x, M = L.M;
  const int mt = (M + BM - 1) / BM;

  int b = blockIdx.x, jn = 0;
  for (; jn + 1 < L.n_jobs; ++jn) {
    const int nb = mt * L.job[jn].nseg * ((L.job[jn].N + BN - 1) / BN);
    if (b < nb) break;
    b -= nb;
  }
  const GemmJob J = L.job[jn];
  const int ntl = (J.N + BN - 1) / BN;
  const int m0 = (b % mt) * BM;
  const int n0 = (b / mt % ntl) * BN;
  const int seg = b / mt / ntl;
  const float* A = J.A + (size_t)seg * J.aseg;
  const float* W = J.W + (size_t)seg * J.wseg;
  const int K = J.K, nk = (K + GEMM_BK - 1) / GEMM_BK;

  float4 ra[AQ], rw[WQ];
  auto fetch = [&](int kt) {
    const int k0 = kt * GEMM_BK;
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int i = tid + q * NT;
      const int gm = m0 + i / (GEMM_BK / 4);
      const int gk = k0 + 4 * (i % (GEMM_BK / 4));
      const float* src = A + (size_t)gm * J.lda + gk;
      if (J.vecA) {
        ra[q] = gm < M && gk < K ? __ldg(reinterpret_cast<const float4*>(src))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool row = gm < M;
        ra[q] = make_float4(row && gk < K ? __ldg(src) : 0.f,
                            row && gk + 1 < K ? __ldg(src + 1) : 0.f,
                            row && gk + 2 < K ? __ldg(src + 2) : 0.f,
                            row && gk + 3 < K ? __ldg(src + 3) : 0.f);
      }
    }
#pragma unroll
    for (int q = 0; q < WQ; ++q) {
      const int i = tid + q * NT;
      const int gk = k0 + i / (BN / 4), gn = n0 + 4 * (i % (BN / 4));
      rw[q] = gk < K && gn < J.N
                  ? __ldg(reinterpret_cast<const float4*>(
                        W + (size_t)gk * J.ldw + gn))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int i = tid + q * NT;
      const int m = i / (GEMM_BK / 4), kq = 4 * (i % (GEMM_BK / 4));
      As[buf][kq + 0][m] = ra[q].x;
      As[buf][kq + 1][m] = ra[q].y;
      As[buf][kq + 2][m] = ra[q].z;
      As[buf][kq + 3][m] = ra[q].w;
    }
#pragma unroll
    for (int q = 0; q < WQ; ++q) {
      const int i = tid + q * NT;
      *reinterpret_cast<float4*>(&Ws[buf][i / (BN / 4)][4 * (i % (BN / 4))]) =
          rw[q];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int tx = tid % TX, ty = tid / TX;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch(kt + 1);
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty + BM / 2]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[buf][kk][4 * tx]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&Ws[buf][kk][4 * tx + BN / 2]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(buf ^ 1);   // buf ^ 1 was last read before the
    __syncthreads();                    // barrier that ended step kt - 1
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + 4 * ty + (i & 3) + (i >> 2) * (BM / 2);
    if (r >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 4 * tx + half * (BN / 2);
      if (n >= J.N) continue;   // N % 4 == 0: a quad is wholly in or out
      const int col = seg * J.N + n;
      const size_t o = (size_t)r * J.ldo + col;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][4 * half + j];
        if (J.b1 != nullptr) v[j] = v[j] + J.b1[col + j];
        if (J.add != nullptr) v[j] = v[j] + J.add[o + j];
        if (J.b2 != nullptr) v[j] = v[j] + J.b2[col + j];
      }
      *reinterpret_cast<float4*>(J.out + o) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
    }
  }
}

inline GemmJob gemm_job(const float* A, int lda, int K, const float* W,
                        int ldw, int N, const float* b1, float* out,
                        int ldo) {
  return GemmJob{A, W, b1, nullptr, nullptr, out, 0, N, K, 1, lda, 0, ldw,
                 ldo, 0};
}

// The product over a weight's four gate segments (S_w, U_w): A's segment
// s at column s aseg, W's at s wseg, out's at column s N.
inline GemmJob gemm_job4(const float* A, int lda, int aseg, int K,
                         const float* W, long long wseg, int ldw, int N,
                         const float* b1, float* out, int ldo) {
  return GemmJob{A, W, b1, nullptr, nullptr, out, wseg, N, K, 4, lda, aseg,
                 ldw, ldo, 0};
}

template <int CFG>
cudaError_t launch_gemm_cfg(const GemmLaunch& L, long long blocks,
                            cudaStream_t s) {
  constexpr int BM = gemm_bm(CFG), BN = gemm_bn(CFG);
  step_gemm_kernel<BM, BN><<<(unsigned)blocks, BM * BN / 64, 0, s>>>(L);
  return cudaGetLastError();
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// One product launch: validates its jobs (16-byte quads of W and out,
// N % 4 == 0), marks the jobs whose A loads as quads, picks the tile.
inline cudaError_t launch_gemm(GemmLaunch L, cudaStream_t s) {
  int N[MAX_GEMM_JOBS], nseg[MAX_GEMM_JOBS];
  if (L.M <= 0 || L.n_jobs < 1 || L.n_jobs > MAX_GEMM_JOBS)
    return cudaErrorInvalidValue;
  for (int j = 0; j < L.n_jobs; ++j) {
    GemmJob& J = L.job[j];
    const bool aligned = ((reinterpret_cast<uintptr_t>(J.W) |
                           reinterpret_cast<uintptr_t>(J.out)) & 15) == 0;
    if (J.K <= 0 || J.N <= 0 || J.nseg < 1 || !aligned ||
        ((J.N | J.ldw | J.ldo | (int)(J.wseg & 3)) & 3))
      return cudaErrorInvalidValue;
    J.vecA = (reinterpret_cast<uintptr_t>(J.A) & 15) == 0 &&
             ((J.lda | J.aseg | J.K) & 3) == 0;
    N[j] = J.N;
    nseg[j] = J.nseg;
  }
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int cfg = gemm_pick(L.M, L.n_jobs, N, nseg, sms);
  const long long blocks = gemm_blocks(cfg, L.M, L.n_jobs, N, nseg);
  switch (cfg) {
    case 0: return launch_gemm_cfg<0>(L, blocks, s);
    case 1: return launch_gemm_cfg<1>(L, blocks, s);
    case 2: return launch_gemm_cfg<2>(L, blocks, s);
    default: return launch_gemm_cfg<3>(L, blocks, s);
  }
}

inline GemmLaunch gemm_launch(int M, const GemmJob& a) {
  GemmLaunch L = {};
  L.M = M;
  L.n_jobs = 1;
  L.job[0] = a;
  return L;
}

// The cell's gates from z (R, 4H) and c (R, H) -> h', c' (R, H): the
// factored cell's [i, f, o, c] with h = o c (no tanh: reference quirk), or
// (LSTM) torch's [i, f, g, o] with h = o tanh(c); the float order of
// factored_cell's and lstm_cell's last loops.
template <bool LSTM>
__global__ void __launch_bounds__(GATE_THREADS)
gates_kernel(const float* __restrict__ z, const float* __restrict__ c_in,
             float* h_out, float* c_out, int R, int H) {
  const long long i = (long long)blockIdx.x * GATE_THREADS + threadIdx.x;
  if (i >= (long long)R * H) return;
  const long long r = i / H;
  const int j = (int)(i % H);
  const float* zr = z + r * 4 * H + j;
  const float i_t = sigmoid(zr[0]), f_t = sigmoid(zr[H]);
  float c_new, h_new;
  if constexpr (LSTM) {
    const float g_t = tanhf(zr[2 * H]), o_t = sigmoid(zr[3 * H]);
    c_new = f_t * c_in[i] + i_t * g_t;
    h_new = o_t * tanhf(c_new);
  } else {
    const float o_t = sigmoid(zr[2 * H]), g_t = tanhf(zr[3 * H]);
    c_new = f_t * c_in[i] + i_t * g_t;
    h_new = o_t * c_new;
  }
  c_out[i] = c_new;
  h_out[i] = h_new;
}

template <bool LSTM>
cudaError_t launch_gates(const float* z, const float* c, float* h_out,
                         float* c_out, int R, int H, cudaStream_t s) {
  const long long n = (long long)R * H;
  gates_kernel<LSTM><<<(unsigned)((n + GATE_THREADS - 1) / GATE_THREADS),
                       GATE_THREADS, 0, s>>>(z, c, h_out, c_out, R, H);
  return cudaGetLastError();
}

// A warp a (row, 256-wide vocab tile) of the logits lg (R, ld): the tile
// (columns past V as NEG) through tile_reduce into its partials pm, pse
// (R, n_tiles), pv, pi (R, n_tiles, k).
__global__ void __launch_bounds__(PART_WARPS * 32)
tile_partials_kernel(const float* __restrict__ lg, int ld, int R, int V,
                     int n_tiles, int k, float* pm, float* pse, float* pv,
                     int* pi) {
  __shared__ __align__(16) float lt[PART_WARPS][VT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * PART_WARPS + warp;
  if (task >= (long long)R * n_tiles) return;   // whole warps leave together
  const long long r = task / n_tiles;
  const int t = (int)(task % n_tiles);
#pragma unroll
  for (int u = 0; u < VT / 32; ++u) {
    const int col = t * VT + lane + 32 * u;
    lt[warp][lane + 32 * u] = col < V ? lg[r * ld + col] : NEG;
  }
  __syncwarp();
  tile_reduce(lt[warp], t * VT, k, pm + task, pse + task, pv + task * k,
              pi + task * k);
}

__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ pm, const float* __restrict__ pse,
             float* pv, const int* __restrict__ pi, float* logp, int* idx,
             int R, int n_tiles, int k) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warps leave together
  const size_t p = (size_t)r * n_tiles;
  merge_row(pm + p, pse + p, pv + p * k, pi + p * k, n_tiles, k,
            logp + (size_t)r * k, idx + (size_t)r * k);
}

// The step's device-memory planes, in order, each at a 16-byte boundary:
// (K6) att2 (R, A), the gate pre-activation (R, FS), the scores (R, P),
// x = [emb; gate ctx] (R, round4(E + FS)); hwb = h W_w + W_b or hh = h
// W_hh (R, 4H); (factored) v, s (R, 4F); z (R, 4H); the logits (R, V);
// then at k <= KMAX the partials pm, pse (R, n_tiles), pv, pi (R, n_tiles,
// k), above KWIDE the wide reduce's survivors (wide_cand_pairs).
struct StepWork {
  float *att2, *gpre, *sc, *xf, *hw, *v, *s, *z, *lg, *pm, *pse, *pv;
  int* pi;
  unsigned long long* cand;
  long long floats;   // the buffer's length
};

inline StepWork step_work(float* base, bool att, bool factored, int R,
                          int E, int F, int H, int V, int A, int P, int FS,
                          int k) {
  StepWork w = {};
  long long at = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + at;
    at += (n + 3) & ~3LL;
    return p;
  };
  const long long r = R;
  const int n_tiles = (V + VT - 1) / VT;
  if (att) {
    w.att2 = take(r * A);
    w.gpre = take(r * FS);
    w.sc = take(r * P);
    w.xf = take(r * round4(E + FS));
  }
  w.hw = take(r * 4 * H);
  if (factored) {
    w.v = take(r * 4 * F);
    w.s = take(r * 4 * F);
  }
  w.z = take(r * 4 * H);
  w.lg = take(r * V);
  if (k <= KMAX) {
    w.pm = take(r * n_tiles);
    w.pse = take(r * n_tiles);
    w.pv = take(r * n_tiles * k);
    w.pi = reinterpret_cast<int*>(take(r * n_tiles * k));
  } else if (k > KWIDE) {
    w.cand = reinterpret_cast<unsigned long long*>(
        take(2 * wide_cand_pairs(R, k)));
  }
  w.floats = at;
  return w;
}

// The cell's launches after the pre launch wrote hwb (factored) or hh
// (lstm) into w.hw: x (R, ldx, E_in = w.E wide) -> z -> gates -> h', c'.
inline cudaError_t launch_cell_rest(const float* x, int ldx,
                                    const CellWeights& cw, const float* c,
                                    const StepWork& w, float* h_out,
                                    float* c_out, int R, bool v_done,
                                    cudaStream_t s) {
  const int F = cw.F, H = cw.H;
  cudaError_t e;
  if (!v_done) {
    e = launch_gemm(gemm_launch(R, gemm_job(x, ldx, cw.E, cw.Vw, 4 * F,
                                            4 * F, cw.Vb, w.v, 4 * F)), s);
    if (e != cudaSuccess) return e;
  }
  e = launch_gemm(gemm_launch(R, gemm_job4(w.v, 4 * F, F, F, cw.Sw,
                                           (long long)F * F, F, F, cw.Sb,
                                           w.s, 4 * F)), s);
  if (e != cudaSuccess) return e;
  GemmJob u = gemm_job4(w.s, 4 * F, F, F, cw.Uw, (long long)F * H, H, H,
                        cw.Ub, w.z, 4 * H);
  u.add = w.hw;
  e = launch_gemm(gemm_launch(R, u), s);
  if (e != cudaSuccess) return e;
  return launch_gates<false>(w.z, c, h_out, c_out, R, H, s);
}

inline cudaError_t launch_cell_rest(const float* x, int ldx,
                                    const LstmWeights& lw, const float* c,
                                    const StepWork& w, float* h_out,
                                    float* c_out, int R, bool /*v_done*/,
                                    cudaStream_t s) {
  const int H = lw.H;
  GemmJob z = gemm_job(x, ldx, lw.E, lw.Wih, 4 * H, 4 * H, lw.bih, w.z,
                       4 * H);
  z.add = w.hw;
  z.b2 = lw.bhh;
  cudaError_t e = launch_gemm(gemm_launch(R, z), s);
  if (e != cudaSuccess) return e;
  return launch_gates<true>(w.z, c, h_out, c_out, R, H, s);
}

// The cell's h product for the pre launch: hwb = h W_w + W_b, or hh = h
// W_hh (no bias: z adds b_hh after).
inline GemmJob cell_h_job(const float* h, const CellWeights& cw,
                          const StepWork& w) {
  return gemm_job(h, round4(cw.H), cw.H, cw.Ww, 4 * cw.H, 4 * cw.H, cw.Wb,
                  w.hw, 4 * cw.H);
}
inline GemmJob cell_h_job(const float* h, const LstmWeights& lw,
                          const StepWork& w) {
  return gemm_job(h, round4(lw.H), lw.H, lw.Whh, 4 * lw.H, 4 * lw.H,
                  nullptr, w.hw, 4 * lw.H);
}

// The head and the reduce: logits = h' C_w + C_b (R, V) -> logp, idx (R,
// k): tile partials and merge at k <= KMAX, else the wide reduce.
inline cudaError_t launch_head(const float* h_out, int H, const float* Cw,
                               const float* Cb, const StepWork& w, int R,
                               int V, int k, float* logp, int* idx,
                               cudaStream_t s) {
  cudaError_t e = launch_gemm(
      gemm_launch(R, gemm_job(h_out, H, H, Cw, V, V, Cb, w.lg, V)), s);
  if (e != cudaSuccess) return e;
  if (k > KMAX)
    return launch_wide_reduce(w.lg, V, R, V, k, logp, idx, w.cand, s);
  const int n_tiles = (V + VT - 1) / VT;
  const long long tasks = (long long)R * n_tiles;
  tile_partials_kernel<<<(unsigned)((tasks + PART_WARPS - 1) / PART_WARPS),
                         PART_WARPS * 32, 0, s>>>(w.lg, V, R, V, n_tiles, k,
                                                  w.pm, w.pse, w.pv, w.pi);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  merge_kernel<<<(R + 7) / 8, 256, 0, s>>>(w.pm, w.pse, w.pv, w.pi, logp,
                                           idx, R, n_tiles, k);
  return cudaGetLastError();
}

}  // namespace icee
