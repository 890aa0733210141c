// The column-split path of K1 (decode_step.cu) and K6 (att_decode_step.cu):
// one decode step for a few rows (one image's k <= 8 beam slots, the serial
// serving path) spread over every SM of the card.
//
// Why: at that shape every weight is read once for 5 rows (K1 ~32 MB, K6
// ~56 MB factored / ~45 MB lstm).  The row-tiled path (step_kernels.cuh)
// gives such a call one cell block and an 8-block head: a few hundred KB in
// flight, ~2% of the card's 3.35 TB/s, 0.85 ms for K6 factored.
//
// Design: each product's output columns are cut into slabs of 16 (one
// sub-slab of 4 columns per gate where a stage needs all four gates of a
// column), one block a slab, ~128 blocks a product.  A block streams its
// slab's weight rows into a ring of shared-memory chunks by cp.async (the
// ring's RING - 1 chunks, 40 KB, in flight before its inputs are even
// ready) and copies its input rows beside them; one thread per (row,
// column) runs the column's fmaf chain from shared memory.  A chain's k
// range is never split: every output is the same sequential fmaf chain in
// k order as dot4's (decode_common.cuh), -fmad=false, so a row's outputs
// are bit-identical to the row-tiled path's and to K2's and K7's, whatever
// the row count.  A chain cut at k = E (the embedding rows of x V_w or x
// W_ih, which do not wait on the attention) is stored as a float32 partial
// and resumed: the same bits.  Stages are separate launches chained by
// programmatic dependent launch: a stage issues its weight prefetch, lets
// the next launch start, and only then waits (griddepcontrol.wait) for the
// previous stage's outputs.  Nothing is written before that wait, and
// outputs of earlier stages are read through L2 (__ldcg, cp.async.cg).
//
// What bounds it then (scripts/probe_split_step.py: %globaltimer and
// clock64 stamps in each block; NVIDIA H100 80GB HBM3, 700.00 W): not
// bytes -- a block waits on its weight chunks for under 2% of its loop --
// but the chains' latency, 8-18 cycles a k step of one dependent fmaf (a
// bare register fmaf chain runs at ~5.4 alone), over ~4,300 sequential
// steps in K6 factored (x V_w alone is 2,348), plus ~2-5 us a stage for the
// dependency, the input rows' copy and the epilogue.  K6 factored takes
// ~0.085 ms of device time against its 0.017 ms bound (bytes); K1 ~0.040
// against 0.0095.
//
// Stages (launches):
//   K1: pre (x V_w + V_b, h W_w + W_b) -> style (v_g S_g + S_b) -> gates
//       (s_g U_g + U_b + hW, then the cell) -> logits -> reduce.
//   K6: pre (att2 = h dec_w + dec_b, h f_beta_w + f_beta_b, h W_w + W_b or
//       h W_hh, the embedding rows of x V_w or x W_ih) -> scores -> ctx
//       (softmax over P in every block, alpha feat, times the gate) ->
//       factored: vrows (the rest of x V_w) -> style -> gates; lstm:
//       gates (the rest of x W_ih, then the cell) -> logits -> reduce.
// The logits (R, V) go to device memory (160 KB at 5 rows, L2-resident);
// the reduce launch (a block a row) takes each 256-wide tile through
// tile_reduce and the row through merge_row, as the row-tiled path and K2
// and K7 do.
#pragma once

#include <map>
#include <mutex>
#include <utility>

#include "att_common.cuh"
#include "grid_common.cuh"

namespace icee {

constexpr int SPLIT_ROWS = KMAX;   // most rows the column-split path takes
constexpr int SPLIT_THREADS = 4 * 4 * SPLIT_ROWS;  // a thread a chain
static_assert(SPLIT_ROWS <= 8, "a block's 128 threads: 16 columns x 8 rows");
constexpr int SLAB_F4 = 4;         // float4s of a weight row a block streams
constexpr int CHUNK_ROWS = 128;    // weight rows per ring chunk (8 KB)
constexpr int CHUNK_FLOATS = CHUNK_ROWS * 4 * SLAB_F4;
constexpr int RING = 6;            // ring chunks of a block
constexpr int SCORE_WARPS = SPLIT_THREADS / 32;
constexpr int REDUCE_THREADS = 1024;  // a warp a vocab tile at V = 8192

enum Stage { PRE, CTX, VROWS, STYLE, GATES_F, GATES_L, LOGITS };

// Row stride of a block's shared copy of its products' input rows: 4 more
// than a multiple of 32 floats, so the rows of one k sit in distinct banks.
__host__ __device__ inline int split_kp(int K) { return ((K + 31) & ~31) + 4; }

// One product of the column-split path: for segments s < nseg and columns
// j < segw, out[r * ldo + s * segw + j] = (init at the same place, or 0) +
// sum_k A[r * lda + s * aseg + k] W[s * wseg + k * ldw + j], one fmaf chain
// in k order, then + bias[s * segw + j] where bias is not null.
struct Gemv {
  const float* W;
  const float* A;
  const float* init;
  const float* bias;
  float* out;
  int K, ldw, wseg, segw, nseg, lda, aseg, ldo;
};

constexpr int MAX_JOBS = 4;

struct SplitArgs {
  Gemv job[MAX_JOBS];
  int n_jobs, R;
  // gates: z = (acc + b1) + hw (factored) or ((acc + b1) + hw) + b2 (lstm)
  const float* b1;
  const float* hw;  // (R, 4H)
  const float* b2;
  const float* c_in;
  float* h_out;
  float* c_out;
  int H;
  // ctx: alpha = softmax(scores (R, P)); out = sigmoid(gpre) * (alpha feat)
  const float* scores;
  const float* gpre;
  float* alpha_out;
};

// Programmatic dependent launch (sm_90): let the next launch on the stream
// be scheduled / wait until the previous one has finished and its writes
// are visible.  Both are no-ops for a launch without the attribute.
__device__ __forceinline__ void pdl_launch_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Copies rows r < R of n_seg column segments of src (row stride lds,
// segment s at column (seg0 + s) * segoff, K floats each) into dst (row
// (s * R + r) at dst + (s * R + r) * ldd, ldd % 4 == 0, 16-byte aligned), a
// warp a row.  By cp.async where every source quad is 16-byte aligned
// (the caller then waits with cp_async_wait<0>), else by loads, a row's
// lanes in flight together; the caller syncs before reading dst.
__device__ __forceinline__ void stage_rows(float* dst, int ldd,
                                           const float* src, int lds,
                                           int segoff, int seg0, int n_seg,
                                           int R, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   ((lds | segoff | K) & 3) == 0;
  for (int row = warp; row < n_seg * R; row += n_warps) {
    const int g = row / R, r = row % R;
    const float* s = src + (size_t)r * lds + (size_t)(seg0 + g) * segoff;
    float* d = dst + row * ldd;
    if (vec) {
      for (int q = 4 * lane; q < K; q += 128) cp_async16(d + q, s + q);
    } else {
      for (int k = lane; k < K; k += 32) d[k] = __ldcg(s + k);
    }
  }
  cp_async_commit();
}

__host__ __device__ constexpr int stage_gates(Stage S) {
  return (S == GATES_F || S == GATES_L) ? 4 : 1;
}

// Blocks of one product: one per slab of 16 / G columns of G segments.
__host__ __device__ inline int slab_blocks(const Gemv& J, int G) {
  const int cw = 4 * SLAB_F4 / G;
  return (J.segw + cw - 1) / cw * (J.nseg / G);
}

// Shared floats a product's block needs: the ring, the input rows (one
// copy per segment where aseg != 0) and, for the gates, the z exchange.
__host__ __device__ inline int slab_smem_floats(const Gemv& J, int G, int R) {
  const int nch = (J.K + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const int slots = nch < RING ? nch : RING;
  const int n_a = J.aseg != 0 ? G : 1;
  return slots * CHUNK_FLOATS + n_a * R * split_kp(J.K) +
         (G == 4 ? 4 * R * 4 * SLAB_F4 / G : 0);
}

// One chunk's CHUNK_ROWS steps of a chain: acc = fmaf(a[k], w[k * 16],
// acc) in k order, a 16-byte aligned.  Unrolled whole, so the shared loads
// run ahead of the fmafs: alone, ~6.5 cycles a step against ~10.4 with a
// trip count known only at run time (scripts/probe_split_step.py; NVIDIA
// H100 80GB HBM3, 700.00 W).
__device__ __forceinline__ float chain_chunk(float acc, const float* a,
                                             const float* w) {
#pragma unroll
  for (int k = 0; k < CHUNK_ROWS; k += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + k);
    acc = fmaf(av.x, w[(k + 0) * 4 * SLAB_F4], acc);
    acc = fmaf(av.y, w[(k + 1) * 4 * SLAB_F4], acc);
    acc = fmaf(av.z, w[(k + 2) * 4 * SLAB_F4], acc);
    acc = fmaf(av.w, w[(k + 3) * 4 * SLAB_F4], acc);
  }
  return acc;
}

template <Stage S>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
slab_kernel(const SplitArgs a) {
  constexpr int G = stage_gates(S);
  constexpr int NQ = SLAB_F4 / G;  // column quads of a sub-slab
  constexpr int CW = 4 * NQ;       // columns of a sub-slab
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x, R = a.R;

  int b = blockIdx.x, jn = 0;
  while (jn + 1 < a.n_jobs && b >= slab_blocks(a.job[jn], G)) {
    b -= slab_blocks(a.job[jn], G);
    ++jn;
  }
  const Gemv J = a.job[jn];
  const int nbs = (J.segw + CW - 1) / CW;
  const int seg0 = (b / nbs) * G, j0 = (b % nbs) * CW;
  const int K = J.K, Kp = split_kp(K);
  const int nch = (K + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const int slots = nch < RING ? nch : RING;
  float* ring = smem;
  float* As = ring + slots * CHUNK_FLOATS;

  // chunk ch: weight rows [ch * CHUNK_ROWS, +CHUNK_ROWS) of the slab, as
  // (row, sub-slab, quad) float4s; quads past segw are not loaded
  auto issue = [&](int ch) {
    float* slot = ring + (ch % slots) * CHUNK_FLOATS;
    const int k0 = ch * CHUNK_ROWS;
    for (int i = tid; i < CHUNK_ROWS * SLAB_F4; i += nt) {
      const int kl = i / SLAB_F4, u = i % SLAB_F4;
      const int k = k0 + kl, j = j0 + 4 * (u % NQ);
      if (k < K && j < J.segw)
        cp_async16(slot + 4 * i, J.W + (size_t)(seg0 + u / NQ) * J.wseg +
                                     (size_t)k * J.ldw + j);
    }
  };
  for (int ch = 0; ch < RING - 1; ++ch) {
    if (ch < nch) issue(ch);
    cp_async_commit();
  }
  pdl_launch_next();
  pdl_wait();

  // the input rows into shared memory (ctx: the scores, then their softmax)
  if constexpr (S == CTX)
    stage_rows(As, Kp, a.scores, K, 0, 0, 1, R, K);
  else
    stage_rows(As, Kp, J.A, J.lda, J.aseg, seg0, J.aseg != 0 ? G : 1, R, K);
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (S == CTX)
    for (int r = tid >> 5; r < R; r += nt >> 5)
      softmax_row(As + r * Kp, K,
                  blockIdx.x == 0 ? a.alpha_out + (size_t)r * K : nullptr);

  // thread -> (sub-slab g, row r, column cl of the sub-slab): one chain
  // each, so a k step is one fmaf after two shared loads
  const bool active = tid < G * R * CW;
  const int g = active ? tid / (R * CW) : 0;
  const int r = active ? (tid / CW) % R : 0;
  const int cl = tid % CW;
  const int j = j0 + cl;
  const int col = (seg0 + g) * J.segw + j;
  const bool valid = active && j < J.segw;
  float acc = valid && J.init != nullptr
                  ? __ldcg(J.init + (size_t)r * J.ldo + col)
                  : 0.f;
  const float* as = As + ((J.aseg != 0 ? g : 0) * R + r) * Kp;

  for (int ch = 0; ch < nch; ++ch) {
    if (ch + RING - 1 < nch) issue(ch + RING - 1);
    cp_async_commit();
    cp_async_wait<RING - 1>();  // chunk ch has landed
    __syncthreads();
    if (valid) {
      // the chunk is (row, sub-slab, column) floats: 4 * SLAB_F4 a row
      const float* w = ring + (ch % slots) * CHUNK_FLOATS + g * CW + cl;
      const int k0 = ch * CHUNK_ROWS;
      const float* ak = as + k0;  // 16-byte aligned: Kp % 4 == 0
      if (K - k0 >= CHUNK_ROWS)
        acc = chain_chunk(acc, ak, w);
      else
        for (int kl = 0; kl < K - k0; ++kl)
          acc = fmaf(ak[kl], w[kl * 4 * SLAB_F4], acc);
    }
    __syncthreads();
  }

  if constexpr (S == GATES_F || S == GATES_L) {
    const int H = a.H;
    float* zs = As + (J.aseg != 0 ? G : 1) * R * Kp;  // (4, R, CW)
    if (valid) {
      const int o = g * H + j;
      float z = (acc + a.b1[o]) + __ldcg(a.hw + (size_t)r * 4 * H + o);
      if constexpr (S == GATES_L) z = z + a.b2[o];
      zs[(g * R + r) * CW + cl] = z;
    }
    __syncthreads();
    for (int i = tid; i < R * CW; i += nt) {
      const int rr = i / CW, jl = i % CW, jc = j0 + jl;
      if (jc >= H) continue;
      const float* z = zs + rr * CW + jl;
      const int zg = R * CW;  // stride between gates
      const float c = a.c_in[(size_t)rr * H + jc];
      float h_new, c_new;
      if constexpr (S == GATES_F) {  // [i, f, o, c], h = o * c
        const float i_t = sigmoid(z[0]), f_t = sigmoid(z[zg]);
        const float o_t = sigmoid(z[2 * zg]), g_t = tanhf(z[3 * zg]);
        c_new = f_t * c + i_t * g_t;
        h_new = o_t * c_new;
      } else {  // [i, f, g, o], h = o * tanh(c)
        const float i_t = sigmoid(z[0]), f_t = sigmoid(z[zg]);
        const float g_t = tanhf(z[2 * zg]), o_t = sigmoid(z[3 * zg]);
        c_new = f_t * c + i_t * g_t;
        h_new = o_t * tanhf(c_new);
      }
      a.c_out[(size_t)rr * H + jc] = c_new;
      a.h_out[(size_t)rr * H + jc] = h_new;
    }
  } else if constexpr (S == CTX) {
    if (valid) {
      const size_t o = (size_t)r * J.ldo + col;
      J.out[o] = sigmoid(__ldcg(a.gpre + o)) * acc;
    }
  } else if (valid) {
    J.out[(size_t)r * J.ldo + col] =
        J.bias != nullptr ? acc + J.bias[col] : acc;
  }
}

// scores[r * P + p] for every position: one warp a position (att_score),
// att2 (R, A) staged in shared memory.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_scores_kernel(const float* att2, AttWeights w,
                    const float* __restrict__ att1, float* scores, int R) {
  extern __shared__ __align__(16) float smem[];  // (R, A)
  pdl_launch_next();
  pdl_wait();
  stage_rows(smem, w.A, att2, w.A, 0, 0, 1, R, w.A);
  cp_async_wait<0>();
  __syncthreads();
  const int p = blockIdx.x * SCORE_WARPS + (threadIdx.x >> 5);
  if (p < w.P)  // whole warps
    att_score<SPLIT_ROWS>(att1 + (size_t)p * w.A, w, smem, w.A, R,
                          scores + p, w.P);
}

// One block a row: tile_reduce over each 256-wide tile of the row's logits
// (a warp a tile; columns past V hold NEG), then merge_row into the exact
// top-k and logp = value - logZ.
__global__ void __launch_bounds__(REDUCE_THREADS)
split_reduce_kernel(const float* logits, int V, int k, float* logp,
                    int* idx) {
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (V + VT - 1) / VT, nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* lt = smem + warp * VT;
  float* pm = smem + nw * VT;
  float* pse = pm + n_tiles;
  float* pv = pse + n_tiles;
  int* pi = reinterpret_cast<int*>(pv + n_tiles * k);
  const int r = blockIdx.x;
  pdl_wait();
  for (int t = warp; t < n_tiles; t += nw) {
    float v[VT / 32];
#pragma unroll
    for (int u = 0; u < VT / 32; ++u) {
      const int col = t * VT + lane + 32 * u;
      v[u] = col < V ? __ldcg(logits + (size_t)r * V + col) : NEG;
    }
#pragma unroll
    for (int u = 0; u < VT / 32; ++u) lt[lane + 32 * u] = v[u];
    __syncwarp();
    tile_reduce(lt, t * VT, k, pm + t, pse + t, pv + t * k, pi + t * k);
    __syncwarp();
  }
  __syncthreads();
  if (warp == 0)
    merge_row(pm, pse, pv, pi, n_tiles, k, logp + (size_t)r * k,
              idx + (size_t)r * k);
}

// --- host side ---------------------------------------------------------------

// Each kernel's dynamic shared-memory limit is raised once per device to
// the largest amount asked for so far (not on every launch: the call is a
// host round trip, and it may not run inside a CUDA graph capture).
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> granted;
  std::lock_guard<std::mutex> lock(mu);
  size_t& g = granted[{kernel, dev}];
  if (smem <= g) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) g = smem;
  return e;
}

// One launch on stream s; with pdl, programmatic stream serialization (the
// kernel may start before the previous launch ends and waits for it in
// griddepcontrol.wait).
template <class... KArgs, class... Args>
cudaError_t split_launch(void (*kernel)(KArgs...), int grid, int threads,
                         size_t smem, cudaStream_t s, bool pdl,
                         Args... args) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Shared memory (bytes) above what one block may use.
constexpr size_t SPLIT_SMEM_LIMIT = 232448;

template <Stage S>
cudaError_t launch_slab(SplitArgs a, cudaStream_t s, bool pdl) {
  constexpr int G = stage_gates(S);
  int blocks = 0, floats = 0;
  for (int i = 0; i < a.n_jobs; ++i) {
    if (a.job[i].nseg % G || a.job[i].K <= 0) return cudaErrorInvalidValue;
    blocks += slab_blocks(a.job[i], G);
    const int f = slab_smem_floats(a.job[i], G, a.R);
    floats = f > floats ? f : floats;
  }
  const size_t smem = sizeof(float) * (size_t)floats;
  if (smem > SPLIT_SMEM_LIMIT) return cudaErrorInvalidValue;
  return split_launch(slab_kernel<S>, blocks, SPLIT_THREADS, smem, s, pdl, a);
}

inline Gemv gemv(const float* W, int ldw, const float* A, int lda, int K,
                 int ncols, const float* bias, float* out, int ldo) {
  return Gemv{W, A, nullptr, bias, out, K, ldw, 0, ncols, 1, lda, 0, ldo};
}

// The logits and reduce launches (h_out (R, H) -> logp, idx).
inline cudaError_t launch_split_head(const float* h_out, const float* Cw,
                                     const float* Cb, int R, int H, int V,
                                     int ktop, float* logits, float* logp,
                                     int* idx, cudaStream_t s) {
  SplitArgs a = {};
  a.R = R;
  a.n_jobs = 1;
  a.job[0] = gemv(Cw, V, h_out, H, H, V, Cb, logits, V);
  cudaError_t e = launch_slab<LOGITS>(a, s, true);
  if (e != cudaSuccess) return e;
  const int n_tiles = (V + VT - 1) / VT;
  const size_t smem =
      sizeof(float) * ((REDUCE_THREADS / 32) * VT + n_tiles * (2 + 2 * ktop));
  if (smem > SPLIT_SMEM_LIMIT) return cudaErrorInvalidValue;
  return split_launch(split_reduce_kernel, R, REDUCE_THREADS, smem, s, true,
                      (const float*)logits, V, ktop, logp, idx);
}

// The factored cell's style and gates launches after v (R, 4F) and hwb =
// h W_w + W_b (R, 4H) are in place.
inline cudaError_t launch_split_factored_tail(const CellWeights& w,
                                              const float* v,
                                              const float* hwb,
                                              const float* c, float* s_buf,
                                              float* h_out, float* c_out,
                                              int R, cudaStream_t s) {
  const int F = w.F, H = w.H;
  SplitArgs a = {};
  a.R = R;
  a.n_jobs = 1;
  a.job[0] = Gemv{w.Sw, v, nullptr, w.Sb, s_buf, F, F, F * F, F, 4, 4 * F,
                  F, 4 * F};
  cudaError_t e = launch_slab<STYLE>(a, s, true);
  if (e != cudaSuccess) return e;
  a.job[0] = Gemv{w.Uw, s_buf, nullptr, nullptr, nullptr, F, H, F * H, H, 4,
                  4 * F, F, 4 * H};
  a.b1 = w.Ub;
  a.hw = hwb;
  a.c_in = c;
  a.h_out = h_out;
  a.c_out = c_out;
  a.H = H;
  return launch_slab<GATES_F>(a, s, true);
}

// Floats of the column-split path's work buffer.
inline long long split_k1_work(int R, int F, int H, int V) {
  return (long long)R * (4 * F + 4 * H + 4 * F + V);
}

// K1 on the column-split path (R <= SPLIT_ROWS): work holds v (R, 4F), hwb
// (R, 4H), s (R, 4F) and the logits (R, V).
inline cudaError_t launch_split_k1(const float* x, const float* h,
                                   const float* c, const CellWeights& w,
                                   const float* Cw, const float* Cb,
                                   float* h_out, float* c_out, float* logp,
                                   int* idx, float* work, int R, int V,
                                   int ktop, void* stream) {
  if (R < 1 || R > SPLIT_ROWS) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = w.E, F = w.F, H = w.H;
  float* v = work;
  float* hwb = v + (size_t)R * 4 * F;
  float* s_buf = hwb + (size_t)R * 4 * H;
  float* logits = s_buf + (size_t)R * 4 * F;
  SplitArgs a = {};
  a.R = R;
  a.n_jobs = 2;
  a.job[0] = gemv(w.Vw, 4 * F, x, E, E, 4 * F, w.Vb, v, 4 * F);
  a.job[1] = gemv(w.Ww, 4 * H, h, H, H, 4 * H, w.Wb, hwb, 4 * H);
  cudaError_t e = launch_slab<PRE>(a, s, false);
  if (e != cudaSuccess) return e;
  e = launch_split_factored_tail(w, v, hwb, c, s_buf, h_out, c_out, R, s);
  if (e != cudaSuccess) return e;
  return launch_split_head(h_out, Cw, Cb, R, H, V, ktop, logits, logp, idx,
                           s);
}

// Floats of K6's column-split work buffer (F = H for the lstm cell).
inline long long split_att_work(bool factored, int R, int F, int H, int V,
                                int A, int P, int FS) {
  const long long common = (long long)R * (A + 2 * FS + P + V);
  return common + (factored ? (long long)R * (4 * H + 3 * 4 * F)
                            : (long long)R * 2 * 4 * H);
}

// The attention launches shared by both cells: pre (att2, the gate's
// pre-activation gpre, and the cell's own h and embedding products given in
// cell_jobs), scores, ctx.  x_ctx (R, FS) = sigmoid(gpre) * (alpha feat).
inline cudaError_t launch_split_attend(const AttWeights& aw,
                                       const float* feats, const float* att1,
                                       const float* h, const Gemv* cell_jobs,
                                       float* att2, float* gpre,
                                       float* scores, float* x_ctx,
                                       float* alpha, int R, cudaStream_t s) {
  const int H = aw.H, A = aw.A, P = aw.P, FS = aw.FS;
  SplitArgs a = {};
  a.R = R;
  a.n_jobs = 4;
  a.job[0] = gemv(aw.decw, A, h, H, H, A, aw.decb, att2, A);
  a.job[1] = gemv(aw.fbw, FS, h, H, H, FS, aw.fbb, gpre, FS);
  a.job[2] = cell_jobs[0];
  a.job[3] = cell_jobs[1];
  cudaError_t e = launch_slab<PRE>(a, s, false);
  if (e != cudaSuccess) return e;
  e = split_launch(split_scores_kernel, (P + SCORE_WARPS - 1) / SCORE_WARPS,
                   SPLIT_THREADS, sizeof(float) * R * A, s, true,
                   (const float*)att2, aw, att1, scores, R);
  if (e != cudaSuccess) return e;
  SplitArgs c = {};
  c.R = R;
  c.n_jobs = 1;
  c.job[0] = gemv(feats, FS, nullptr, 0, P, FS, nullptr, x_ctx, FS);
  c.scores = scores;
  c.gpre = gpre;
  c.alpha_out = alpha;
  return launch_slab<CTX>(c, s, true);
}

// K6 on the column-split path: one image's R = k <= SPLIT_ROWS rows.
inline cudaError_t launch_split_att(const float* x, const float* h,
                                    const float* c, const float* feats,
                                    const float* att1, const AttWeights& aw,
                                    const CellWeights& w, const float* Cw,
                                    const float* Cb, float* h_out,
                                    float* c_out, float* logp, int* idx,
                                    float* alpha, float* work, int R, int E,
                                    int V, int ktop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int F = w.F, H = w.H, FS = aw.FS;
  float* att2 = work;
  float* gpre = att2 + (size_t)R * aw.A;
  float* scores = gpre + (size_t)R * FS;
  float* x_ctx = scores + (size_t)R * aw.P;
  float* logits = x_ctx + (size_t)R * FS;
  float* hwb = logits + (size_t)R * V;
  float* vpart = hwb + (size_t)R * 4 * H;
  float* v = vpart + (size_t)R * 4 * F;
  float* s_buf = v + (size_t)R * 4 * F;
  const Gemv cell_jobs[2] = {
      gemv(w.Ww, 4 * H, h, H, H, 4 * H, w.Wb, hwb, 4 * H),
      gemv(w.Vw, 4 * F, x, E, E, 4 * F, nullptr, vpart, 4 * F)};
  cudaError_t e = launch_split_attend(aw, feats, att1, h, cell_jobs, att2,
                                      gpre, scores, x_ctx, alpha, R, s);
  if (e != cudaSuccess) return e;
  SplitArgs a = {};
  a.R = R;
  a.n_jobs = 1;
  a.job[0] = gemv(w.Vw + (size_t)E * 4 * F, 4 * F, x_ctx, FS, FS, 4 * F,
                  w.Vb, v, 4 * F);
  a.job[0].init = vpart;
  e = launch_slab<VROWS>(a, s, true);
  if (e != cudaSuccess) return e;
  e = launch_split_factored_tail(w, v, hwb, c, s_buf, h_out, c_out, R, s);
  if (e != cudaSuccess) return e;
  return launch_split_head(h_out, Cw, Cb, R, H, V, ktop, logits, logp, idx,
                           s);
}

inline cudaError_t launch_split_att(const float* x, const float* h,
                                    const float* c, const float* feats,
                                    const float* att1, const AttWeights& aw,
                                    const LstmWeights& w, const float* Cw,
                                    const float* Cb, float* h_out,
                                    float* c_out, float* logp, int* idx,
                                    float* alpha, float* work, int R, int E,
                                    int V, int ktop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H = w.H, FS = aw.FS;
  float* att2 = work;
  float* gpre = att2 + (size_t)R * aw.A;
  float* scores = gpre + (size_t)R * FS;
  float* x_ctx = scores + (size_t)R * aw.P;
  float* logits = x_ctx + (size_t)R * FS;
  float* hh = logits + (size_t)R * V;
  float* xwpart = hh + (size_t)R * 4 * H;
  const Gemv cell_jobs[2] = {
      gemv(w.Whh, 4 * H, h, H, H, 4 * H, nullptr, hh, 4 * H),
      gemv(w.Wih, 4 * H, x, E, E, 4 * H, nullptr, xwpart, 4 * H)};
  cudaError_t e = launch_split_attend(aw, feats, att1, h, cell_jobs, att2,
                                      gpre, scores, x_ctx, alpha, R, s);
  if (e != cudaSuccess) return e;
  SplitArgs a = {};
  a.R = R;
  a.n_jobs = 1;
  // W_ih's rows E.. as four gate segments of H columns, resumed from the
  // embedding rows' partial sums
  a.job[0] = Gemv{w.Wih + (size_t)E * 4 * H, x_ctx, xwpart, nullptr, nullptr,
                  FS, 4 * H, H, H, 4, FS, 0, 4 * H};
  a.b1 = w.bih;
  a.hw = hh;
  a.b2 = w.bhh;
  a.c_in = c;
  a.h_out = h_out;
  a.c_out = c_out;
  a.H = H;
  e = launch_slab<GATES_L>(a, s, true);
  if (e != cudaSuccess) return e;
  return launch_split_head(h_out, Cw, Cb, R, H, V, ktop, logits, logp, idx,
                           s);
}

}  // namespace icee
