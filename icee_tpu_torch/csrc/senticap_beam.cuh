// The SentiCap beam searches' device functions, shared by K9
// (senticap_beam.cu, the base mRNN) and K10 (senticap_switched_beam.cu, the
// switched two-LSTM model).  Both compute
// jax.vmap(senticap/beam.py::make_device_beam(...).run) element for element.
//
// Rows r = image * beam + slot.  A model with P paths (1 for the base
// model, 2 for the switched one: background, then sentiment) keeps each
// path's state as its own (R, .) block: xh (P, R, E + H) holds [x; h] for
// the cells, c, hn, cn (P, R, H), z (P, R, 4H), logits (P, R, V).  The
// search state is per row: seqs (R, L), lp (R,) and, with a trace, trace
// (R, L); the results per image start as the all-stop sequence of length 1
// with an infinite score (and a zero trace).
//
//   sb_prepare_kernel     once a call: a weight W (K, N) laid out for the
//                         products, k-contiguous and split into TF32 hi / lo
//                         planes (below);
//   sb_product_kernel     the cell's [x; h] W and the head's h W + b at
//                         float32 accuracy on the tensor cores (3xTF32),
//                         every path in one launch (blockIdx.z);
//   sb_gates_kernel       one thread per cell element: gates [i, f, o, c],
//                         c' = f c + i g, h' = o c' (no tanh);
//   sb_row_topk_kernel    one block per row: the row's logits read once
//                         into shared memory, the exact softmax of one head
//                         (MIX = false) or the DA_SUM mixture of two,
//                         (1 - att) (e_o / se_o) + att (e_n / se_n) in that
//                         operation order (MIX = true, with K10's switch
//                         gate att computed first by one warp), then nll =
//                         -log2(p + 1e-37) and the beam lowest (nll, token)
//                         pairs, ties to the lowest token: every token with
//                         p < ~1e-38 sits on the same plateau, so the rank
//                         is by nll then index, never by logit
//                         (sb_select_row, below);
//   sb_select_kernel      one block per image: the beam^2 candidate totals
//                         lp[parent] + nll; the best completed one (token 0
//                         or the last step) by lp / (t + 1), lowest
//                         candidate index among equals (a block-wide
//                         argmin), replaces the running best only if
//                         strictly lower; the survivors are the beam
//                         lowest totals among the others, ties to the
//                         lowest candidate index
//                         (ranks by counting, no sort); then every path's
//                         h, c, the sequences (and the trace, whose [t] is
//                         the gate of the parent row at this step: the gate
//                         of the step that emitted the token) are gathered
//                         from each survivor's parent and the next word
//                         embedded per path.
// Where a row or an image does not fit one block's shared memory (beam
// above TOPK_THREADS = 256 or V past the row block, ~28,800 for K10; beam
// above ~160 for the selection's beam^2 candidates), the same functions
// run from device memory (the plan's topk_wide / select_wide, a scratch
// of wide_floats the wrapper allocates):
//   sb_row_topk_dev_kernel  the same softmax and nll keys, in place of the
//                         row's logits in device memory, then the beam
//                         least (key, token) pairs by wide_topk.cuh's
//                         block_select (a radix select; above KWIDE its
//                         survivors in the scratch): the same pairs in the
//                         same order as sb_select_row;
//   sb_select_kernel<WIDE> the candidates, old sequences and traces and
//                         the survivors' state in the scratch, the
//                         survivors by block_select of the (total,
//                         candidate) pairs: the same order as the counted
//                         ranks (-0 counted as +0).
// So a beam that both paths take gives the same bits on either.
// No atomics touch data: a search gives the same bits on every run.
//
// The products (planes_product.cuh, shared with K3 and K8): each weight is
// laid out once a call as TF32 hi / lo planes (sb_prepare_kernel) and every
// step's products are 3xTF32 wgmma from them (sb_product_kernel); that
// header says how and why.  Waves: K9's cell (M = 1,280, N = 2,048) is 320
// tiles against 264 two-block slots, a second wave 21% full; cut into two
// k ranges (splits 2, the launch plan's choice,
// ops/senticap_decode.py::launch_plan) it is 640 half-depth units in three
// waves 81% full, the gates kernel adding the two partial sums in range
// order.
#pragma once

#include <math.h>

#include "planes_product.cuh"  // the products (sb_product, sb_prepare)
#include "scan_step.cuh"    // ICEE_TRY
#include "wide_topk.cuh"    // block_select

namespace icee {

constexpr int TOPK_THREADS = 256;
constexpr int TOPK_WARPS = TOPK_THREADS / 32;
constexpr int SEL_THREADS = 512;
constexpr long long SB_SMEM_LIMIT = 232448;  // bytes one block may use

__device__ __forceinline__ float sb_sigm(float z) {
  return 1.f / (1.f + expf(-z));
}

// (v, i) < (w, j) in the order (value, then index).
__device__ __forceinline__ bool lex_less(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// ---- the launch plan -------------------------------------------------------

// The host's plan of one search (ops/senticap_decode.py::launch_plan, whose
// ctypes mirror is _CPlan; the C entry points re-derive every size and
// refuse a plan that differs).
struct SbPlan {
  long long cell_planes;  // floats of one path's prepared w_lstm
  long long head_planes;  // floats of one path's prepared w
  long long topk_smem;    // bytes of one row top-k block
  long long select_smem;  // bytes of one selection block
  int cell_splits;        // k ranges of the cell product (1 or 2; the
                          // head adds a bias: one)
  int cell_kp, head_kp;   // the products' padded depths
  int topk_cap;           // survivor slots of one row
  int paths;
  int topk_wide;          // the row pass from device memory
  int select_wide;        // the selection from device memory
  long long wide_floats;  // floats of the wide passes' scratch
};

// Shared memory of one selection block (bytes).
inline long long sb_select_smem(int beam, int max_len, bool with_trace) {
  const long long K2 = (long long)beam * beam, L = max_len + 1;
  return 4 * (2 * K2 + 3 * (long long)beam + beam * L * (with_trace ? 2 : 1));
}

// Survivor slots of a row: the K threads whose least pair is at most the
// threshold hold every survivor, at most ceil(V / TOPK_THREADS) each
// (sb_select_row); even, so that the rows after it stay 16-byte aligned.
inline int sb_topk_cap(int V, int K) {
  const int c = K * ((V + TOPK_THREADS - 1) / TOPK_THREADS);
  return c + (c & 1);
}

// Shared memory of one row top-k block (bytes): the warps' sorted minima,
// then one path: the survivors, the row; two paths: the rows, the second
// (dead once the mixture is formed) shared with the survivors, so that
// three blocks fit an SM at V = 8800.
inline long long sb_topk_smem(int V, int K, int paths) {
  const long long cand = 8LL * sb_topk_cap(V, K);
  if (paths == 1) return 8LL * TOPK_THREADS + cand + 4LL * V;
  const long long second = 4LL * V > cand ? 4LL * V : cand;
  return 8LL * TOPK_THREADS + 4LL * sp_round_up(V, 4) + second;
}

// Whether the row pass runs from device memory: a beam above its
// threads, or a block over the limit.
inline bool sb_topk_wide(int V, int K, int paths) {
  return K > TOPK_THREADS || sb_topk_smem(V, K, paths) > SB_SMEM_LIMIT;
}

// Whether the selection runs from device memory.
inline bool sb_select_wide(int beam, int max_len, bool with_trace) {
  return sb_select_smem(beam, max_len, with_trace) > SB_SMEM_LIMIT;
}

// Floats of the device-memory row pass's survivors: a row's beam pairs
// above KWIDE, else none.
inline long long sb_topk_wide_floats(long long R, int K) {
  return K > KWIDE ? 2 * R * K : 0;
}

// Floats of one image's part of the device-memory selection's scratch:
// the survivors' pairs (above KWIDE), the beam^2 totals and tokens, the
// old sequences (and traces), the new scores, parents and words; even, so
// that each image's pairs stay 8-byte aligned.
__host__ __device__ inline long long sb_select_wide_floats(int beam,
                                                          int max_len,
                                                          bool with_trace) {
  const long long K2 = (long long)beam * beam, L = max_len + 1;
  const long long f = (beam > KWIDE ? 2LL * beam : 0) + 2 * K2 +
                      beam * L * (with_trace ? 2 : 1) + 3LL * beam;
  return f + (f & 1);
}

// Floats of a search's wide scratch: the row pass's survivors, then each
// image's selection part.
inline long long sb_wide_floats(int n_img, int beam, int V, int max_len,
                                int paths) {
  const long long R = (long long)n_img * beam;
  return (sb_topk_wide(V, beam, paths) ? sb_topk_wide_floats(R, beam) : 0) +
         (sb_select_wide(beam, max_len, paths == 2)
              ? n_img * sb_select_wide_floats(beam, max_len, paths == 2)
              : 0);
}

// 0 where the plan is the one this source derives for the shapes.
inline int sb_check_plan(const SbPlan& p, int n_img, int beam, int E, int H,
                         int V, int max_len, int paths) {
  const int ck = sp_round_up(E + H, SP_BK), hk = sp_round_up(H, SP_BK);
  const bool ok =
      p.paths == paths && p.cell_kp == ck && p.head_kp == hk &&
      p.cell_planes == (long long)sp_round_up(4 * H, SP_NP) * 2 * ck &&
      p.head_planes == (long long)sp_round_up(V, SP_NP) * 2 * hk &&
      (p.cell_splits == 1 || p.cell_splits == 2) &&
      p.topk_cap == sb_topk_cap(V, beam) &&
      p.topk_smem == sb_topk_smem(V, beam, paths) &&
      p.select_smem == sb_select_smem(beam, max_len, paths == 2) &&
      p.topk_wide == (int)sb_topk_wide(V, beam, paths) &&
      p.select_wide == (int)sb_select_wide(beam, max_len, paths == 2) &&
      p.wide_floats == sb_wide_floats(n_img, beam, V, max_len, paths) &&
      beam >= 1 && beam <= V && (long long)beam * beam <= 0x7fffffffLL;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// ---- the step's element-wise and row passes --------------------------------

// x0 (P, n_img, E) -> xh's x columns for every beam slot, h = c = 0; the
// search state and the results as above.  trace and att_trace may be null.
__global__ void sb_init_kernel(const float* __restrict__ x0, float* xh,
                               float* c, int* seqs, float* lp, int* tok,
                               int* len, float* score, float* trace,
                               float* att_trace, int n_img, int beam, int E,
                               int H, int L, int stop, int paths) {
  const long long R = (long long)n_img * beam, W = E + H;
  const long long PR = paths * R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long i = i0; i < PR * W; i += stride) {
    const long long r = i / W, col = i % W;
    const long long path = r / R, img = (r % R) / beam;
    xh[i] = col < E ? x0[(path * n_img + img) * E + col] : 0.f;
  }
  for (long long i = i0; i < PR * H; i += stride) c[i] = 0.f;
  for (long long i = i0; i < R * L; i += stride) {
    seqs[i] = stop;
    if (trace) trace[i] = 0.f;
  }
  for (long long i = i0; i < R; i += stride)
    lp[i] = (i % beam) == 0 ? 0.f : INFINITY;
  for (long long i = i0; i < (long long)n_img * L; i += stride) {
    tok[i] = stop;
    if (att_trace) att_trace[i] = 0.f;
  }
  for (long long i = i0; i < n_img; i += stride) {
    len[i] = 1;
    score[i] = INFINITY;
  }
}

// z (R, 4H) pre-activations (with splits 2, the sum of the partial sums
// z and z + zs, in that order), c (R, H) -> hn, cn (R, H).
__global__ void sb_gates_kernel(const float* __restrict__ z, long long zs,
                                int splits, const float* __restrict__ c,
                                float* hn, float* cn, long long R, int H) {
  const long long n = R * H;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / H;
    const int j = (int)(i % H);
    const float* zr = z + r * 4 * H;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      g[q] = zr[q * H + j];
      if (splits > 1) g[q] = __fadd_rn(g[q], zr[zs + q * H + j]);
    }
    const float ig = sb_sigm(g[0]);
    const float fg = sb_sigm(g[1]);
    const float og = sb_sigm(g[2]);
    const float cc = fg * c[i] + ig * tanhf(g[3]);
    cn[i] = cc;
    hn[i] = og * cc;  // no tanh: reference quirk
  }
}

// Block-wide reduction of R values a thread (max or sum): a fixed shuffle
// tree in each warp, then the warps' results in warp order, so the same
// inputs give the same bits; two barriers whatever R.
template <int R>
__device__ __forceinline__ void tk_block_reduce(float (&v)[R], bool is_max,
                                                float (*red)[TOPK_WARPS]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v[r], o);
      v[r] = is_max ? fmaxf(v[r], w) : v[r] + w;
    }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) red[r][warp] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float t = red[r][0];
    for (int q = 1; q < TOPK_WARPS; ++q)
      t = is_max ? fmaxf(t, red[r][q]) : t + red[r][q];
    v[r] = t;
  }
}

// An nll value as an order-preserving key (unsigned <, the order of float
// <, with -0 counted as +0) and back (-0 comes back as +0).
__device__ __forceinline__ unsigned sb_key(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float sb_unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (key, token) as one 64-bit value in the order (nll, then token).
__device__ __forceinline__ unsigned long long sb_pair(unsigned key, int c) {
  return ((unsigned long long)key << 32) | (unsigned)c;
}

// The pair above every pair of a row, distinct for each thread.
__device__ __forceinline__ unsigned long long sb_sentinel(int V) {
  return sb_pair(0xffffffffu, V + threadIdx.x);
}

// The K <= TOPK_THREADS least (nll, token) pairs of one row, in order, from
// its nll keys (V,) in shared memory and m, this thread's least pair over
// its tokens c = tid + i T (sb_sentinel where it has none), into out_nll /
// out_tok (K,), by a threshold and an exact order of the survivors:
//   1. tau, the K-th least of the T minima: each warp sorts its 32 minima
//      (a bitonic network over shuffles), and each minimum's rank is its
//      place in its warp plus a binary search in each other warp's run;
//   2. the survivors, every pair <= tau: at least K (the K threads whose
//      minimum is <= tau), at most K ceil(V / T) (only those threads hold
//      one), gathered in thread order by a block-wide prefix sum;
//   3. each survivor's rank among the survivors by counting; the K lowest
//      are written in rank order.
// With the pass that found the minima, the row's keys are read three
// times.  Pairs are distinct (the token), so every rank is exact and the
// result is a stable sort's first K, ties to the lowest token; no atomics.
// runs: T pairs, cand: sb_topk_cap(V, K) pairs, scan: TOPK_WARPS ints.
__device__ void sb_select_row(const unsigned* keys, int V, int K,
                              unsigned long long m, unsigned long long* runs,
                              unsigned long long* cand, int* scan,
                              unsigned long long* tau_sh, float* out_nll,
                              int* out_tok) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long p = __shfl_xor_sync(0xffffffffu, m, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      m = keep_min ? (p < m ? p : m) : (p < m ? m : p);
    }
  runs[tid] = m;
  __syncthreads();
  int rank = lane;
  for (int w = 0; w < TOPK_WARPS; ++w) {
    if (w == warp) continue;
    const unsigned long long* run = runs + 32 * w;
    int pos = 0;   // the entries of the run below m
#pragma unroll
    for (int s = 32; s > 0; s >>= 1)
      if (pos + s <= 32 && run[pos + s - 1] < m) pos += s;
    rank += pos;
  }
  if (rank == K - 1) *tau_sh = m;
  __syncthreads();
  const unsigned long long tau = *tau_sh;
  const unsigned tau_key = (unsigned)(tau >> 32);
  int n = 0;
  for (int c = tid; c < V; c += TOPK_THREADS) {
    const unsigned k = keys[c];
    n += k <= tau_key && sb_pair(k, c) <= tau;
  }
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int off = incl - n, total = 0;
  for (int w = 0; w < TOPK_WARPS; ++w) {
    if (w < warp) off += scan[w];
    total += scan[w];
  }
  for (int c = tid; c < V && n > 0; c += TOPK_THREADS) {
    const unsigned k = keys[c];
    if (k <= tau_key && sb_pair(k, c) <= tau) {
      cand[off++] = sb_pair(k, c);
      --n;
    }
  }
  __syncthreads();
  for (int i = tid; i < total; i += TOPK_THREADS) {
    const unsigned long long x = cand[i];
    int r = 0;
    for (int j = 0; j < total; ++j) r += cand[j] < x;
    if (r < K) {
      out_nll[r] = sb_unkey((unsigned)(x >> 32));
      out_tok[r] = (int)(x & 0xffffffffull);
    }
  }
}

// A row of V floats from global memory into shared memory, 16 bytes a copy
// where V % 4 == 0 (the row then starts 16-byte aligned).
__device__ __forceinline__ void tk_load_row(const float* __restrict__ src,
                                            float* dst, int V) {
  if ((V & 3) == 0) {
    for (int i = threadIdx.x; i < V / 4; i += TOPK_THREADS)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < V; i += TOPK_THREADS) dst[i] = src[i];
  }
}

// Warp 0: K10's switch gate of row r0, att[r0] = sigmoid(hn_o[r0] . aw[:H]
// + hn_n[r0] . aw[H:] + ab), lanes strided over H and a tree; into *a_sh
// too.
__device__ __forceinline__ void sb_gate(const float* __restrict__ hn,
                                        const float* __restrict__ aw,
                                        const float* __restrict__ ab,
                                        float* att, long long R, long long r0,
                                        int H, float* a_sh) {
  const int tid = threadIdx.x;
  const float* ho = hn + r0 * H;
  const float* hs = hn + (R + r0) * H;
  float s = 0.f;
  for (int j = tid; j < H; j += 32) s += ho[j] * aw[j];
  for (int j = tid; j < H; j += 32) s += hs[j] * aw[H + j];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (tid == 0) {
    *a_sh = sb_sigm(s + ab[0]);
    att[r0] = *a_sh;
  }
}

// A row's nll keys in place of `row` (V floats; with MIX the second
// head's row_n, mixed by the gate a): the max m; e = exp(l - m) in place
// and its sum se; p = e / se (MIX: (1 - a) (e_o / se_o) + a (e_n /
// se_n)), nll = -log2(p + 1e-37) as its key.  Every thread's sums run
// over its tokens c = tid + i T in order, then the fixed block reduction.
// -> this thread's least (key, token) pair (sb_sentinel where it has
// none).  Every thread of the block must call it.
template <bool MIX>
__device__ __forceinline__ unsigned long long sb_row_keys(
    float* row, float* row_n, int V, float a, float (*red)[TOPK_WARPS]) {
  constexpr int P = MIX ? 2 : 1;
  const int tid = threadIdx.x;
  float m[P], se[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float* l = p ? row_n : row;
    m[p] = -INFINITY;
    for (int c = tid; c < V; c += TOPK_THREADS) m[p] = fmaxf(m[p], l[c]);
  }
  tk_block_reduce<P>(m, true, red);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float* l = p ? row_n : row;
    se[p] = 0.f;
    for (int c = tid; c < V; c += TOPK_THREADS) {
      const float e = expf(l[c] - m[p]);
      l[c] = e;
      se[p] += e;
    }
  }
  tk_block_reduce<P>(se, false, red);
  unsigned* keys = reinterpret_cast<unsigned*>(row);
  unsigned long long least = sb_sentinel(V);
  const float one_m_a = 1.f - a;
  for (int c = tid; c < V; c += TOPK_THREADS) {
    float p;
    if (MIX)
      p = one_m_a * (row[c] / se[0]) + a * (row_n[c] / se[MIX ? 1 : 0]);
    else
      p = row[c] / se[0];
    const unsigned k = sb_key(-log2f(p + 1e-37f));
    keys[c] = k;
    const unsigned long long x = sb_pair(k, c);
    least = x < least ? x : least;
  }
  return least;
}

// One block per row r < R of logits (R, V) (with MIX, of the two heads'
// logits (2, R, V), mixed by the switch gate att[r], which warp 0 computes
// first (sb_gate); hn (2, R, H)): the row(s) read once into shared memory,
// the nll keys in place (sb_row_keys), then the K smallest (nll, token)
// pairs in order into top_nll / top_tok (R, K) (sb_select_row).  Shared
// memory: sb_topk_smem(V, K, MIX ? 2 : 1) bytes.
template <bool MIX>
__global__ void __launch_bounds__(TOPK_THREADS)
sb_row_topk_kernel(const float* __restrict__ logits,
                   const float* __restrict__ hn,
                   const float* __restrict__ aw,
                   const float* __restrict__ ab, float* att, long long R,
                   int V, int H, int K, int cap, float* top_nll,
                   int* top_tok) {
  constexpr int P = MIX ? 2 : 1;
  extern __shared__ __align__(16) unsigned long long tk_sm[];
  unsigned long long* runs = tk_sm;                     // (T,)
  // one path: survivors (cap,), row (V,); two: rows at 0 and Vp, the
  // survivors over the second once it is dead (sb_topk_smem)
  const int vp = MIX ? (V + 3) / 4 * 4 : 0;
  unsigned long long* cand =
      MIX ? reinterpret_cast<unsigned long long*>(
                reinterpret_cast<float*>(runs + TOPK_THREADS) + vp)
          : runs + TOPK_THREADS;
  float* row = MIX ? reinterpret_cast<float*>(runs + TOPK_THREADS)
                   : reinterpret_cast<float*>(cand + cap);
  float* row_n = row + vp;
  __shared__ float red[2][TOPK_WARPS];
  __shared__ int scan[TOPK_WARPS];
  __shared__ unsigned long long tau;
  __shared__ float a_sh;
  const int tid = threadIdx.x;
  const long long r0 = blockIdx.x;
#pragma unroll
  for (int p = 0; p < P; ++p) tk_load_row(logits + (p * R + r0) * V,
                                          p ? row_n : row, V);
  if (MIX && tid < 32) sb_gate(hn, aw, ab, att, R, r0, H, &a_sh);
  __syncthreads();
  const unsigned long long least =
      sb_row_keys<MIX>(row, row_n, V, MIX ? a_sh : 0.f, red);
  __syncthreads();
  sb_select_row(reinterpret_cast<unsigned*>(row), V, K, least, runs, cand,
                scan, &tau, top_nll + r0 * K, top_tok + r0 * K);
}

// sb_row_topk_kernel from device memory (the plan's topk_wide): the same
// keys, in place of the row's logits (logits (P, R, V), row r0 of path
// 0), then the K least (key, token) pairs by block_select (SCAN: K >
// KWIDE, the survivors in cand + r0 K): the same pairs, in the same order,
// as sb_select_row gives.
template <bool MIX, bool SCAN>
__global__ void __launch_bounds__(TOPK_THREADS)
sb_row_topk_dev_kernel(float* logits, const float* __restrict__ hn,
                       const float* __restrict__ aw,
                       const float* __restrict__ ab, float* att, long long R,
                       int V, int H, int K, float* top_nll, int* top_tok,
                       unsigned long long* cand) {
  __shared__ float red[2][TOPK_WARPS];
  __shared__ float a_sh;
  __shared__ TopkScratch ts;
  const long long r0 = blockIdx.x;
  float* row = logits + r0 * V;
  float* row_n = logits + (R + r0) * V;
  if (MIX && threadIdx.x < 32) sb_gate(hn, aw, ab, att, R, r0, H, &a_sh);
  __syncthreads();
  sb_row_keys<MIX>(row, row_n, V, MIX ? a_sh : 0.f, red);
  __syncthreads();
  const unsigned* keys = reinterpret_cast<const unsigned*>(row);
  float* out_nll = top_nll + r0 * K;
  int* out_tok = top_tok + r0 * K;
  block_select<SCAN>(
      V, K, [&](int c) { return keys[c]; }, &ts,
      [&](int q, int c) {
        out_nll[q] = sb_unkey(keys[c]);
        out_tok[q] = c;
      },
      SCAN ? cand + r0 * K : nullptr);
}

// sb_select_row alone on given rows nll (R, V) (the card's test of the
// selection against its plain emulation).
__global__ void __launch_bounds__(TOPK_THREADS)
sb_row_select_kernel(const float* __restrict__ nll_rows, int V, int K,
                     int cap, float* top_nll, int* top_tok) {
  extern __shared__ __align__(16) unsigned long long tk_sm[];
  unsigned long long* runs = tk_sm;
  unsigned long long* cand = runs + TOPK_THREADS;
  unsigned* keys = reinterpret_cast<unsigned*>(cand + cap);
  __shared__ int scan[TOPK_WARPS];
  __shared__ unsigned long long tau;
  const long long r0 = blockIdx.x;
  unsigned long long least = sb_sentinel(V);
  for (int c = threadIdx.x; c < V; c += TOPK_THREADS) {
    const unsigned k = sb_key(nll_rows[r0 * V + c]);
    keys[c] = k;
    const unsigned long long x = sb_pair(k, c);
    least = x < least ? x : least;
  }
  __syncthreads();
  sb_select_row(keys, V, K, least, runs, cand, scan, &tau, top_nll + r0 * K,
                top_tok + r0 * K);
}

// sb_row_select_kernel from device memory (K above TOPK_THREADS, or V past
// the block): block_select of the (key, token) pairs read from nll_rows
// (SCAN: the survivors in cand + r0 K).
template <bool SCAN>
__global__ void __launch_bounds__(TOPK_THREADS)
sb_row_select_dev_kernel(const float* __restrict__ nll_rows, int V, int K,
                         float* top_nll, int* top_tok,
                         unsigned long long* cand) {
  __shared__ TopkScratch ts;
  const long long r0 = blockIdx.x;
  const float* row = nll_rows + r0 * V;
  block_select<SCAN>(
      V, K, [&](int c) { return sb_key(row[c]); }, &ts,
      [&](int q, int c) {
        top_nll[r0 * K + q] = sb_unkey(sb_key(row[c]));
        top_tok[r0 * K + q] = c;
      },
      SCAN ? cand + r0 * K : nullptr);
}

// One block per image: candidate totals, best completed, survivors, then
// the next step's [x; h], c of each of the PATHS paths (emb[p] the path's
// word embedding (V, E)), the sequences and scores; with TRACE also the
// traces, from att (R,), the gate each row computed at this step.  WIDE:
// the image's arrays in its part of `wide` (sb_select_wide_floats), the
// survivors by block_select (SCAN: beam > KWIDE, their pairs there too).
template <int PATHS, bool TRACE, bool WIDE = false, bool SCAN = false>
__global__ void __launch_bounds__(SEL_THREADS)
sb_select_kernel(const float* __restrict__ top_nll,
                 const int* __restrict__ top_tok, const float* __restrict__ hn,
                 const float* __restrict__ cn, const float* __restrict__ emb0,
                 const float* __restrict__ emb1, const float* __restrict__ att,
                 float* xh, float* c, int* seqs, float* lp, float* trace,
                 int* tok, int* len, float* score, float* att_trace,
                 long long R, int beam, int E, int H, int L, int t,
                 int max_len, int stop, float* wide) {
  extern __shared__ float sm[];
  const int K2 = beam * beam;
  const long long img = blockIdx.x, r0 = img * beam;
  unsigned long long* gcand = nullptr;
  float* base = sm;
  if (WIDE) {
    base = wide + img * sb_select_wide_floats(beam, L - 1, TRACE);
    if (SCAN) {
      gcand = reinterpret_cast<unsigned long long*>(base);
      base += 2 * beam;
    }
  }
  float* tot = base;                                // (K2,)
  float* slp = tot + K2;                            // (beam,) new scores
  int* ctok = reinterpret_cast<int*>(slp + beam);   // (K2,)
  int* sseq = ctok + K2;                            // (beam, L) old sequences
  int* par = sseq + beam * L;                       // (beam,)
  int* wrd = par + beam;                            // (beam,)
  float* strace = reinterpret_cast<float*>(wrd + beam);  // (beam, L), TRACE
  __shared__ float best_v, wbest_v[SEL_THREADS / 32];
  __shared__ int best_c, improves, wbest_c[SEL_THREADS / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool last = (t == max_len);
  for (int i = tid; i < K2; i += nt) {
    const int p = i / beam;
    tot[i] = lp[r0 + p] + top_nll[(r0 + p) * beam + i % beam];
    ctok[i] = top_tok[(r0 + p) * beam + i % beam];
  }
  for (int i = tid; i < beam * L; i += nt) {
    sseq[i] = seqs[r0 * L + i];
    if (TRACE) strace[i] = trace[r0 * L + i];
  }
  __syncthreads();
  // best completed: the first minimum of lp / (t + 1) over stop candidates,
  // (value, index)-least over the block (a scan that replaces only on a
  // strictly lower value keeps the lowest index among equals); where every
  // value is inf (or nan) the candidate is 0, as such a scan leaves it
  {
    float bv = INFINITY;
    int bc = 0x7fffffff;
    const float denom = (float)(t + 1);
    for (int i = tid; i < K2; i += nt) {
      const float v = (ctok[i] == stop || last) ? tot[i] / denom : INFINITY;
      if (lex_less(v, i, bv, bc)) {
        bv = v;
        bc = i;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
      if (lex_less(ov, oc, bv, bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if ((tid & 31) == 0) {
      wbest_v[tid >> 5] = bv;
      wbest_c[tid >> 5] = bc;
    }
    __syncthreads();
    if (tid == 0) {
      for (int q = 1; q < nt / 32; ++q)
        if (lex_less(wbest_v[q], wbest_c[q], wbest_v[0], wbest_c[0])) {
          wbest_v[0] = wbest_v[q];
          wbest_c[0] = wbest_c[q];
        }
      bv = wbest_v[0];
      best_v = bv;
      best_c = bv < INFINITY ? wbest_c[0] : 0;
      improves = bv < score[img];  // strict: the first best stays on ties
    }
  }
  // survivors: the rank of each candidate among the non-stop totals (a
  // stop candidate's total set to inf first), counted four at a time
  // until it reaches the beam; WIDE: the beam least (total, candidate)
  // pairs by block_select, the same order
  for (int i = tid; i < K2; i += nt)
    if (ctok[i] == stop || last) tot[i] = INFINITY;
  __syncthreads();
  if constexpr (WIDE) {
    __shared__ TopkScratch ts;
    block_select<SCAN>(
        K2, beam, [&](int i) { return sb_key(tot[i]); }, &ts,
        [&](int rank, int i) {
          slp[rank] = tot[i];
          par[rank] = i / beam;
          wrd[rank] = ctok[i];
        },
        gcand);
  }
  for (int i = tid; i < K2 && !WIDE; i += nt) {
    const float vi = tot[i];
    int rank = 0, j = 0;
    for (; j + 4 <= K2 && rank < beam; j += 4)
      rank += lex_less(tot[j], j, vi, i) + lex_less(tot[j + 1], j + 1, vi, i)
              + lex_less(tot[j + 2], j + 2, vi, i)
              + lex_less(tot[j + 3], j + 3, vi, i);
    for (; j < K2 && rank < beam; ++j) rank += lex_less(tot[j], j, vi, i);
    if (rank < beam) {
      slp[rank] = vi;
      par[rank] = i / beam;
      wrd[rank] = ctok[i];
    }
  }
  __syncthreads();
  if (improves) {
    const int p = best_c / beam;
    for (int pos = tid; pos < L; pos += nt) {
      tok[img * L + pos] = pos == t ? ctok[best_c] : sseq[p * L + pos];
      if (TRACE)
        att_trace[img * L + pos] = pos == t ? att[r0 + p]
                                            : strace[p * L + pos];
    }
    if (tid == 0) {
      score[img] = best_v;
      len[img] = t + 1;
    }
  }
  if (last) return;
  // the next [x; h] and c rows: a warp a row, lanes along it, 16 bytes a
  // copy where E and H allow (four copies in flight a lane)
  const int W = E + H, lane = tid & 31, nw = nt / 32;
  const bool vec = ((E | H) & 3) == 0;
  for (int path = 0; path < PATHS; ++path) {
    const float* emb = path == 0 ? emb0 : emb1;
    const long long off = path * R;
    for (int q = tid >> 5; q < beam; q += nw) {
      const float* e = emb + (long long)wrd[q] * E;
      const float* h = hn + (off + r0 + par[q]) * H;
      const float* cs = cn + (off + r0 + par[q]) * H;
      float* d = xh + (off + r0 + q) * W;
      float* cd = c + (off + r0 + q) * H;
      if (vec) {
        const int E4 = E / 4, H4 = H / 4;
#pragma unroll 4
        for (int j = lane; j < E4 + H4; j += 32)
          reinterpret_cast<float4*>(d)[j] =
              j < E4 ? reinterpret_cast<const float4*>(e)[j]
                     : reinterpret_cast<const float4*>(h)[j - E4];
#pragma unroll 4
        for (int j = lane; j < H4; j += 32)
          reinterpret_cast<float4*>(cd)[j] =
              reinterpret_cast<const float4*>(cs)[j];
      } else {
        for (int j = lane; j < W; j += 32) d[j] = j < E ? e[j] : h[j - E];
        for (int j = lane; j < H; j += 32) cd[j] = cs[j];
      }
    }
  }
  for (int i = tid; i < beam * L; i += nt) {
    const int q = i / L, pos = i % L;
    seqs[r0 * L + i] = pos == t ? wrd[q] : sseq[par[q] * L + pos];
    if (TRACE)
      trace[r0 * L + i] = pos == t ? att[r0 + par[q]]
                                   : strace[par[q] * L + pos];
  }
  for (int q = tid; q < beam; q += nt) lp[r0 + q] = slp[q];
}

// ---- a step's row pass and selection, by the plan ---------------------------

// The shared memory the plan's shared-memory passes take, set once a call
// (a device-memory pass takes none beyond its static scratch).
template <bool MIX, int PATHS, bool TRACE>
inline cudaError_t sb_allow_smem(const SbPlan& p) {
  cudaError_t e = cudaSuccess;
  if (!p.topk_wide)
    e = cudaFuncSetAttribute(sb_row_topk_kernel<MIX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.topk_smem);
  if (e == cudaSuccess && !p.select_wide)
    e = cudaFuncSetAttribute(sb_select_kernel<PATHS, TRACE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.select_smem);
  return e;
}

// A step's row pass: a block a row, from shared memory or (topk_wide) from
// device memory, its survivors (beam > KWIDE) at the start of `wide`.
template <bool MIX>
inline cudaError_t sb_row_pass(const SbPlan& p, float* logits,
                               const float* hn, const float* aw,
                               const float* ab, float* att, long long R,
                               int V, int H, int beam, float* top_nll,
                               int* top_tok, float* wide, cudaStream_t st) {
  auto* cand = reinterpret_cast<unsigned long long*>(wide);
  if (!p.topk_wide)
    sb_row_topk_kernel<MIX><<<(unsigned)R, TOPK_THREADS, p.topk_smem, st>>>(
        logits, hn, aw, ab, att, R, V, H, beam, p.topk_cap, top_nll,
        top_tok);
  else if (beam > KWIDE)
    sb_row_topk_dev_kernel<MIX, true><<<(unsigned)R, TOPK_THREADS, 0, st>>>(
        logits, hn, aw, ab, att, R, V, H, beam, top_nll, top_tok, cand);
  else
    sb_row_topk_dev_kernel<MIX, false><<<(unsigned)R, TOPK_THREADS, 0, st>>>(
        logits, hn, aw, ab, att, R, V, H, beam, top_nll, top_tok, nullptr);
  return cudaGetLastError();
}

// A step's selection: a block an image, from shared memory or
// (select_wide) from its part of `wide` after the row pass's survivors.
template <int PATHS, bool TRACE>
inline cudaError_t sb_select_pass(
    const SbPlan& p, const float* top_nll, const int* top_tok,
    const float* hn, const float* cn, const float* emb0, const float* emb1,
    const float* att, float* xh, float* c, int* seqs, float* lp,
    float* trace, int* tok, int* len, float* score, float* att_trace,
    long long R, int n_img, int beam, int E, int H, int L, int t,
    int max_len, int stop, float* wide, cudaStream_t st) {
  float* w = wide + (p.topk_wide ? sb_topk_wide_floats(R, beam) : 0);
  if (!p.select_wide)
    sb_select_kernel<PATHS, TRACE><<<n_img, SEL_THREADS, p.select_smem, st>>>(
        top_nll, top_tok, hn, cn, emb0, emb1, att, xh, c, seqs, lp, trace,
        tok, len, score, att_trace, R, beam, E, H, L, t, max_len, stop,
        nullptr);
  else if (beam > KWIDE)
    sb_select_kernel<PATHS, TRACE, true, true><<<n_img, SEL_THREADS, 0, st>>>(
        top_nll, top_tok, hn, cn, emb0, emb1, att, xh, c, seqs, lp, trace,
        tok, len, score, att_trace, R, beam, E, H, L, t, max_len, stop, w);
  else
    sb_select_kernel<PATHS, TRACE, true, false><<<n_img, SEL_THREADS, 0, st>>>(
        top_nll, top_tok, hn, cn, emb0, emb1, att, xh, c, seqs, lp, trace,
        tok, len, score, att_trace, R, beam, E, H, L, t, max_len, stop, w);
  return cudaGetLastError();
}

}  // namespace icee
