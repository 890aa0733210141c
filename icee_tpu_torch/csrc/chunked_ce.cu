// The chunked cross-entropy's row passes, forward and backward.
//
// Replaces the row work of icee_tpu/ops/chunked_loss.py::_weighted_ce (a
// jax.custom_vjp in XLA, not Pallas: _ce_forward :71 and _ce_bwd :103, under
// masked_ce_from_hiddens :142 and masked_sum_ce_from_hiddens :386).  The
// caller forms one time chunk's logits (rows = B * t_chunk, V) with a plain
// product, as the JAX package leaves it to XLA; these kernels then
//   forward:  per row, lse = max + log(sum exp(l - max)), the target logit
//             and w * nll with nll = lse - tgt, optionally min(nll, clamp).
//             Only lse is kept for the backward;
//   backward: in place over the recomputed chunk logits, dl = (exp(l - lse)
//             - onehot(target)) * w * g, zero where the clamp bit, then
//             db [+]= sum over rows of dl in a fixed order.
// A target outside [0, V) has no one-hot entry (a target logit of 0), as
// jax.nn.one_hot gives.
//
// The SentiCap switched model's mixture CE (chunked_loss.py::_mixture_ce, a
// jax.custom_vjp: forward :265, backward :297, under mixture_ce_from_hiddens
// :364 and mixture_neglog2_sum_from_hiddens :194) has two heads.  Its
// forward row pass is the CE's forward over both heads' rows (HEADS = 2):
// per row, both heads' lse and target probability p = exp(tgt - lse),
// then p_mix = co p_o + cn p_n and w * -log(max(p_mix, 1e-37)).  Its
// backward reuses the CE's backward on each head that needs a gradient,
// with per-row weights -fac (fac = dL/dp_tgt * p_tgt from the caller) and
// g = 1, which forms fac (onehot - p) exactly.
//
// What bounds it on the H100: bytes.  Each pass reads (the backward also
// writes) the (rows, V) float32 chunk: 52 MB at 1600 x 8192, ~16 us at
// 3.35 TB/s, against a few flops per element (the mixture's forward reads
// two such chunks, one a head: 99 MB at 1,408 x 8,800, ~30 us).  What the
// design does about it:
//   forward (ce_rows_kernel, HEADS rows of one warp: the CE's one, the
//     mixture's two, one after the other): one warp a row, CER_ROWS rows a
//     block; each row is read ONCE, each lane keeping an online (max,
//     rescaled sum) over its columns (lane l owns the 16-byte groups q = l
//     mod 32), CER_UNROLL loads a chunk with the next chunk's loads issued
//     before this one is summed; the lanes' pairs merge by a butterfly of
//     shuffles (offsets 16, 8, 4, 2, 1), whose merge is commutative to the
//     bit, so every lane ends with the same pair; the target logit is
//     taken from the registers of the lane that loaded it.  A row V % 4 !=
//     0 or not 16-byte aligned is read one float a load, in the same
//     order.  (Tried and not kept, PERF.md's CE findings: 2 or 4 warps a
//     row, 2, 4 or 16 loads a chunk, the row streamed into shared memory by
//     bulk copies counted on mbarriers: none faster at the main path's
//     shapes);
//   backward (ce_grad_rows_kernel): block (column slab, row group) owns
//     CEG_THREADS x VW columns of CEG_ROWS rows; each thread forms dl for
//     its columns row after row (CEG_UNROLL rows' loads in flight, the next
//     batch's issued first), writes it and keeps its columns' sums in
//     registers, which go to a (groups, V) partials buffer;
//     ce_colsum_groups_kernel then adds the groups in group order into db.  So the chunk is read once and written once:
//     no third pass over it for the bias grad.  Where the clamp applies, a
//     row's clamp bit needs l[y] before the block owning column y
//     overwrites it, so ce_target_kernel first gathers the R target
//     logits into a small buffer;
//   the (B, T, V) logits never exist whole, only one chunk's.
// Every sum has a fixed order, so a loss gives the same bits on every run.
#include "decode_common.cuh"
#include "gemm_f32.cuh"   // aligned16

namespace icee {

constexpr int CER_ROWS = 4;       // rows of a forward block, one warp each
constexpr int CER_UNROLL = 8;     // 16-byte loads a lane issues a chunk
constexpr int CER_THREADS = 32 * CER_ROWS;

// The online pair (m, s) of a lane, s the sum of exp(l - m) over what it
// has read, taking in the chunk v (VW floats a load): the chunk's max
// first, then the old sum rescaled once, then the chunk's terms in load
// order, each load's VW terms added among themselves first.  A reference of
// 0 where the max is still -inf, so that -inf logits add exp(-inf) = 0.
template <int VW>
__device__ __forceinline__ void ce_online(float& m, float& s,
                                          const float (&v)[CER_UNROLL][VW]) {
  float cm = m;
#pragma unroll
  for (int u = 0; u < CER_UNROLL; ++u)
#pragma unroll
    for (int k = 0; k < VW; ++k) cm = fmaxf(cm, v[u][k]);
  const float ref = cm == -INFINITY ? 0.f : cm;
  float t = s * expf(m - ref);
#pragma unroll
  for (int u = 0; u < CER_UNROLL; ++u) {
    float e = expf(v[u][0] - ref);
#pragma unroll
    for (int k = 1; k < VW; ++k) e = e + expf(v[u][k] - ref);
    t = t + e;
  }
  m = cm;
  s = t;
}

// Merge of two lanes' pairs: the same bits whichever lane computes it.
__device__ __forceinline__ void ce_merge(float& m, float& s, float m2,
                                         float s2) {
  const float mm = fmaxf(m, m2);
  const float ref = mm == -INFINITY ? 0.f : mm;
  s = s * expf(m - ref) + s2 * expf(m2 - ref);
  m = mm;
}

// VW floats of row l at group q (VW = 4: 16-byte aligned), -inf past nq.
template <int VW>
__device__ __forceinline__ void ce_load(const float* l, int q,
                                        int nq, float (&v)[VW]) {
  if (q >= nq) {
#pragma unroll
    for (int k = 0; k < VW; ++k) v[k] = -INFINITY;
  } else if constexpr (VW == 4) {
    const float4 a = reinterpret_cast<const float4*>(l)[q];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = l[q];
  }
}

// What a forward launch reads and writes.  HEADS = 1, the CE: l[0], lse[0]
// and contrib = weights * nll, nll optionally min(nll, clamp).  HEADS = 2,
// the mixture: l[0] = lo, l[1] = ln, both lse and p = exp(tgt - lse), and
// contrib = weights * -log(max(co p_o + cn p_n, 1e-37)).
struct RowArgs {
  const float* l[2];
  const long long* targets;
  const float* weights;
  const float* co;
  const float* cn;
  float* lse[2];
  float* p[2];
  float* contrib;
  int R, V, use_clamp;
  float clamp;
};

// One warp's pass over row l (nq VW-float groups; the target's group qy,
// -1 where none, and its place ky).  Lane l sums the groups q = l mod 32
// chunk by chunk (CER_UNROLL groups a lane, in order), the next chunk's
// loads issued before this one is summed; the lanes then merge by the
// butterfly, and the lane that loaded the target's group hands its logit
// round.  -> (m, s) and tgt, the same in every lane (tgt 0 where qy < 0).
template <int VW>
__device__ __forceinline__ void warp_row(const float* __restrict__ l, int nq,
                                         int qy, int ky, float& m, float& s,
                                         float& tgt) {
  constexpr int span = 32 * CER_UNROLL;
  const int lane = threadIdx.x & 31;
  m = -INFINITY;
  s = 0.f;
  tgt = 0.f;
  float v[CER_UNROLL][VW], nx[CER_UNROLL][VW];
#pragma unroll
  for (int u = 0; u < CER_UNROLL; ++u) ce_load<VW>(l, 32 * u + lane, nq, v[u]);
  for (int q0 = 0; q0 < nq; q0 += span) {
#pragma unroll
    for (int u = 0; u < CER_UNROLL; ++u)
      ce_load<VW>(l, q0 + span + 32 * u + lane, nq, nx[u]);
#pragma unroll
    for (int u = 0; u < CER_UNROLL; ++u)
      if (q0 + 32 * u + lane == qy) {
#pragma unroll
        for (int k = 0; k < VW; ++k)
          if (k == ky) tgt = v[u][k];
      }
    ce_online<VW>(m, s, v);
#pragma unroll
    for (int u = 0; u < CER_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < VW; ++k) v[u][k] = nx[u][k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ce_merge(m, s, __shfl_xor_sync(FULL, m, off),
             __shfl_xor_sync(FULL, s, off));
  tgt = __shfl_sync(FULL, tgt, qy >= 0 ? qy & 31 : 0);
}

// One warp a row of each of the HEADS logits (R, V), the heads one after
// the other; lane 0 writes the row's results.
template <int VW, int HEADS>
__global__ void __launch_bounds__(CER_THREADS)
ce_rows_kernel(const __grid_constant__ RowArgs a) {
  const int row = blockIdx.x * CER_ROWS + (threadIdx.x >> 5);
  if (row >= a.R) return;   // the whole warp
  const int V = a.V;
  const long long y = a.targets[row];
  const bool valid = y >= 0 && y < V;
  const int nq = V / VW, qy = valid ? (int)(y / VW) : -1;
  const int ky = valid ? (int)(y % VW) : 0;
  float L[HEADS], tgt[HEADS];
#pragma unroll
  for (int h = 0; h < HEADS; ++h) {
    float m, s;
    warp_row<VW>(a.l[h] + (long long)row * V, nq, qy, ky, m, s, tgt[h]);
    L[h] = m + logf(s);
  }
  if ((threadIdx.x & 31) != 0) return;
  if constexpr (HEADS == 1) {
    float nll = L[0] - (valid ? tgt[0] : 0.f);
    if (a.use_clamp) nll = fminf(nll, a.clamp);
    a.lse[0][row] = L[0];
    a.contrib[row] = a.weights[row] * nll;
  } else {
    const float po = expf((valid ? tgt[0] : 0.f) - L[0]);
    const float pn = expf((valid ? tgt[1] : 0.f) - L[1]);
    const float pm = a.co[row] * po + a.cn[row] * pn;
    a.lse[0][row] = L[0];
    a.lse[1][row] = L[1];
    a.p[0][row] = po;
    a.p[1][row] = pn;
    a.contrib[row] = a.weights[row] * -logf(fmaxf(pm, 1e-37f));
  }
}

constexpr int CEG_THREADS = 256;   // a backward block: a slab of 256 x VW
constexpr int CEG_ROWS = 64;       // ... over a group of 64 rows
constexpr int CEG_UNROLL = 8;      // rows whose loads a thread keeps in flight
constexpr int CEG_SUM_UNROLL = 8;  // groups' partials a thread loads at once

// tgt[r] = l[r, y_r], 0 for a target outside [0, V): the clamp bit's
// operand, gathered before any block overwrites its row.
__global__ void ce_target_kernel(const float* __restrict__ logits,
                                 const long long* __restrict__ targets,
                                 float* tgt, int R, int V) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long y = targets[r];
  tgt[r] = (y >= 0 && y < V) ? logits[(long long)r * V + y] : 0.f;
}

// Block (slab blockIdx.x, group blockIdx.y): dl in place for the group's
// rows at the thread's VW columns, and their column sums, row by row in
// row order, into part (groups, V).  tgt: ce_target_kernel's (where
// use_clamp; else unread).
template <int VW>
__global__ void __launch_bounds__(CEG_THREADS)
ce_grad_rows_kernel(float* dl, const long long* __restrict__ targets,
                    const float* __restrict__ weights,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    const float* __restrict__ tgt, float* part, int R, int V,
                    float clamp, int use_clamp) {
  __shared__ float s_lse[CEG_ROWS], s_scale[CEG_ROWS];
  __shared__ long long s_y[CEG_ROWS];
  const int r0 = blockIdx.y * CEG_ROWS, nr = min(CEG_ROWS, R - r0);
  if ((int)threadIdx.x < nr) {
    const int r = r0 + threadIdx.x;
    const float L = lse[r];
    float scale = weights[r] * g[0];
    if (use_clamp) scale = scale * (L - tgt[r] < clamp ? 1.f : 0.f);
    s_lse[threadIdx.x] = L;
    s_scale[threadIdx.x] = scale;
    s_y[threadIdx.x] = targets[r];
  }
  __syncthreads();
  const int nq = V / VW, q = blockIdx.x * CEG_THREADS + threadIdx.x;
  if (q >= nq) return;
  const long long c = (long long)q * VW;
  float sum[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) sum[k] = 0.f;
  float v[CEG_UNROLL][VW], nx[CEG_UNROLL][VW];
#pragma unroll
  for (int u = 0; u < CEG_UNROLL; ++u)
    if (u < nr) ce_load<VW>(dl + (long long)(r0 + u) * V, q, nq, v[u]);
  for (int i0 = 0; i0 < nr; i0 += CEG_UNROLL) {
    // the next rows in flight while these are formed (each element is
    // read before it is written: a row is loaded a batch ahead)
#pragma unroll
    for (int u = 0; u < CEG_UNROLL; ++u)
      if (i0 + CEG_UNROLL + u < nr)
        ce_load<VW>(dl + (long long)(r0 + i0 + CEG_UNROLL + u) * V, q, nq,
                    nx[u]);
#pragma unroll
    for (int u = 0; u < CEG_UNROLL; ++u) {
      const int i = i0 + u;
      if (i >= nr) break;
      const float L = s_lse[i], scale = s_scale[i];
      const long long y = s_y[i];
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        v[u][k] = (expf(v[u][k] - L) - (c + k == y ? 1.f : 0.f)) * scale;
        sum[k] = sum[k] + v[u][k];
      }
      float* out = dl + (long long)(r0 + i) * V;
      if constexpr (VW == 4)
        reinterpret_cast<float4*>(out)[q] =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      else
        out[q] = v[u][0];
    }
#pragma unroll
    for (int u = 0; u < CEG_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < VW; ++k) v[u][k] = nx[u][k];
  }
#pragma unroll
  for (int k = 0; k < VW; ++k) part[(long long)blockIdx.y * V + c + k] = sum[k];
}

// db(c) = [db(c) +] sum of part(q, c) over the groups q in order.
__global__ void ce_colsum_groups_kernel(const float* __restrict__ part,
                                        int groups, int V, float* db,
                                        int accumulate) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= V) return;
  float t = 0.f;
  for (int q0 = 0; q0 < groups; q0 += CEG_SUM_UNROLL) {
    float v[CEG_SUM_UNROLL];
#pragma unroll
    for (int u = 0; u < CEG_SUM_UNROLL; ++u)
      v[u] = q0 + u < groups ? part[(long long)(q0 + u) * V + c] : 0.f;
#pragma unroll
    for (int u = 0; u < CEG_SUM_UNROLL; ++u)
      if (q0 + u < groups) t = q0 + u == 0 ? v[u] : t + v[u];
  }
  db[c] = accumulate ? db[c] + t : t;
}

}  // namespace icee

using namespace icee;

// The forward row pass over a.R rows of HEADS heads: 16-byte loads where
// vec (V % 4 == 0 and every head's rows 16-byte aligned), else one float a
// load.
template <int HEADS>
static int launch_rows(const RowArgs& a, bool vec, void* stream) {
  if (a.R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (a.R + CER_ROWS - 1) / CER_ROWS;
  if (vec)
    ce_rows_kernel<4, HEADS><<<blocks, CER_THREADS, 0, st>>>(a);
  else
    ce_rows_kernel<1, HEADS><<<blocks, CER_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// logits (R, V), targets (R,) int64, weights (R,) -> lse (R,), contrib (R,)
// = weights * nll.
int icee_ce_rows(const float* logits, const long long* targets,
                 const float* weights, float* lse, float* contrib, int R,
                 int V, float clamp, int use_clamp, void* stream) {
  RowArgs a = {};
  a.l[0] = logits;
  a.targets = targets;
  a.weights = weights;
  a.lse[0] = lse;
  a.contrib = contrib;
  a.R = R;
  a.V = V;
  a.clamp = clamp;
  a.use_clamp = use_clamp;
  return launch_rows<1>(a, V % 4 == 0 && aligned16(logits), stream);
}

// The mixture CE's forward row pass over one chunk: logits lo, ln (R, V),
// targets (R,) int64, co, cn, weights (R,) -> lse_o, lse_n, p_o, p_n,
// contrib (R,) = weights * -log(max(co p_o + cn p_n, 1e-37)).
int icee_mixture_rows(const float* lo, const float* ln,
                      const long long* targets, const float* co,
                      const float* cn, const float* weights, float* lse_o,
                      float* lse_n, float* p_o, float* p_n, float* contrib,
                      int R, int V, void* stream) {
  RowArgs a = {};
  a.l[0] = lo;
  a.l[1] = ln;
  a.targets = targets;
  a.weights = weights;
  a.co = co;
  a.cn = cn;
  a.lse[0] = lse_o;
  a.lse[1] = lse_n;
  a.p[0] = p_o;
  a.p[1] = p_n;
  a.contrib = contrib;
  a.R = R;
  a.V = V;
  return launch_rows<2>(
      a, V % 4 == 0 && aligned16(lo) && aligned16(ln), stream);
}

// Floats of icee_ce_grad_rows' workspace for R rows of V: the groups'
// partial column sums, then the R target logits.
long long icee_ce_grad_ws(int R, int V) {
  const long long groups = (R + CEG_ROWS - 1) / CEG_ROWS;
  return groups * V + R;
}

// In place: logits (R, V) -> dl; then db (V,) = [db +] sum_r dl.  g is the
// loss's upstream gradient, one float on the device; ws holds
// icee_ce_grad_ws(R, V) floats.
int icee_ce_grad_rows(float* logits, const long long* targets,
                      const float* weights, const float* lse, const float* g,
                      float* db, int accumulate, float* ws,
                      long long ws_floats, int R, int V, float clamp,
                      int use_clamp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V <= 0) return 0;
  if (ws_floats < icee_ce_grad_ws(R, V)) return cudaErrorInvalidValue;
  const int groups = (R + CEG_ROWS - 1) / CEG_ROWS;
  float* part = ws;
  float* tgt = ws + (long long)groups * V;
  if (R > 0) {
    if (use_clamp) {
      ce_target_kernel<<<(R + 255) / 256, 256, 0, st>>>(logits, targets, tgt,
                                                        R, V);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    const bool vec = V % 4 == 0 && aligned16(logits);
    const int nq = vec ? V / 4 : V;
    const dim3 grid((nq + CEG_THREADS - 1) / CEG_THREADS, groups);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    if (vec)
      ce_grad_rows_kernel<4><<<grid, CEG_THREADS, 0, st>>>(
          logits, targets, weights, lse, g, tgt, part, R, V, clamp,
          use_clamp);
    else
      ce_grad_rows_kernel<1><<<grid, CEG_THREADS, 0, st>>>(
          logits, targets, weights, lse, g, tgt, part, R, V, clamp,
          use_clamp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (R <= 0 && accumulate) return 0;
  if (R <= 0) return (int)cudaMemsetAsync(db, 0, sizeof(float) * V, st);
  ce_colsum_groups_kernel<<<(V + 255) / 256, 256, 0, st>>>(part, groups, V,
                                                           db, accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"
