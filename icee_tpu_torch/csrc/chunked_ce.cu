// The chunked cross-entropy's row passes, forward and backward.
//
// Replaces the row work of icee_tpu/ops/chunked_loss.py::_weighted_ce (a
// jax.custom_vjp in XLA, not Pallas: _ce_forward :71 and _ce_bwd :103, under
// masked_ce_from_hiddens :142 and masked_sum_ce_from_hiddens :386).  The
// caller forms one time chunk's logits (rows = B * t_chunk, V) with a plain
// product, as the JAX package leaves it to XLA; these kernels then
//   forward:  per row, the max, lse = max + log(sum exp(l - max)), the
//             target logit and w * nll with nll = lse - tgt, optionally
//             min(nll, clamp).  Only lse is kept for the backward;
//   backward: in place over the recomputed chunk logits, dl = (exp(l - lse)
//             - onehot(target)) * w * g, zero where the clamp bit, then
//             db [+]= sum over rows of dl in a fixed order (gemm_f32.cuh
//             colsum).
// A target outside [0, V) has no one-hot entry (a target logit of 0), as
// jax.nn.one_hot gives.
//
// The SentiCap switched model's mixture CE (chunked_loss.py::_mixture_ce, a
// jax.custom_vjp: forward :265, backward :297, under mixture_ce_from_hiddens
// :364 and mixture_neglog2_sum_from_hiddens :194) has two heads.  Its
// forward row pass is mixture_rows_kernel: per row, both heads' lse and
// target probability p = exp(tgt - lse), then p_mix = co p_o + cn p_n and
// w * -log(max(p_mix, 1e-37)).  Its backward reuses ce_grad_rows_kernel on
// each head that needs a gradient, with per-row weights -fac (fac = dL/dp_tgt
// * p_tgt from the caller) and g = 1, which forms fac (onehot - p) exactly.
//
// What bounds it on the H100: bytes.  Each pass reads (the backward also
// writes) the (rows, V) float32 chunk: 67 MB at 2048 x 8192, ~20 us at
// 3.35 TB/s, against a few flops per element (the mixture's forward reads
// two such chunks, one a head).  What the design does about
// it: one block of 256 threads per row, float4 loads, the row's second read
// served from L1 (32 KB a row), and the (B, T, V) logits never exist whole,
// only one chunk's.  Block reductions go warp shuffle, then warps in a
// fixed order, so a loss gives the same bits on every run.
#include "decode_common.cuh"
#include "gemm_f32.cuh"

namespace icee {

constexpr int CE_THREADS = 256;
constexpr int CE_WARPS = CE_THREADS / 32;

// Block-wide reduction, warps combined in warp order; every thread gets it.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int q = 1; q < CE_WARPS; ++q) t = MAX ? fmaxf(t, red[q]) : t + red[q];
  return t;
}

// The row's max m and sum of exp(l - m), block-wide; every thread gets them.
__device__ void row_max_sum(const float* l, int V, int vec, float* red,
                            float* m_out, float* s_out) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  if (vec) {
    for (int q = tid; q < V / 4; q += CE_THREADS) {
      const float4 a = reinterpret_cast<const float4*>(l)[q];
      m = fmaxf(fmaxf(m, fmaxf(a.x, a.y)), fmaxf(a.z, a.w));
    }
  } else {
    for (int c = tid; c < V; c += CE_THREADS) m = fmaxf(m, l[c]);
  }
  m = block_reduce<true>(m, red);
  float s = 0.f;
  if (vec) {
    for (int q = tid; q < V / 4; q += CE_THREADS) {
      const float4 a = reinterpret_cast<const float4*>(l)[q];
      s += expf(a.x - m) + expf(a.y - m) + expf(a.z - m) + expf(a.w - m);
    }
  } else {
    for (int c = tid; c < V; c += CE_THREADS) s += expf(l[c] - m);
  }
  s = block_reduce<false>(s, red);
  *m_out = m;
  *s_out = s;
}

__global__ void __launch_bounds__(CE_THREADS)
ce_rows_kernel(const float* __restrict__ logits,
               const long long* __restrict__ targets,
               const float* __restrict__ weights, float* lse, float* contrib,
               int V, float clamp, int use_clamp, int vec) {
  __shared__ float red[CE_WARPS];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* l = logits + (long long)row * V;
  float m, s;
  row_max_sum(l, V, vec, red, &m, &s);
  if (tid == 0) {
    const float L = m + logf(s);
    const long long y = targets[row];
    const float tgt = (y >= 0 && y < V) ? l[y] : 0.f;
    float nll = L - tgt;
    if (use_clamp) nll = fminf(nll, clamp);
    lse[row] = L;
    contrib[row] = weights[row] * nll;
  }
}

// One block per row of the two heads' logits (R, V) each.
__global__ void __launch_bounds__(CE_THREADS)
mixture_rows_kernel(const float* __restrict__ lo, const float* __restrict__ ln,
                    const long long* __restrict__ targets,
                    const float* __restrict__ co, const float* __restrict__ cn,
                    const float* __restrict__ weights, float* lse_o,
                    float* lse_n, float* p_o, float* p_n, float* contrib,
                    int V, int vec) {
  __shared__ float red[CE_WARPS];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* a = lo + (long long)row * V;
  const float* b = ln + (long long)row * V;
  float m_o, s_o, m_n, s_n;
  row_max_sum(a, V, vec, red, &m_o, &s_o);
  row_max_sum(b, V, vec, red, &m_n, &s_n);
  if (tid == 0) {
    const float Lo = m_o + logf(s_o), Ln = m_n + logf(s_n);
    const long long y = targets[row];
    const bool valid = y >= 0 && y < V;
    const float po = expf((valid ? a[y] : 0.f) - Lo);
    const float pn = expf((valid ? b[y] : 0.f) - Ln);
    const float pm = co[row] * po + cn[row] * pn;
    lse_o[row] = Lo;
    lse_n[row] = Ln;
    p_o[row] = po;
    p_n[row] = pn;
    contrib[row] = weights[row] * -logf(fmaxf(pm, 1e-37f));
  }
}

__global__ void __launch_bounds__(CE_THREADS)
ce_grad_rows_kernel(float* dl, const long long* __restrict__ targets,
                    const float* __restrict__ weights,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    int V, float clamp, int use_clamp, int vec) {
  const int row = blockIdx.x, tid = threadIdx.x;
  float* l = dl + (long long)row * V;
  const long long y = targets[row];
  const float L = lse[row];
  float scale = weights[row] * g[0];
  if (use_clamp) {
    const float tgt = (y >= 0 && y < V) ? l[y] : 0.f;
    scale = scale * (L - tgt < clamp ? 1.f : 0.f);
  }
  __syncthreads();  // every thread has read l[y] before any write
  if (vec) {
    for (int q = tid; q < V / 4; q += CE_THREADS) {
      float4 a = reinterpret_cast<float4*>(l)[q];
      const int c = 4 * q;
      a.x = (expf(a.x - L) - (c == y ? 1.f : 0.f)) * scale;
      a.y = (expf(a.y - L) - (c + 1 == y ? 1.f : 0.f)) * scale;
      a.z = (expf(a.z - L) - (c + 2 == y ? 1.f : 0.f)) * scale;
      a.w = (expf(a.w - L) - (c + 3 == y ? 1.f : 0.f)) * scale;
      reinterpret_cast<float4*>(l)[q] = a;
    }
  } else {
    for (int c = tid; c < V; c += CE_THREADS)
      l[c] = (expf(l[c] - L) - (c == y ? 1.f : 0.f)) * scale;
  }
}

}  // namespace icee

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// logits (R, V), targets (R,) int64, weights (R,) -> lse (R,), contrib (R,)
// = weights * nll.
int icee_ce_rows(const float* logits, const long long* targets,
                 const float* weights, float* lse, float* contrib, int R,
                 int V, float clamp, int use_clamp, void* stream) {
  if (R <= 0) return 0;
  const int vec = V % 4 == 0 && aligned16(logits);
  ce_rows_kernel<<<R, CE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, targets, weights, lse, contrib, V, clamp, use_clamp, vec);
  return (int)cudaGetLastError();
}

// The mixture CE's forward row pass over one chunk: logits lo, ln (R, V),
// targets (R,) int64, co, cn, weights (R,) -> lse_o, lse_n, p_o, p_n,
// contrib (R,) = weights * -log(max(co p_o + cn p_n, 1e-37)).
int icee_mixture_rows(const float* lo, const float* ln,
                      const long long* targets, const float* co,
                      const float* cn, const float* weights, float* lse_o,
                      float* lse_n, float* p_o, float* p_n, float* contrib,
                      int R, int V, void* stream) {
  if (R <= 0) return 0;
  const int vec = V % 4 == 0 && aligned16(lo) && aligned16(ln);
  mixture_rows_kernel<<<R, CE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lo, ln, targets, co, cn, weights, lse_o, lse_n, p_o, p_n, contrib, V,
      vec);
  return (int)cudaGetLastError();
}

// In place: logits (R, V) -> dl; then db (V,) = [db +] sum_r dl.  g is the
// loss's upstream gradient, one float on the device.
int icee_ce_grad_rows(float* logits, const long long* targets,
                      const float* weights, const float* lse, const float* g,
                      float* db, int accumulate, int R, int V, float clamp,
                      int use_clamp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const int vec = V % 4 == 0 && aligned16(logits);
    ce_grad_rows_kernel<<<R, CE_THREADS, 0, st>>>(logits, targets, weights,
                                                  lse, g, V, clamp, use_clamp,
                                                  vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)colsum(logits, V, R, V, db, accumulate, st);
}

}  // extern "C"
