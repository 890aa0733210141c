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
// What bounds it on the H100: bytes.  Each pass reads (the backward also
// writes) the (rows, V) float32 chunk: 67 MB at 2048 x 8192, ~20 us at
// 3.35 TB/s, against a few flops per element.  What the design does about
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

__global__ void __launch_bounds__(CE_THREADS)
ce_rows_kernel(const float* __restrict__ logits,
               const long long* __restrict__ targets,
               const float* __restrict__ weights, float* lse, float* contrib,
               int V, float clamp, int use_clamp, int vec) {
  __shared__ float red[CE_WARPS];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* l = logits + (long long)row * V;
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
