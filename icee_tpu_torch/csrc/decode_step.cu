// K1: one FactoredLSTM decode step with an exact top-k over the vocabulary.
//
// Replaces icee_tpu/ops/pallas_decode.py::fused_decode_step_topk (the TPU
// kernel _kernel at :191): cell -> head h' @ C_w + C_b over V -> exact
// top-k (lowest vocab index on ties) -> log-softmax values of those k, plus
// h' and c'.  The (R, V) logits never reach device memory.
//
// What bounds it on the H100: operations.  At the serving shape (R = 320
// rows, E = 300, F = H = 512, V = 8192) one step is 5.1 GFLOP of float32
// multiply-adds against ~32 MB of weights, far above the card's
// operations-per-byte line; float32 is kept (no TF32) so the port matches
// the JAX package to 1e-5.  What the design does about it: every weight
// float4 read from L2 feeds 4 columns x 8 or 16 rows of FMAs, and each
// thread keeps 8 such reads in flight (decode_common.cuh dot4).
//
// Design: three launches on the caller's stream.
//   1. cell: one block per 8 rows; each of the cell's stages spans all four
//      gates (4F or 4H output columns, one column quad per thread), through
//      shared-memory scratch planes.
//   2. head: grid (row blocks of 16) x (groups of 4 vocab tiles of 256).
//      Each block computes its logits tiles into shared memory and one warp
//      per (row, tile) reduces a tile to a partial (max, sum-exp, top-k).
//      Only the (R, n_tiles, k) partials are written.
//   3. merge: one warp per row combines the partials into logZ and the
//      exact top-k, and writes logp = value - logZ.
// The simple first version uses CUDA-core fmaf; wgmma/TMA tiling is later
// work.
#include "decode_common.cuh"

namespace icee {

constexpr int CELL_ROWS = 8;
constexpr int HEAD_ROWS = 16;
constexpr int HEAD_TILES = 4;  // vocab tiles per head block
constexpr int CELL_THREADS = 512;

__global__ void __launch_bounds__(CELL_THREADS)
cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
            const float* __restrict__ c, CellWeights w, float* h_out,
            float* c_out, int R) {
  extern __shared__ __align__(16) float smem[];
  const int Ep = round4(w.E), Hp = round4(w.H), ld = cell_ld(w.F, w.H);
  float* xs = smem;
  float* hs = xs + CELL_ROWS * Ep;
  float* s1 = hs + CELL_ROWS * Hp;
  float* s2 = s1 + CELL_ROWS * ld;
  const int r0 = blockIdx.x * CELL_ROWS;
  const int rows = min(CELL_ROWS, R - r0);
  for (int i = threadIdx.x; i < rows * Ep; i += blockDim.x) {
    const int r = i / Ep, e = i % Ep;
    xs[i] = e < w.E ? x[(size_t)(r0 + r) * w.E + e] : 0.f;
  }
  for (int i = threadIdx.x; i < rows * Hp; i += blockDim.x) {
    const int r = i / Hp, j = i % Hp;
    hs[i] = j < w.H ? h[(size_t)(r0 + r) * w.H + j] : 0.f;
  }
  __syncthreads();
  factored_cell<CELL_ROWS>(xs, Ep, hs, Hp, c + (size_t)r0 * w.H, w.H, w, s1,
                           s2, ld, rows, h_out + (size_t)r0 * w.H, w.H,
                           c_out + (size_t)r0 * w.H, w.H);
}

__global__ void __launch_bounds__(HEAD_TILES * QT)
head_kernel(const float* __restrict__ h, const float* __restrict__ Cw,
            const float* __restrict__ Cb, float* pm, float* pse, float* pv,
            int* pi, int R, int H, int V, int n_tiles, int k) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = round4(H);
  float* hs = smem;
  float* lt = hs + HEAD_ROWS * Hp;  // (HEAD_TILES, HEAD_ROWS, VT)
  const int r0 = blockIdx.x * HEAD_ROWS;
  const int rows = min(HEAD_ROWS, R - r0);
  const int tile0 = blockIdx.y * HEAD_TILES;
  for (int i = threadIdx.x; i < rows * Hp; i += blockDim.x) {
    const int r = i / Hp, j = i % Hp;
    hs[i] = j < H ? h[(size_t)(r0 + r) * H + j] : 0.f;
  }
  __syncthreads();
  const int tl = threadIdx.x / QT, c4 = 4 * (threadIdx.x % QT);
  head_quad<HEAD_ROWS>(hs, Hp, rows, Cw, Cb, H, V, (tile0 + tl) * VT + c4,
                       lt + tl * HEAD_ROWS * VT + c4, VT);
  __syncthreads();
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int task = warp; task < HEAD_TILES * rows; task += n_warps) {
    const int t = task / rows, r = task % rows, tile = tile0 + t;
    if (tile < n_tiles) {
      const size_t p = (size_t)(r0 + r) * n_tiles + tile;
      tile_reduce(lt + (t * HEAD_ROWS + r) * VT, tile * VT, k, pm + p,
                  pse + p, pv + p * k, pi + p * k);
    }
  }
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

}  // namespace icee

using namespace icee;

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Partials: pm, pse (R, n_tiles); pv, pi (R, n_tiles, k), n_tiles = ceil(V /
// 256).  Returns 0 or the first CUDA error of the three launches.
extern "C" int icee_decode_step_topk(
    const float* x, const float* h, const float* c, const float* Vw,
    const float* Vb, const float* Sw, const float* Sb, const float* Uw,
    const float* Ub, const float* Ww, const float* Wb, const float* Cw,
    const float* Cb, float* h_out, float* c_out, float* logp, int* idx,
    float* pm, float* pse, float* pv, int* pi, int R, int E, int F, int H,
    int V, int k, void* stream) {
  if (R <= 0 || k < 1 || k > KMAX || F % 4 || H % 4 || V % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CellWeights w{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E, F, H};
  const int n_tiles = (V + VT - 1) / VT;
  cudaError_t e;

  const size_t cell_smem =
      sizeof(float) * CELL_ROWS *
      (round4(E) + round4(H) + 2 * (size_t)cell_ld(F, H));
  e = cudaFuncSetAttribute(cell_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cell_smem);
  if (e != cudaSuccess) return e;
  cell_kernel<<<(R + CELL_ROWS - 1) / CELL_ROWS, CELL_THREADS, cell_smem, s>>>(
      x, h, c, w, h_out, c_out, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t head_smem =
      sizeof(float) * HEAD_ROWS * (round4(H) + HEAD_TILES * VT);
  e = cudaFuncSetAttribute(head_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)head_smem);
  if (e != cudaSuccess) return e;
  const dim3 head_grid((R + HEAD_ROWS - 1) / HEAD_ROWS,
                       (n_tiles + HEAD_TILES - 1) / HEAD_TILES);
  head_kernel<<<head_grid, HEAD_TILES * QT, head_smem, s>>>(
      h_out, Cw, Cb, pm, pse, pv, pi, R, H, V, n_tiles, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  merge_kernel<<<(R + 7) / 8, 256, 0, s>>>(pm, pse, pv, pi, logp, idx, R,
                                           n_tiles, k);
  return cudaGetLastError();
}
