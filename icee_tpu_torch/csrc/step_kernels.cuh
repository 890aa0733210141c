// The three launches of one decode step (cell, per-tile head partials,
// merge), shared by K1 (decode_step.cu, the FactoredLSTM step) and K6
// (att_decode_step.cu, whose cell input is [emb; gated context]).  The cell
// launch is a template over the weight set (CellWeights or LstmWeights).
// Above KMAX (a top-k of 9 to KWIDE) the head writes the logits to device
// memory (head_logits_kernel) and wide_topk.cuh's reduce launch takes each
// row's logZ and top-k from there.
//
// The cell launch holds a block's rows' planes (input, h, two scratch
// planes of 4F or 4H) in shared memory: 8 rows a block where they fit (E_in
// + H + 8 max(F, H) floats a row: K1 to H = 772 at E = 300, K6 to H = 544
// at E + FS = 2,348), else 4, 2 or 1 (cell_rows, a template instance
// each).  A row's arithmetic is the same chain in every instance, so the
// rows a block holds change no bit.  The head launch holds 16 rows of h
// (and, at k <= KMAX, their logits tiles): H up to ~2,600.
#pragma once

#include "decode_common.cuh"
#include "wide_topk.cuh"

namespace icee {

constexpr int CELL_ROWS = 8;   // most rows of a cell block
constexpr int HEAD_ROWS = 16;
constexpr int HEAD_TILES = 4;  // vocab tiles per head block
constexpr int CELL_THREADS = 512;
constexpr size_t STEP_SMEM_MAX = 232448;  // bytes of shared memory a block

// Shared memory (bytes) of a cell block of `rows` rows: input width e_in,
// hidden width H, scratch planes ld (cell_ld) wide.
__host__ __device__ inline size_t cell_smem(int rows, int e_in, int H,
                                            int ld) {
  return sizeof(float) * rows * (round4(e_in) + round4(H) + 2 * (size_t)ld);
}

// Rows a cell block holds: 8, else the most of 4, 2, 1 whose planes fit;
// 0 where not even one row's do.
__host__ __device__ inline int cell_rows(int e_in, int H, int ld) {
  for (int r = CELL_ROWS; r >= 1; r /= 2)
    if (cell_smem(r, e_in, H, ld) <= STEP_SMEM_MAX) return r;
  return 0;
}

// Shared memory (bytes) of a head block: 16 rows of h and, at k <= KMAX,
// their logits tiles.
__host__ __device__ inline size_t head_smem(int H, int k) {
  return sizeof(float) * HEAD_ROWS *
         (round4(H) + (k > KMAX ? 0 : (size_t)HEAD_TILES * VT));
}

template <class W, int ROWS>
__global__ void __launch_bounds__(CELL_THREADS)
cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
            const float* __restrict__ c, W w, float* h_out, float* c_out,
            int R) {
  extern __shared__ __align__(16) float smem[];
  const int Ep = round4(w.E), Hp = round4(w.H), ld = cell_width(w);
  float* xs = smem;
  float* hs = xs + ROWS * Ep;
  float* s1 = hs + ROWS * Hp;
  float* s2 = s1 + ROWS * ld;
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, R - r0);
  for (int i = threadIdx.x; i < rows * Ep; i += blockDim.x) {
    const int r = i / Ep, e = i % Ep;
    xs[i] = e < w.E ? x[(size_t)(r0 + r) * w.E + e] : 0.f;
  }
  for (int i = threadIdx.x; i < rows * Hp; i += blockDim.x) {
    const int r = i / Hp, j = i % Hp;
    hs[i] = j < w.H ? h[(size_t)(r0 + r) * w.H + j] : 0.f;
  }
  __syncthreads();
  cell_step<ROWS>(xs, Ep, hs, Hp, c + (size_t)r0 * w.H, w.H, w, s1, s2, ld,
                  rows, h_out + (size_t)r0 * w.H, w.H,
                  c_out + (size_t)r0 * w.H, w.H);
}

// The cell launch at `rows` (cell_rows) rows a block.
template <class W, int ROWS>
cudaError_t launch_cell(const float* x, const float* h, const float* c,
                        const W& w, float* h_out, float* c_out, int R,
                        cudaStream_t s) {
  const size_t smem = cell_smem(ROWS, w.E, w.H, cell_width(w));
  cudaError_t e = cudaFuncSetAttribute(
      cell_kernel<W, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cell_kernel<W, ROWS><<<(R + ROWS - 1) / ROWS, CELL_THREADS, smem, s>>>(
      x, h, c, w, h_out, c_out, R);
  return cudaGetLastError();
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

// The wide head (k > KMAX): the head kernel's grid and products, each
// logits quad written to lg (R, ld), ld = n_tiles * VT (columns past V
// hold NEG), with no per-tile reduction.
__global__ void __launch_bounds__(HEAD_TILES * QT)
head_logits_kernel(const float* __restrict__ h, const float* __restrict__ Cw,
                   const float* __restrict__ Cb, float* lg, int ld, int R,
                   int H, int V) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = round4(H);
  float* hs = smem;
  const int r0 = blockIdx.x * HEAD_ROWS;
  const int rows = min(HEAD_ROWS, R - r0);
  for (int i = threadIdx.x; i < rows * Hp; i += blockDim.x) {
    const int r = i / Hp, j = i % Hp;
    hs[i] = j < H ? h[(size_t)(r0 + r) * H + j] : 0.f;
  }
  __syncthreads();
  const int col = (blockIdx.y * HEAD_TILES + threadIdx.x / QT) * VT +
                  4 * (threadIdx.x % QT);
  if (col < ld)
    head_quad<HEAD_ROWS>(hs, Hp, rows, Cw, Cb, H, V, col,
                         lg + (size_t)r0 * ld + col, ld);
}

// The cell (x of width w.E), head and merge launches on the caller's
// stream.  Partials: pm, pse (R, n_tiles); pv, pi (R, n_tiles, k), n_tiles =
// ceil(V / 256).  Above KMAX the head writes the logits to lg (R, n_tiles *
// 256; unused, and may be null, at k <= KMAX) and the merge is the wide
// reduce, above KWIDE with its survivors after the logits (lg then holds
// R n_tiles 256 floats and 2 wide_cand_pairs(R, k) more); the partials
// are not used.  Returns the first CUDA error of the
// three launches.
template <class W>
cudaError_t launch_step_topk(const float* x, const float* h, const float* c,
                             const W& w, const float* Cw, const float* Cb,
                             float* h_out, float* c_out, float* logp,
                             int* idx, float* pm, float* pse, float* pv,
                             int* pi, float* lg, int R, int V, int k,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + VT - 1) / VT;
  cudaError_t e;
  if (k > KMAX && lg == nullptr) return cudaErrorInvalidValue;
  if (head_smem(w.H, k) > STEP_SMEM_MAX) return cudaErrorInvalidValue;

  switch (cell_rows(w.E, w.H, cell_width(w))) {
    case 8: e = launch_cell<W, 8>(x, h, c, w, h_out, c_out, R, s); break;
    case 4: e = launch_cell<W, 4>(x, h, c, w, h_out, c_out, R, s); break;
    case 2: e = launch_cell<W, 2>(x, h, c, w, h_out, c_out, R, s); break;
    case 1: e = launch_cell<W, 1>(x, h, c, w, h_out, c_out, R, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;

  const dim3 head_grid((R + HEAD_ROWS - 1) / HEAD_ROWS,
                       (n_tiles + HEAD_TILES - 1) / HEAD_TILES);
  if (k > KMAX) {
    const int ld = n_tiles * VT;
    const size_t smem = head_smem(w.H, k);
    e = cudaFuncSetAttribute(head_logits_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    head_logits_kernel<<<head_grid, HEAD_TILES * QT, smem, s>>>(
        h_out, Cw, Cb, lg, ld, R, w.H, V);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    // above KWIDE the reduce's survivors follow the logits in lg
    return launch_wide_reduce(
        lg, ld, R, V, k, logp, idx,
        k > KWIDE ? reinterpret_cast<unsigned long long*>(lg + (size_t)R * ld)
                  : nullptr,
        s);
  }
  const size_t hsmem = head_smem(w.H, k);
  e = cudaFuncSetAttribute(head_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)hsmem);
  if (e != cudaSuccess) return e;
  head_kernel<<<head_grid, HEAD_TILES * QT, hsmem, s>>>(
      h_out, Cw, Cb, pm, pse, pv, pi, R, w.H, V, n_tiles, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  merge_kernel<<<(R + 7) / 8, 256, 0, s>>>(pm, pse, pv, pi, logp, idx, R,
                                           n_tiles, k);
  return cudaGetLastError();
}

}  // namespace icee

