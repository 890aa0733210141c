// K1: one FactoredLSTM decode step with an exact top-k over the vocabulary.
//
// Replaces icee_tpu/ops/pallas_decode.py::fused_decode_step_topk (the TPU
// kernel _kernel at :191): cell -> head h' @ C_w + C_b over V -> exact
// top-k (lowest vocab index on ties) -> log-softmax values of those k, plus
// h' and c'.  The (R, V) logits never reach device memory.
//
// Two paths, chosen by the shape (R <= 8 rows whose products fit the
// column-split launches' shared memory: column-split, else row-tiled); a
// row's outputs are the same bits on both.
//
// Row-tiled, for the batched shapes.  What bounds it on the H100:
// operations.  At R = 320 rows (E = 300, F = H = 512, V = 8192) one step is
// 5.1 GFLOP of float32 multiply-adds against ~32 MB of weights, far above
// the card's operations-per-byte line; float32 is kept (no TF32) so the
// port matches the JAX package to 1e-5.  What the design does about it:
// every weight float4 read from L2 feeds 4 columns x 8 or 16 rows of FMAs,
// and each thread keeps 8 such reads in flight (decode_common.cuh dot4).
//
// Column-split (split_step.cuh), for one image's k <= 8 beam rows, the
// serial serving path: there the row-tiled cell is one block streaming
// ~14 MB, so the split path spreads every product's columns over the card;
// the sequential fmaf chains bound it (~0.040 ms against a 0.0095 ms bytes
// bound at 5 rows; NVIDIA H100 80GB HBM3, 700.00 W).  Five launches: pre,
// style, gates, logits, reduce.
//
// Row-tiled design: three launches on the caller's stream (step_kernels.cuh,
// shared with K6, the attention step).
//   1. cell: one block per 8 rows (4, 2 or 1 where 8 rows' planes do not
//      fit: E = 300 and H from 773); each of the cell's stages spans all
//      four gates (4F or 4H output columns, one column quad per thread),
//      through shared-memory scratch planes.
//   2. head: grid (row blocks of 16) x (groups of 4 vocab tiles of 256).
//      Each block computes its logits tiles into shared memory and one warp
//      per (row, tile) reduces a tile to a partial (max, sum-exp, top-k).
//      Only the (R, n_tiles, k) partials are written.
//   3. merge: one warp per row combines the partials into logZ and the
//      exact top-k, and writes logp = value - logZ.
// A top-k above 8, up to V (wide_topk.cuh): the head writes the logits
// (R, V) to device memory instead of reducing its tiles, and a reduce
// launch of one block a row takes logZ the same way and the row's top-k by
// a radix select (the O(k V) picks of the two launches above are for k <=
// 8 only), above KWIDE = 256 with the survivors in device memory after the
// logits; the column-split path's reduce launch does the same on its
// logits.  The logits and logZ are the same bits, so are the log-probs.
// The simple first version uses CUDA-core fmaf; wgmma/TMA tiling is later
// work.
#include "split_step.cuh"
#include "step_kernels.cuh"

using namespace icee;

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Partials: pm, pse (R, n_tiles); pv, pi (R, n_tiles, k), n_tiles = ceil(V /
// 256); for k > KMAX instead lg (R, n_tiles * 256), the logits (the
// partials then unused), for k > KWIDE followed by 2 R k floats of the
// reduce's survivors.  Returns 0 or the first CUDA error of the three
// launches.
extern "C" int icee_decode_step_topk(
    const float* x, const float* h, const float* c, const float* Vw,
    const float* Vb, const float* Sw, const float* Sb, const float* Uw,
    const float* Ub, const float* Ww, const float* Wb, const float* Cw,
    const float* Cb, float* h_out, float* c_out, float* logp, int* idx,
    float* pm, float* pse, float* pv, int* pi, float* lg, int R, int E,
    int F, int H, int V, int k, void* stream) {
  if (R <= 0 || k < 1 || k > V || F % 4 || H % 4 || V % 4)
    return cudaErrorInvalidValue;
  return launch_step_topk(x, h, c,
                          CellWeights{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E, F, H},
                          Cw, Cb, h_out, c_out, logp, idx, pm, pse, pv, pi, lg,
                          R, V, k, stream);
}

// Rows a block of the row-tiled cell launch holds at input width E (8, 4,
// 2 or 1; 0: none fits), for the wrapper's mirror (decode_step.cell_rows).
extern "C" int icee_cell_rows(int E, int F, int H) {
  return cell_rows(E, H, cell_ld(F, H));
}

// Shared memory (bytes) of the column-split path's largest product launch
// at R rows: above a block's, the wrapper takes the row-tiled path.
extern "C" long long icee_decode_step_split_smem(int R, int E, int F, int H) {
  return (long long)split_k1_smem(R, E, F, H);
}

extern "C" long long icee_decode_step_split_work(int R, int F, int H, int V) {
  return split_k1_work(R, F, H, V);
}

// The column-split path (split_step.cuh) for R <= 8 rows, at any top-k up
// to V: the same outputs, bit for bit, as icee_decode_step_topk.  work:
// icee_decode_step_split_work floats, then for k > KWIDE 1 + 2 R k floats
// of the wide reduce's survivors (cand_after).  Returns 0 or the first CUDA error of
// the five launches.
extern "C" int icee_decode_step_topk_split(
    const float* x, const float* h, const float* c, const float* Vw,
    const float* Vb, const float* Sw, const float* Sb, const float* Uw,
    const float* Ub, const float* Ww, const float* Wb, const float* Cw,
    const float* Cb, float* h_out, float* c_out, float* logp, int* idx,
    float* work, int R, int E, int F, int H, int V, int k, void* stream) {
  if (R <= 0 || R > SPLIT_ROWS || k < 1 || k > V || F % 4 || H % 4 ||
      V % 4)
    return cudaErrorInvalidValue;
  return launch_split_k1(x, h, c,
                         CellWeights{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E, F, H},
                         Cw, Cb, h_out, c_out, logp, idx, work, R, V, k,
                         stream);
}
