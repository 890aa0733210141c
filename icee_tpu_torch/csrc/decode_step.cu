// K1: one FactoredLSTM decode step with an exact top-k over the vocabulary.
//
// Replaces icee_tpu/ops/pallas_decode.py::fused_decode_step_topk (the TPU
// kernel _kernel at :191): cell -> head h' @ C_w + C_b over V -> exact
// top-k (lowest vocab index on ties) -> log-softmax values of those k, plus
// h' and c'.
//
// Two paths, chosen by the shape (R <= 8 rows whose products fit the
// column-split launches' shared memory: column-split, else many-row); a
// row's outputs are the same bits on both.
//
// Many-row, for the batched shapes (step_kernels.cuh, shared with K6, the
// attention step).  What bounds it on the H100: operations.  At R = 320
// rows (E = 300, F = H = 512, V = 8192) one step is 5.1 GFLOP of float32
// multiply-adds against ~32 MB of weights, far above the card's
// operations-per-byte line; float32 is kept (no TF32) so the port matches
// the JAX package to 1e-5 and K2 to the bit.  What the design does about
// it: each product is one register-tiled launch over all R rows (a block a
// tile of up to 128 rows x 128 columns, 8 x 8 outputs a thread, the k
// tiles staged by cp.async), so each weight tile is read once per tile of
// rows.  Six launches: {x V_w + V_b, h W_w + W_b}, the style product, the
// U product with the W sum, the gates, the head's logits (R, V) into
// device memory, then the tile partials and merge (k <= 8) or the wide
// reduce (wide_topk.cuh, a block a row: logZ as the merge takes it, the
// top-k by a radix select, above KWIDE = 256 with the survivors in device
// memory after the logits).  The logits and logZ are the same bits either
// way, so are the log-probs.
//
// Column-split (split_step.cuh), for one image's k <= 8 beam rows, the
// serial serving path: every product's columns spread over the card; the
// sequential fmaf chains bound it (~0.040 ms against a 0.0095 ms bytes
// bound at 5 rows; NVIDIA H100 80GB HBM3, 700.00 W).  Five launches: pre,
// style, gates, logits, reduce.
#include "split_step.cuh"
#include "step_kernels.cuh"

using namespace icee;

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// work: icee_decode_step_work floats (step_kernels.cuh step_work).
// Returns 0 or the first CUDA error of the launches.
extern "C" int icee_decode_step_topk(
    const float* x, const float* h, const float* c, const float* Vw,
    const float* Vb, const float* Sw, const float* Sb, const float* Uw,
    const float* Ub, const float* Ww, const float* Wb, const float* Cw,
    const float* Cb, float* h_out, float* c_out, float* logp, int* idx,
    float* work, int R, int E, int F, int H, int V, int k, void* stream) {
  if (R <= 0 || E <= 0 || k < 1 || k > V || F % 4 || H % 4 || V % 4)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CellWeights cw{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E, F, H};
  const StepWork w = step_work(work, false, true, R, E, F, H, V, 0, 0, 0, k);
  GemmLaunch pre = {};
  pre.M = R;
  pre.n_jobs = 2;
  pre.job[0] = gemm_job(x, E, E, Vw, 4 * F, 4 * F, Vb, w.v, 4 * F);
  pre.job[1] = cell_h_job(h, cw, w);
  cudaError_t e = launch_gemm(pre, s);
  if (e != cudaSuccess) return e;
  e = launch_cell_rest(x, E, cw, c, w, h_out, c_out, R, true, s);
  if (e != cudaSuccess) return e;
  return launch_head(h_out, H, Cw, Cb, w, R, V, k, logp, idx, s);
}

// Floats of the many-row path's work buffer.
extern "C" long long icee_decode_step_work(int R, int E, int F, int H, int V,
                                           int k) {
  return step_work(nullptr, false, true, R, E, F, H, V, 0, 0, 0, k).floats;
}

// The tile shape gemm_pick gives a product launch of M rows and n_jobs
// products of N[j] columns x nseg[j] segments on `sms` SMs, and the
// shared memory of a block of each shape: for the wrapper's mirror
// (decode_step.gemm_pick, gemm_smem).
extern "C" int icee_step_gemm_pick(int M, int n_jobs, const int* N,
                                   const int* nseg, int sms) {
  if (n_jobs < 1 || n_jobs > MAX_GEMM_JOBS) return -1;
  return gemm_pick(M, n_jobs, N, nseg, sms);
}

extern "C" long long icee_step_gemm_smem(int cfg) {
  return cfg >= 0 && cfg < GEMM_CONFIGS ? (long long)gemm_smem(cfg) : -1;
}

// Shared memory (bytes) of the column-split path's largest product launch
// at R rows: above a block's, the wrapper takes the many-row path.
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
