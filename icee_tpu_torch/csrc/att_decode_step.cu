// K6: one attention beam step with an exact top-k over the vocabulary, for
// the StyleNet+Att (factored cell) and NIC+Att (torch LSTM cell) decoders.
//
// Replaces icee_tpu/ops/pallas_att_decode.py::fused_att_decode_step_topk
// (:201; kernel _kernel :164 with _attend_block :46, _factored_cell_block
// :130, _lstm_cell_block :150, _head_topk :109): re-attention -> x = [emb;
// gate * ctx] -> cell -> head h' C_w + C_b over V -> exact top-k (lowest
// vocab index on ties) -> log-softmax values of those k, plus h', c' and
// the attention weights alpha.  The (R, V) logits never reach device
// memory.  Rows are image-major (image i's k beam slots contiguous), as
// decode/beam.py::beam_search_batched holds them; the TPU wrapper's
// beam-major permutation and vocab padding were layout devices of the TPU
// and are not carried over.
//
// Two paths, chosen by the shape alone (one image: column-split, several:
// row-tiled); a row's outputs are the same bits on both.
//
// What bounds it on the H100: at the batched shape (64 images x 5 beams,
// E + FS = 2348, F = H = A = 512, P = 196, V = 8192) operations, ~28 MFLOP
// a row; the row-tiled design keeps every load a float4 with 8 in flight
// per thread (decode_common.cuh dot4) and writes only x, h', c', alpha and
// the top-k partials to device memory.  At the serial shape (one image's 5
// rows) every weight (~56 MB for the factored cell, ~45 MB for the LSTM
// cell) is read for 5 rows: bytes, 0.017 / 0.014 ms.  The row-tiled path
// gave that call one attention block and one cell block (0.85 / 0.65 ms);
// the column-split path (split_step.cuh: pre, scores, ctx, then the cell's,
// logits and reduce launches, 8 factored / 6 lstm) spreads every product's
// columns over the card and is bound by its sequential fmaf chains, ~0.085
// / ~0.070 ms (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Row-tiled design: four launches on the caller's stream.
//   1. attention: one block per image (its k <= 8 rows), att_common.cuh
//      attend_rows; the image's att1 and features stream from L2/HBM (one
//      image's features are 1.6 MB, far above a block's shared memory, so
//      nothing of the TPU kernel's VMEM residency carries over).  Writes
//      x_full = [emb; gate * ctx] (R, E + FS) and alpha (R, P).
//   2-4. K1's cell, head and merge launches (step_kernels.cuh) with input
//      width E + FS, the cell a template over the weight set.
#include "att_common.cuh"
#include "split_step.cuh"
#include "step_kernels.cuh"

namespace icee {

constexpr int ATT_THREADS = 512;

__global__ void __launch_bounds__(ATT_THREADS)
att_kernel(const float* __restrict__ x, const float* __restrict__ h,
           AttWeights w, const float* __restrict__ feats,
           const float* __restrict__ att1, float* x_full, float* alpha_out,
           int E, int k) {
  extern __shared__ __align__(16) float smem[];
  const int H = w.H, Hp = round4(H), ldx = E + w.FS;
  float* hs = smem;              // (k, Hp)
  float* scratch = hs + k * Hp;  // attend_rows' att2 and alpha
  const int img = blockIdx.x;
  const size_t r0 = (size_t)img * k;
  for (int i = threadIdx.x; i < k * Hp; i += blockDim.x) {
    const int r = i / Hp, j = i % Hp;
    hs[i] = j < H ? h[(r0 + r) * H + j] : 0.f;
  }
  for (int i = threadIdx.x; i < k * E; i += blockDim.x) {
    const int r = i / E, e = i % E;
    x_full[(r0 + r) * ldx + e] = x[(r0 + r) * E + e];
  }
  __syncthreads();
  attend_rows<ATT_ROWS>(hs, Hp, k, w, feats + (size_t)img * w.P * w.FS,
                        att1 + (size_t)img * w.P * w.A, scratch,
                        x_full + r0 * ldx + E, ldx, alpha_out + r0 * w.P);
}

}  // namespace icee

using namespace icee;

template <class W>
static int att_step(const float* x, const float* h, const float* c,
                    const float* feats, const float* att1, const AttWeights& aw,
                    const W& w, const float* Cw, const float* Cb,
                    float* x_full, float* h_out, float* c_out, float* logp,
                    int* idx, float* alpha, float* pm, float* pse, float* pv,
                    int* pi, int n_img, int k, int E, int V, int ktop,
                    void* stream) {
  if (n_img <= 0 || k < 1 || k > ATT_ROWS || ktop < 1 || ktop > KMAX ||
      aw.A % 4 || aw.FS % 4 || aw.H % 4 || V % 4 || w.E != E + aw.FS)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (k * round4(aw.H) + att_scratch(aw, k));
  cudaError_t e = cudaFuncSetAttribute(
      att_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  att_kernel<<<n_img, ATT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, h, aw, feats, att1, x_full, alpha, E, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_step_topk(x_full, h, c, w, Cw, Cb, h_out, c_out, logp, idx,
                          pm, pse, pv, pi, n_img * k, V, ktop, stream);
}

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory (bytes) of the cell launch, the largest of the four, for
// the wrapper's checks: input width E + FS; the LSTM cell's planes are
// those of F = H.
extern "C" long long icee_att_step_smem(int E, int F, int H, int FS) {
  return (long long)(sizeof(float) * CELL_ROWS *
                     (round4(E + FS) + round4(H) + 2 * (size_t)cell_ld(F, H)));
}

// Rows R = n_img * k, image-major.  x (R, E); h, c (R, H); feats (n_img, P,
// FS); att1 (n_img, P, A); x_full (R, E + FS) scratch; alpha (R, P);
// partials pm, pse (R, n_tiles), pv, pi (R, n_tiles, ktop).  V_w has E + FS
// rows.  Returns 0 or the first CUDA error of the four launches.
extern "C" int icee_att_decode_step_topk(
    const float* x, const float* h, const float* c, const float* feats,
    const float* att1, const float* decw, const float* decb,
    const float* fullw, const float* fullb, const float* fbw,
    const float* fbb, const float* Vw, const float* Vb, const float* Sw,
    const float* Sb, const float* Uw, const float* Ub, const float* Ww,
    const float* Wb, const float* Cw, const float* Cb, float* x_full,
    float* h_out, float* c_out, float* logp, int* idx, float* alpha,
    float* pm, float* pse, float* pv, int* pi, int n_img, int k, int E,
    int F, int H, int V, int A, int P, int FS, int ktop, void* stream) {
  if (F % 4) return cudaErrorInvalidValue;
  const AttWeights aw{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS};
  return att_step(x, h, c, feats, att1, aw,
                  CellWeights{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E + FS, F, H},
                  Cw, Cb, x_full, h_out, c_out, logp, idx, alpha, pm, pse, pv,
                  pi, n_img, k, E, V, ktop, stream);
}

extern "C" int icee_att_decode_step_topk_lstm(
    const float* x, const float* h, const float* c, const float* feats,
    const float* att1, const float* decw, const float* decb,
    const float* fullw, const float* fullb, const float* fbw,
    const float* fbb, const float* Wih, const float* bih, const float* Whh,
    const float* bhh, const float* Cw, const float* Cb, float* x_full,
    float* h_out, float* c_out, float* logp, int* idx, float* alpha,
    float* pm, float* pse, float* pv, int* pi, int n_img, int k, int E,
    int H, int V, int A, int P, int FS, int ktop, void* stream) {
  const AttWeights aw{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS};
  return att_step(x, h, c, feats, att1, aw,
                  LstmWeights{Wih, bih, Whh, bhh, E + FS, H}, Cw, Cb, x_full,
                  h_out, c_out, logp, idx, alpha, pm, pse, pv, pi, n_img, k,
                  E, V, ktop, stream);
}

// The column-split path (split_step.cuh) for ONE image's k <= 8 rows: the
// same outputs, bit for bit, as the calls above, with the same arguments
// but for work (icee_att_step_split_work floats) in place of x_full and the
// partials; feats (1, P, FS), att1 (1, P, A).
extern "C" long long icee_att_step_split_work(int factored, int k, int F,
                                              int H, int V, int A, int P,
                                              int FS) {
  return split_att_work(factored != 0, k, F, H, V, A, P, FS);
}

static bool split_shape_ok(int k, int ktop, const AttWeights& aw, int V) {
  return k >= 1 && k <= SPLIT_ROWS && ktop >= 1 && ktop <= KMAX &&
         aw.A % 4 == 0 && aw.FS % 4 == 0 && aw.H % 4 == 0 && V % 4 == 0;
}

extern "C" int icee_att_decode_step_topk_split(
    const float* x, const float* h, const float* c, const float* feats,
    const float* att1, const float* decw, const float* decb,
    const float* fullw, const float* fullb, const float* fbw,
    const float* fbb, const float* Vw, const float* Vb, const float* Sw,
    const float* Sb, const float* Uw, const float* Ub, const float* Ww,
    const float* Wb, const float* Cw, const float* Cb, float* h_out,
    float* c_out, float* logp, int* idx, float* alpha, float* work, int k,
    int E, int F, int H, int V, int A, int P, int FS, int ktop,
    void* stream) {
  const AttWeights aw{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS};
  if (!split_shape_ok(k, ktop, aw, V) || F % 4) return cudaErrorInvalidValue;
  return launch_split_att(
      x, h, c, feats, att1, aw,
      CellWeights{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E + FS, F, H}, Cw, Cb,
      h_out, c_out, logp, idx, alpha, work, k, E, V, ktop, stream);
}

extern "C" int icee_att_decode_step_topk_lstm_split(
    const float* x, const float* h, const float* c, const float* feats,
    const float* att1, const float* decw, const float* decb,
    const float* fullw, const float* fullb, const float* fbw,
    const float* fbb, const float* Wih, const float* bih, const float* Whh,
    const float* bhh, const float* Cw, const float* Cb, float* h_out,
    float* c_out, float* logp, int* idx, float* alpha, float* work, int k,
    int E, int H, int V, int A, int P, int FS, int ktop, void* stream) {
  const AttWeights aw{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS};
  if (!split_shape_ok(k, ktop, aw, V)) return cudaErrorInvalidValue;
  return launch_split_att(x, h, c, feats, att1, aw,
                          LstmWeights{Wih, bih, Whh, bhh, E + FS, H}, Cw, Cb,
                          h_out, c_out, logp, idx, alpha, work, k, E, V, ktop,
                          stream);
}
