// K6: one attention beam step with an exact top-k over the vocabulary, for
// the StyleNet+Att (factored cell) and NIC+Att (torch LSTM cell) decoders.
//
// Replaces icee_tpu/ops/pallas_att_decode.py::fused_att_decode_step_topk
// (:201; kernel _kernel :164 with _attend_block :46, _factored_cell_block
// :130, _lstm_cell_block :150, _head_topk :109): re-attention -> x = [emb;
// gate * ctx] -> cell -> head h' C_w + C_b over V -> exact top-k (lowest
// vocab index on ties) -> log-softmax values of those k, plus h', c' and
// the attention weights alpha.  Rows are image-major (image i's k beam slots contiguous), as
// decode/beam.py::beam_search_batched holds them; the TPU wrapper's
// beam-major permutation and vocab padding were layout devices of the TPU
// and are not carried over.
//
// Two paths, chosen by the shape (one image whose products fit the
// column-split launches' shared memory: column-split, else many-row); a
// row's outputs are the same bits on both.
//
// What bounds it on the H100: at the batched shape (64 images x 5 beams,
// E + FS = 2348, F = H = A = 512, P = 196, V = 8192) operations, ~28 MFLOP
// a row.  At the serial shape (one image's 5 rows) every weight (~56 MB for
// the factored cell, ~45 MB for the LSTM cell) is read for 5 rows: bytes,
// 0.017 / 0.014 ms.  The column-split path (split_step.cuh: pre, scores,
// ctx, then the cell's, logits and reduce launches, 8 factored / 6 lstm)
// takes that call, spreading every product's columns over the card; it is
// bound by its sequential fmaf chains, ~0.085 / ~0.070 ms (NVIDIA H100
// 80GB HBM3, 700.00 W).
//
// Many-row design (every other shape; step_kernels.cuh has the products):
//   1. pre: one product launch over all R rows of att2 = h dec_w + dec_b,
//      the gate's pre-activation h f_beta_w + f_beta_b and the cell's h
//      product (h W_w + W_b, or h W_hh);
//   2. scores: a block per (image, group of up to 8 of its rows, 8
//      positions), a warp a position (att_common.cuh att_score), the
//      group's att2 rows in shared memory (where a group's rows outgrow a
//      block's, A past ~7,264, in column pieces of a multiple of 128, each
//      row's chain carried from piece to piece in the same order); it also
//      copies the embedding into x = [emb; gate * ctx] (R, round4(E + FS));
//   3. context: a block per (image, group, 256 feature columns): the
//      group's softmax (softmax_row, in every block; the first writes
//      alpha), then ctx = alpha feat as dot4 chains over P, times
//      sigmoid(gate pre-activation), into x;
//   4-. the cell's products over x (input width E + FS) and its gates, the
//      head's product and the reduce, as K1 runs them (step_kernels.cuh).
// Each output is one fixed chain (att_score, softmax_row and dot4; one k
// order, the bias adds after), so a row's outputs are the same bits as on the column-split
// path and in K7.  The attention launches are cut by positions and by
// feature columns so that one image's rows still fill the card.
#include "att_common.cuh"
#include "split_step.cuh"
#include "step_kernels.cuh"

namespace icee {

constexpr int ATT_SCORE_WARPS = 8;   // positions a scores block
constexpr int CTX_THREADS = 64;      // column quads a context block

// Columns of att2 the scores launch stages at once for a group of `rows`
// rows: all of round4(A) where they fit a block, else the widest multiple
// of 128 that does (each lane's quads a, a + 128, ... then fall in the same
// order, piece after piece).
inline int att_scores_cols(int rows, int A) {
  const size_t fit = STEP_SMEM_MAX / (sizeof(float) * (size_t)rows);
  return (size_t)round4(A) <= fit ? round4(A) : (int)(fit / 128 * 128);
}

// Shared memory (bytes) of the scores launch (the group's att2 rows, or a
// piece of their columns) and of the context launch (the group's scores,
// then weights), for `rows` rows of a group.
inline size_t att_scores_smem(int rows, int A) {
  return sizeof(float) * (size_t)rows * att_scores_cols(rows, A);
}
inline size_t att_ctx_smem(int rows, int P) {
  return sizeof(float) * (size_t)rows * round4(P);
}

// Block (image, row group, positions blockIdx.z ATT_SCORE_WARPS ..): a
// warp a position's scores for the group's rows; blocks of blockIdx.z 0
// also copy the rows' embedding into xf[:, :E].  ac: att2's columns staged
// at once (att_scores_cols); below A, the pieces [a0, a0 + ac) in turn,
// each lane's chain e[r] running on over them as att_score runs it over
// all of A (the same fmaf order, then the same butterfly sum and bias).
__global__ void __launch_bounds__(ATT_SCORE_WARPS * 32)
att_scores_kernel(const float* __restrict__ x,
                  const float* __restrict__ att2, AttWeights w,
                  const float* __restrict__ att1, float* scores, float* xf,
                  int ldx, int E, int k, int ac) {
  extern __shared__ __align__(16) float smem[];   // (rows, min(A, ac))
  const int A = w.A, P = w.P, img = blockIdx.x;
  const int rows = min(ATT_ROWS, k - (int)blockIdx.y * ATT_ROWS);
  const size_t r0 = (size_t)img * k + (size_t)blockIdx.y * ATT_ROWS;
  if (blockIdx.z == 0)
    for (int i = threadIdx.x; i < rows * E; i += blockDim.x) {
      const int r = i / E, e = i % E;
      xf[(r0 + r) * ldx + e] = x[(r0 + r) * E + e];
    }
  const int p = blockIdx.z * ATT_SCORE_WARPS + (threadIdx.x >> 5);
  if (ac >= A) {
    for (int i = threadIdx.x; i < rows * A / 4; i += blockDim.x)
      reinterpret_cast<float4*>(smem)[i] =
          reinterpret_cast<const float4*>(att2 + r0 * A)[i];
    __syncthreads();
    if (p < P)   // whole warps
      att_score<ATT_ROWS>(att1 + ((size_t)img * P + p) * A, w, smem, A,
                          rows, scores + r0 * P + p, P);
    return;
  }
  const int lane = threadIdx.x & 31;
  const float* a1 = att1 + ((size_t)img * P + (p < P ? p : 0)) * A;
  float e[ATT_ROWS];
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) e[r] = 0.f;
  for (int a0 = 0; a0 < A; a0 += ac) {
    const int na = min(ac, A - a0);   // a multiple of 4 (A is)
    __syncthreads();                  // the last piece is read
    for (int i = threadIdx.x; i < rows * (na / 4); i += blockDim.x) {
      const int r = i / (na / 4), q = i % (na / 4);
      reinterpret_cast<float4*>(smem + (size_t)r * ac)[q] =
          reinterpret_cast<const float4*>(att2 + (r0 + r) * A + a0)[q];
    }
    __syncthreads();
    if (p >= P) continue;   // whole warps; every thread meets the barriers
    for (int a = a0 + 4 * lane; a < a0 + na; a += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(a1 + a));
      const float4 fw = __ldg(reinterpret_cast<const float4*>(w.fullw + a));
#pragma unroll
      for (int r = 0; r < ATT_ROWS; ++r) {
        if (r < rows) {
          const float4 d = *reinterpret_cast<const float4*>(
              smem + (size_t)r * ac + (a - a0));
          e[r] = fmaf(fmaxf(v.x + d.x, 0.f), fw.x, e[r]);
          e[r] = fmaf(fmaxf(v.y + d.y, 0.f), fw.y, e[r]);
          e[r] = fmaf(fmaxf(v.z + d.z, 0.f), fw.z, e[r]);
          e[r] = fmaf(fmaxf(v.w + d.w, 0.f), fw.w, e[r]);
        }
      }
    }
  }
  if (p >= P) return;
  const float fb = w.fullb[0];
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) {
    if (r < rows) {
      const float sum = warp_sum(e[r]);
      if (lane == 0) scores[(r0 + r) * P + p] = sum + fb;
    }
  }
}

// Block (image, row group, column quads blockIdx.z CTX_THREADS ..): the
// group's softmax over P (blocks of blockIdx.z 0 write alpha), then a
// thread a quad of ctx = alpha feat, xf[:, E + col] = sigmoid(gate
// pre-activation) * ctx.
__global__ void __launch_bounds__(CTX_THREADS)
att_ctx_kernel(const float* __restrict__ scores,
               const float* __restrict__ gpre,
               const float* __restrict__ feats, AttWeights w, float* xf,
               int ldx, int E, float* alpha_out, int k) {
  extern __shared__ __align__(16) float smem[];   // (rows, round4(P))
  const int P = w.P, Pp = round4(P), FS = w.FS, img = blockIdx.x;
  const int rows = min(ATT_ROWS, k - (int)blockIdx.y * ATT_ROWS);
  const size_t r0 = (size_t)img * k + (size_t)blockIdx.y * ATT_ROWS;
  for (int i = threadIdx.x; i < rows * P; i += CTX_THREADS) {
    const int r = i / P, p = i % P;
    smem[r * Pp + p] = scores[(r0 + r) * P + p];
  }
  __syncthreads();
  for (int r = threadIdx.x >> 5; r < rows; r += CTX_THREADS / 32)
    softmax_row(smem + r * Pp, P,
                blockIdx.z == 0 ? alpha_out + (r0 + r) * P : nullptr);
  __syncthreads();
  const int q = blockIdx.z * CTX_THREADS + threadIdx.x;
  if (q >= FS / 4) return;
  const int col = 4 * q;
  float acc[ATT_ROWS][4];
  dot4<ATT_ROWS>(smem, Pp, rows, feats + (size_t)img * P * FS, FS, col, P,
                 acc);
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r)
    if (r < rows)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t o = r0 + r;
        xf[o * ldx + E + col + j] =
            sigmoid(gpre[o * FS + col + j]) * acc[r][j];
      }
}

inline bool is_factored(const CellWeights&) { return true; }
inline bool is_factored(const LstmWeights&) { return false; }
inline int cell_f(const CellWeights& w) { return w.F; }
inline int cell_f(const LstmWeights& w) { return w.H; }

// Floats of the many-row path's work buffer (step_work).
inline long long att_work_floats(bool factored, int R, int E, int F, int H,
                                 int V, int A, int P, int FS, int ktop) {
  return step_work(nullptr, true, factored, R, E, F, H, V, A, P, FS, ktop)
      .floats;
}

}  // namespace icee

using namespace icee;

template <class W>
static int att_step(const float* x, const float* h, const float* c,
                    const float* feats, const float* att1, const AttWeights& aw,
                    const W& cw, const float* Cw, const float* Cb,
                    float* h_out, float* c_out, float* logp, int* idx,
                    float* alpha, float* work, int n_img, int k, int E,
                    int V, int ktop, void* stream) {
  const int H = aw.H, A = aw.A, P = aw.P, FS = aw.FS;
  if (n_img <= 0 || k < 1 || k > 65535 * ATT_ROWS || ktop < 1 || ktop > V ||
      A % 4 || FS % 4 || H % 4 || V % 4 || P < 1 || cw.E != E + FS ||
      (long long)n_img * k > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int R = n_img * k, rows = k < ATT_ROWS ? k : ATT_ROWS;
  const size_t ssmem = att_scores_smem(rows, A), csmem = att_ctx_smem(rows, P);
  if (ssmem > STEP_SMEM_MAX || csmem > STEP_SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StepWork w = step_work(work, true, is_factored(cw), R, E,
                               cell_f(cw), H, V, A, P, FS, ktop);
  const int ldx = round4(E + FS);
  GemmLaunch pre = {};
  pre.M = R;
  pre.n_jobs = 3;
  pre.job[0] = gemm_job(h, H, H, aw.decw, A, A, aw.decb, w.att2, A);
  pre.job[1] = gemm_job(h, H, H, aw.fbw, FS, FS, aw.fbb, w.gpre, FS);
  pre.job[2] = cell_h_job(h, cw, w);
  cudaError_t e = launch_gemm(pre, s);
  if (e != cudaSuccess) return e;
  const int groups = (k + ATT_ROWS - 1) / ATT_ROWS;
  if ((e = allow_smem(reinterpret_cast<const void*>(att_scores_kernel),
                      ssmem)) != cudaSuccess)
    return e;
  att_scores_kernel<<<dim3(n_img, groups,
                           (P + ATT_SCORE_WARPS - 1) / ATT_SCORE_WARPS),
                      ATT_SCORE_WARPS * 32, ssmem, s>>>(
      x, w.att2, aw, att1, w.sc, w.xf, ldx, E, k, att_scores_cols(rows, A));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = allow_smem(reinterpret_cast<const void*>(att_ctx_kernel),
                      csmem)) != cudaSuccess)
    return e;
  att_ctx_kernel<<<dim3(n_img, groups, (FS / 4 + CTX_THREADS - 1) /
                                           CTX_THREADS),
                   CTX_THREADS, csmem, s>>>(w.sc, w.gpre, feats, aw, w.xf, ldx,
                                            E, alpha, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = launch_cell_rest(w.xf, ldx, cw, c, w, h_out, c_out, R, false, s);
  if (e != cudaSuccess) return e;
  return launch_head(h_out, H, Cw, Cb, w, R, V, ktop, logp, idx, s);
}

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory (bytes) of the larger of the many-row path's scores and
// context launches for a group of `rows` rows, for the wrapper's mirror.
extern "C" long long icee_att_attend_smem(int rows, int A, int P) {
  const size_t a = att_scores_smem(rows, A), b = att_ctx_smem(rows, P);
  return (long long)(a > b ? a : b);
}

// gemm_pick for the wrapper's mirror (decode_step.gemm_pick), as
// decode_step.cu's icee_step_gemm_pick.
extern "C" int icee_step_gemm_pick(int M, int n_jobs, const int* N,
                                   const int* nseg, int sms) {
  if (n_jobs < 1 || n_jobs > MAX_GEMM_JOBS) return -1;
  return gemm_pick(M, n_jobs, N, nseg, sms);
}

// Floats of the many-row path's work buffer (F = H for the lstm cell).
extern "C" long long icee_att_step_work(int factored, int R, int E, int F,
                                        int H, int V, int A, int P, int FS,
                                        int ktop) {
  return att_work_floats(factored != 0, R, E, F, H, V, A, P, FS, ktop);
}

// Shared memory (bytes) of the column-split path's largest launch for one
// image's k rows: above a block's, the wrapper takes the many-row path.
extern "C" long long icee_att_step_split_smem(int factored, int k, int E,
                                              int F, int H, int A, int P,
                                              int FS) {
  return (long long)split_att_smem(factored != 0, k, E, F, H, A, P, FS);
}

// Rows R = n_img * k, image-major, k <= 65535 groups of 8.  x (R, E); h,
// c (R, H); feats (n_img, P, FS); att1 (n_img, P, A); alpha (R, P); work
// icee_att_step_work floats.  V_w has E + FS rows.  Returns 0 or the first
// CUDA error of the launches.
extern "C" int icee_att_decode_step_topk(
    const float* x, const float* h, const float* c, const float* feats,
    const float* att1, const float* decw, const float* decb,
    const float* fullw, const float* fullb, const float* fbw,
    const float* fbb, const float* Vw, const float* Vb, const float* Sw,
    const float* Sb, const float* Uw, const float* Ub, const float* Ww,
    const float* Wb, const float* Cw, const float* Cb, float* h_out,
    float* c_out, float* logp, int* idx, float* alpha, float* work,
    int n_img, int k, int E, int F, int H, int V, int A, int P, int FS,
    int ktop, void* stream) {
  if (F % 4) return cudaErrorInvalidValue;
  const AttWeights aw{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS};
  return att_step(x, h, c, feats, att1, aw,
                  CellWeights{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E + FS, F, H},
                  Cw, Cb, h_out, c_out, logp, idx, alpha, work, n_img, k, E,
                  V, ktop, stream);
}

extern "C" int icee_att_decode_step_topk_lstm(
    const float* x, const float* h, const float* c, const float* feats,
    const float* att1, const float* decw, const float* decb,
    const float* fullw, const float* fullb, const float* fbw,
    const float* fbb, const float* Wih, const float* bih, const float* Whh,
    const float* bhh, const float* Cw, const float* Cb, float* h_out,
    float* c_out, float* logp, int* idx, float* alpha, float* work,
    int n_img, int k, int E, int H, int V, int A, int P, int FS, int ktop,
    void* stream) {
  const AttWeights aw{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS};
  return att_step(x, h, c, feats, att1, aw,
                  LstmWeights{Wih, bih, Whh, bhh, E + FS, H}, Cw, Cb, h_out,
                  c_out, logp, idx, alpha, work, n_img, k, E, V, ktop,
                  stream);
}

// The column-split path (split_step.cuh) for ONE image's k <= 8 rows (a
// top-k up to V): the same outputs, bit for bit, as the calls above, with
// the same arguments but for work (icee_att_step_split_work floats, then
// for ktop > KWIDE 1 + 2 k ktop floats of survivors, cand_after) in place
// of x_full, the partials and the logits; feats (1, P, FS), att1
// (1, P, A).
extern "C" long long icee_att_step_split_work(int factored, int k, int F,
                                              int H, int V, int A, int P,
                                              int FS) {
  return split_att_work(factored != 0, k, F, H, V, A, P, FS);
}

static bool split_shape_ok(int k, int ktop, const AttWeights& aw, int V) {
  return k >= 1 && k <= SPLIT_ROWS && ktop >= 1 && ktop <= V && aw.A % 4 == 0 && aw.FS % 4 == 0 && aw.H % 4 == 0 &&
         V % 4 == 0;
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
