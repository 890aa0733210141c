// K7: the whole attention beam search in one launch, for the StyleNet+Att
// (factored cell) and NIC+Att (torch LSTM cell) decoders.
//
// Replaces icee_tpu/ops/pallas_att_decode.py::mega_att_beam_decode (:733),
// both of its calls: the resident one (:974, kernel _mega_att_kernel :418)
// and the P-streamed one (:907, kernel _mega_att_kernel_streamed :533),
// with their shared tail _head_select_embed_phase (:334).  The two TPU
// calls compute the same function and differ only in where the features
// live (VMEM-resident, or streamed in P tiles from HBM) and so in the P
// contraction order of the context.  On the H100 that is not a choice:
// one image's features (1.6 MB) never fit a block's 227 KB of shared
// memory, so they stream from L2/HBM every step either way, and this one
// kernel is the counterpart of both calls.
//
// Semantics: the research beam of decode/beam.py::beam_search_batched over
// factored_att_decode_step / rnn_att_decode_step: h0/c0 from the mean
// spatial feature (init_hidden_state), step 1 embeds <start> (the image enters
// only through h0/c0 and the attention context), each step re-attends with
// the current h, then K2's beam tail.
//
// What bounds it on the H100: by the roofline, operations (~28 MFLOP per
// row-step for the factored cell, ~24 for the LSTM cell, at E = 300, F = H
// = A = 512, P = 196, FS = 2048, V = 8192) or, at one image, the ~53 MB of
// weights a step reads.  At a few images what bounds it is latency: a step
// runs its stages one after another and each output is one fmaf chain (x
// V_w is 2,348 deep).  At 64 images the features and att1 of every image
// (2 MB an image, 128 MB in all) stream from HBM every step.
//
// Design: K2's (grid_beam.cuh), extended with the attention's stages.  ONE
// cooperative launch, one block per SM, persistent over the search; a grid
// barrier between the stages of a step, in the order of K6's column-split
// path (split_step.cuh):
//   init (step 1 only, after the mean of each image's P feature rows): h0 =
//        mean init_h + b, c0 = mean init_c + b, into step 1's h, c rows
//   pre: att2 = h dec_w + dec_b, gpre = h f_beta_w + f_beta_b, the cell's h
//        product (factored h W_w + W_b, lstm h W_hh), and the embedding rows
//        [0, E) of x V_w / x W_ih, kept as a float32 partial
//   scores: e = relu(att1_p + att2) full_w + full_b (att_score), a warp a
//        position, units (image, positions) with the image's live rows
//   ctx: units (image, column slab) of the image's own features: the
//        softmax over P of its rows' scores in every block (softmax_row),
//        then sum_p alpha_p feat_p as one chain in P order, times
//        sigmoid(gpre)
//   factored: vrows (x V_w's rows E.. resumed from the partial, + V_b) |
//        style (v_g S_g + S_b) | gates ((s_g U_g + U_b) + hW, then the cell)
//   lstm: gates (x W_ih's rows E.. resumed, ((. + b_ih) + h W_hh) + b_hh,
//        then the cell)
//   logits | tile partials | beam tail (merge_row, the selection, the
//        sequences, best-completed tracking; emb[word] is next step's x)
// Only live rows run (step 1: slot 0 of each image); the per-image stages
// take only images with a live row.  att1 = features enc_w + enc_b stays a
// plain product outside the kernel, as in the JAX package.
//
// Bits: every output is the chain K6 computes for it (attend_rows' and
// dot4's k order from 0.f; x V_w resumed at k = E from its partial, as K6's
// column-split path does; the same bias adds after), built with
// -fmad=false, and no chain's k range is split across blocks.  So the
// fused-step path (K6 per step from att_init_state's h0/c0) and this
// kernel give a beam the same scores bit for bit, at any grid size.
//
// Also here, the fused-step path's h0/c0 (icee_att_init_state, for
// ops/att_decode_step.py::att_init_state): this kernel's own mean
// (run_mean) and init stage, alone, over the whole card, so that path
// starts from this kernel's bits.  What bounds it: bytes, the features
// (1.6 MB an image) and the two weights (8.4 MB), ~3 us at one image and
// ~33 us at 64; at one image also the 2,048-long fmaf chains
// (~4 us at 2 GHz), which stay whole, so the init stage's 64 units of 16
// columns stream their 64-row k chunks through the ring while each chain
// runs in one thread.  Two launches, the mean's then the stage's (one
// cooperative launch with a grid barrier between them took about the same
// device time and needs a zeroed barrier word every call).
#include "grid_beam.cuh"

namespace icee {

// The launch plan (ops/att_beam.py::AttGridPlan mirrors it field by
// field).  Stages: the step's, then the init stage.
struct AttGridPlan {
  long long kind, E, F, H, V, A, P, FS, k, n_img, max_seq, start, end;
  long long Vp, n_tiles, grid, n_stages, pu, upi;
  long long cw[MAX_STAGES], br[MAX_STAGES], n_slabs[MAX_STAGES],
      slab0[MAX_STAGES];
  // float scratch offsets
  long long o_att2, o_gpre, o_hw, o_xpart, o_esc, o_ctx, o_v, o_s, o_hn,
      o_cn, o_logits, o_pm, o_pse, o_pv, o_scores, o_bscore, o_mean;
  // int scratch offsets
  long long o_pi, o_alive, o_word, o_prev, o_seqs, o_steps, o_bar;
};

// The plan of the h0/c0 launch (ops/att_beam.py::_CInitPlan mirrors it
// field by field): its one product stage, the search's init stage, and
// the mean's offset in the float scratch.
struct AttInitPlan {
  long long H, P, FS, n_img, grid, n_stages;
  long long cw[MAX_STAGES], br[MAX_STAGES], n_slabs[MAX_STAGES],
      slab0[MAX_STAGES];
  long long o_mean;
};

// The mean of each image's P feature rows (a sequential sum over P, then
// / P), a thread a column quad; 8 rows' loads in
// flight ahead of their adds.
__device__ void run_mean(const GridArgs& a) {
  const int nq = a.FS / 4, P = a.P;
  for (int task = blockIdx.x * GB_THREADS + threadIdx.x; task < a.n_img * nq;
       task += gridDim.x * GB_THREADS) {
    const int img = task / nq, q = task % nq;
    const float4* f =
        reinterpret_cast<const float4*>(a.afeats + (size_t)img * P * a.FS) + q;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    int p = 0;
    for (; p + 8 <= P; p += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldg(f + (size_t)(p + u) * nq);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
    for (; p < P; ++p) {
      const float4 v = __ldg(f + (size_t)p * nq);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    float* m = a.mean + (size_t)img * a.FS + 4 * q;
    m[0] = s.x / (float)P;
    m[1] = s.y / (float)P;
    m[2] = s.z / (float)P;
    m[3] = s.w / (float)P;
  }
}

// The scores stage: units (live image, `pu` positions); a unit stages its
// image's live rows of att2 in the ring, then each warp scores positions
// (att_score: a lane's chain over its A quads, the butterfly, the bias).
__device__ void run_scores(const GridArgs& a, const Smem& sm,
                           const StepCtx& c) {
  const int warp = threadIdx.x >> 5, A = a.A, Ap = round4(A);
  const AttWeights aw{nullptr, nullptr, a.fullw, a.fullb, nullptr, nullptr,
                      a.H, A, a.P, a.FS};
  float* att2 = sm.ring;  // (KMAX, Ap)
  for (int u = blockIdx.x; u < c.n_img * a.upi; u += gridDim.x) {
    const int li = u / a.upi, part = u % a.upi;
    const int img = sm.img[li], i0 = sm.ifirst[li], m = sm.icount[li];
    for (int e = threadIdx.x; e < m * (A / 4); e += GB_THREADS) {
      const int r = e / (A / 4), q = e % (A / 4);
      cp_async16(att2 + r * Ap + 4 * q, a.att2 + (size_t)(i0 + r) * A + 4 * q);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int p1 = min(a.P, (part + 1) * a.pu);
    for (int p = part * a.pu + warp; p < p1; p += GB_WARPS)
      att_score<KMAX>(a.att1 + ((size_t)img * a.P + p) * A, aw, att2, Ap, m,
                      a.esc + (size_t)i0 * a.P + p, a.P);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(GB_THREADS, 1)
grid_att_kernel(const __grid_constant__ GridArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Job jobs[MAX_JOBS];        // read every chunk: kept on chip
  __shared__ Stage stages[MAX_STAGES];
  const Smem sm = carve_smem(smem);
  load_plan(a, jobs, stages);
  init_search_state(a);

  unsigned gen = 0;
  run_mean(a);
  grid_sync(a.bar, gen);
  const int init = a.n_stages - 1;  // h0, c0: step 1 only
  for (int t = 0; t <= a.max_seq; ++t) {
    StepCtx c = step_ctx(a, t);
    scan_rows(a, sm, c);
    if (c.n == 0) break;  // the same count in every block
    for (int s = t == 0 ? -1 : 0; s < init; ++s) {
      run_stage(a, stages[s < 0 ? init : s], sm, c);
      grid_sync(a.bar, gen);
      if (s == 0) {  // after pre: the attention scores
        run_scores(a, sm, c);
        grid_sync(a.bar, gen);
      }
    }
    run_partials(a, sm, c.n);
    grid_sync(a.bar, gen);
    run_tail(a, sm, c);
    grid_sync(a.bar, gen);
  }
}

// The fused-step path's h0/c0, one launch a part: part 0 the mean, part 1
// the init stage (every image live with one row, its compact row).
__global__ void __launch_bounds__(GB_THREADS, 1)
grid_att_init_kernel(const __grid_constant__ GridArgs a, int part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Job jobs[MAX_JOBS];
  __shared__ Stage stages[MAX_STAGES];
  if (part == 0) {
    run_mean(a);
    return;
  }
  const Smem sm = carve_smem(smem);
  load_plan(a, jobs, stages);
  StepCtx c = step_ctx(a, 0);
  c.n = a.n_img;
  run_stage(a, stages[0], sm, c);
}

}  // namespace icee

using namespace icee;

// The init stage's two jobs: h0 = mean init_h_w + init_h_b and c0 alike,
// row i of each at out + i * ldo.
static void init_jobs(Job* j, const float* mean, int FS, int H,
                      const float* ihw, const float* ihb, const float* icw,
                      const float* icb, float* h0, float* c0, int ldo) {
  j[0] = bias_job(ihw, 0, H, FS, 1, H, A_DENSE, mean, FS, 0, ihb, h0, ldo);
  j[1] = bias_job(icw, 0, H, FS, 1, H, A_DENSE, mean, FS, 0, icb, c0, ldo);
}

// The jobs both cells share: pre's att2 and gpre (jobs 0, 1; the cell's
// two are jobs 2, 3), ctx (job 4), and the init stage's h0 and c0 (the
// last two jobs, from `init`).
static void attention_jobs(GridArgs& a, const AttGridPlan& p, float* fs,
                           const float* feats, const float* decw,
                           const float* decb, const float* fbw,
                           const float* fbb, const float* ihw,
                           const float* ihb, const float* icw,
                           const float* icb, int init) {
  const int H = (int)p.H, A = (int)p.A, FS = (int)p.FS, P = (int)p.P;
  const int rows = (int)(p.n_img * p.k);
  a.jobs[0] = bias_job(decw, 0, A, H, 1, A, A_HPREV, nullptr, 0, 0, decb,
                       fs + p.o_att2, A);
  a.jobs[1] = bias_job(fbw, 0, FS, H, 1, FS, A_HPREV, nullptr, 0, 0, fbb,
                       fs + p.o_gpre, FS);
  Job ctx = bias_job(feats, 0, FS, P, 1, FS, A_ALPHA, nullptr, 0, 0, nullptr,
                     fs + p.o_ctx, FS);
  ctx.wimg = (long long)P * FS;
  ctx.epi = E_CTX;
  ctx.hw = fs + p.o_gpre;
  a.jobs[4] = ctx;
  // step 1's h and c rows (row img * k of the parity-1 planes; the live
  // rows of step 1 are the images, in order)
  const size_t plane = (size_t)rows * H;
  init_jobs(a.jobs + init, fs + p.o_mean, FS, H, ihw, ihb, icw, icb,
            fs + p.o_hn + plane, fs + p.o_cn + plane, (int)p.k * H);
}

// The launch: the plan's shared fields (search_args), then the
// attention's; the slab table is the wrapper's.
static int att_launch(const AttGridPlan& p, const int* slabs,
                      const float* feats, const float* att1,
                      const float* emb, const float* fullw,
                      const float* fullb, GridArgs& a, float* fs, int* is,
                      int* tok, int* len, float* score, void* stream) {
  if (p.A < 4 || p.A % 4 || KMAX * p.A > RING_FLOATS || p.FS < 4 ||
      p.FS % 4 || p.P < 1 || p.P > MAX_P || p.pu < 1 || p.upi < 1 ||
      p.pu * p.upi < p.P)
    return cudaErrorInvalidValue;
  cudaError_t e = search_args(a, p, slabs, fs, is, tok, len, score);
  if (e != cudaSuccess) return e;
  a.emb = emb;
  a.afeats = feats;
  a.att1 = att1;
  a.att2 = fs + p.o_att2;
  a.fullw = fullw;
  a.fullb = fullb;
  a.esc = fs + p.o_esc;
  a.mean = fs + p.o_mean;
  a.att = 1;
  a.A = (int)p.A;
  a.P = (int)p.P;
  a.FS = (int)p.FS;
  a.pu = (int)p.pu;
  a.upi = (int)p.upi;
  return grid_launch(reinterpret_cast<const void*>(grid_att_kernel), a,
                     (int)p.grid, stream);
}

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernel's dynamic shared memory (bytes) and its geometry, for the
// wrapper's plan: {smem, threads, KC, KCP, NSLOT, SLOT_FLOATS, MAX_ROWS,
// MAX_P, KMAX}.
extern "C" void icee_mega_att_beam_consts(long long* out) {
  out[0] = (long long)grid_smem_bytes();
  out[1] = GB_THREADS;
  out[2] = KC;
  out[3] = KCP;
  out[4] = NSLOT;
  out[5] = SLOT_FLOATS;
  out[6] = MAX_ROWS;
  out[7] = MAX_P;
  out[8] = KMAX;
}

// Blocks of one cooperative launch on the current device.
extern "C" int icee_mega_att_beam_max_grid(int* out) {
  return grid_max_blocks(reinterpret_cast<const void*>(grid_att_kernel),
                         out);
}

// factored: stages pre | ctx | vrows | style | gates | logits | init (and
// the scores stage after pre).  feats (n_img, P, FS), att1 (n_img, P, A),
// emb (V, E); V_w has E + FS rows; fs and is are the plan's scratch.
extern "C" int icee_mega_att_beam_decode(
    const AttGridPlan* plan, const int* slabs, const float* feats,
    const float* att1, const float* emb, const float* decw,
    const float* decb, const float* fullw, const float* fullb,
    const float* fbw, const float* fbb, const float* ihw, const float* ihb,
    const float* icw, const float* icb, const float* Vw, const float* Vb,
    const float* Sw, const float* Sb, const float* Uw, const float* Ub,
    const float* Ww, const float* Wb, const float* Cw, const float* Cb,
    float* fs, int* is, int* tok, int* len, float* score, void* stream) {
  const AttGridPlan& p = *plan;
  if (p.kind != 0 || p.n_stages != 7) return cudaErrorInvalidValue;
  const int E = (int)p.E, F = (int)p.F, H = (int)p.H, V = (int)p.V;
  const int FS = (int)p.FS;
  GridArgs a = {};
  attention_jobs(a, p, fs, feats, decw, decb, fbw, fbb, ihw, ihb, icw, icb,
                 9);
  a.jobs[2] = bias_job(Ww, 0, 4 * H, H, 1, 4 * H, A_HPREV, nullptr, 0, 0, Wb,
                       fs + p.o_hw, 4 * H);
  a.jobs[3] = bias_job(Vw, 0, 4 * F, E, 1, 4 * F, A_X, nullptr, 0, 0, nullptr,
                       fs + p.o_xpart, 4 * F);
  Job v = bias_job(Vw + (size_t)E * 4 * F, 0, 4 * F, FS, 1, 4 * F, A_DENSE,
                   fs + p.o_ctx, FS, 0, Vb, fs + p.o_v, 4 * F);
  v.init = fs + p.o_xpart;
  v.ldi = 4 * F;
  a.jobs[5] = v;
  a.jobs[6] = bias_job(Sw, (long long)F * F, F, F, 4, F, A_DENSE, fs + p.o_v,
                       4 * F, F, Sb, fs + p.o_s, 4 * F);
  Job z = bias_job(Uw, (long long)F * H, H, F, 4, H, A_DENSE, fs + p.o_s,
                   4 * F, F, Ub, nullptr, 0);
  z.gates = 1;
  z.epi = E_GATES_F;
  z.hw = fs + p.o_hw;
  a.jobs[7] = z;
  a.jobs[8] = bias_job(Cw, 0, V, H, 1, V, A_HCUR, nullptr, 0, 0, Cb,
                       fs + p.o_logits, (int)p.Vp);
  a.n_jobs = 11;
  int j = stage_of(a, 0, 0, 4);   // pre
  j = stage_of(a, 1, j, 1, 1);    // ctx, per image
  j = stage_of(a, 2, j, 1);       // vrows
  j = stage_of(a, 3, j, 1);       // style
  j = stage_of(a, 4, j, 1);       // gates
  j = stage_of(a, 5, j, 1);       // logits
  stage_of(a, 6, j, 2);           // init
  return att_launch(p, slabs, feats, att1, emb, fullw, fullb, a, fs, is, tok,
                    len, score, stream);
}

// lstm: stages pre | ctx | gates | logits | init (and the scores stage
// after pre).
extern "C" int icee_mega_att_beam_decode_lstm(
    const AttGridPlan* plan, const int* slabs, const float* feats,
    const float* att1, const float* emb, const float* decw,
    const float* decb, const float* fullw, const float* fullb,
    const float* fbw, const float* fbb, const float* ihw, const float* ihb,
    const float* icw, const float* icb, const float* Wih, const float* bih,
    const float* Whh, const float* bhh, const float* Cw, const float* Cb,
    float* fs, int* is, int* tok, int* len, float* score, void* stream) {
  const AttGridPlan& p = *plan;
  if (p.kind != 1 || p.n_stages != 5 || p.F != p.H)
    return cudaErrorInvalidValue;
  const int E = (int)p.E, H = (int)p.H, V = (int)p.V, FS = (int)p.FS;
  GridArgs a = {};
  attention_jobs(a, p, fs, feats, decw, decb, fbw, fbb, ihw, ihb, icw, icb,
                 7);
  a.jobs[2] = bias_job(Whh, 0, 4 * H, H, 1, 4 * H, A_HPREV, nullptr, 0, 0,
                       nullptr, fs + p.o_hw, 4 * H);
  a.jobs[3] = bias_job(Wih, 0, 4 * H, E, 1, 4 * H, A_X, nullptr, 0, 0,
                       nullptr, fs + p.o_xpart, 4 * H);
  // W_ih's rows E.. as four gate segments of H columns, resumed from the
  // embedding rows' partial sums
  Job g = bias_job(Wih + (size_t)E * 4 * H, H, 4 * H, FS, 4, H, A_DENSE,
                   fs + p.o_ctx, FS, 0, bih, nullptr, 0);
  g.gates = 1;
  g.epi = E_GATES_R;
  g.hw = fs + p.o_hw;
  g.bias2 = bhh;
  g.init = fs + p.o_xpart;
  g.ldi = 4 * H;
  a.jobs[5] = g;
  a.jobs[6] = bias_job(Cw, 0, V, H, 1, V, A_HCUR, nullptr, 0, 0, Cb,
                       fs + p.o_logits, (int)p.Vp);
  a.n_jobs = 9;
  int j = stage_of(a, 0, 0, 4);   // pre
  j = stage_of(a, 1, j, 1, 1);    // ctx, per image
  j = stage_of(a, 2, j, 1);       // gates
  j = stage_of(a, 3, j, 1);       // logits
  stage_of(a, 4, j, 2);           // init
  return att_launch(p, slabs, feats, att1, emb, fullw, fullb, a, fs, is, tok,
                    len, score, stream);
}

// h0, c0 (n_img, H) of the attention search from feats (n_img, P, FS), as
// the search computes them before its first step: run_mean into fs + o_mean
// (n_img, FS), then the init stage, each over `grid` blocks.
extern "C" int icee_att_init_state(const AttInitPlan* plan, const int* slabs,
                                   const float* feats, const float* ihw,
                                   const float* ihb, const float* icw,
                                   const float* icb, float* h0, float* c0,
                                   float* fs, void* stream) {
  const AttInitPlan& p = *plan;
  if (p.n_img < 1 || p.n_img > MAX_ROWS || p.P < 1 || p.FS < 4 ||
      p.FS % 4 || p.H < 4 || p.H % 4 || p.grid < 1 || p.n_stages != 1)
    return cudaErrorInvalidValue;
  const int H = (int)p.H, FS = (int)p.FS;
  GridArgs a = {};
  init_jobs(a.jobs, fs + p.o_mean, FS, H, ihw, ihb, icw, icb, h0, c0, H);
  a.n_jobs = 2;
  stage_of(a, 0, 0, 2);
  cudaError_t e = set_stages(a, 1, p.cw, p.br, p.n_slabs, p.slab0, slabs);
  if (e != cudaSuccess) return e;
  a.afeats = feats;
  a.mean = fs + p.o_mean;
  a.n_img = (int)p.n_img;
  a.H = H;
  a.P = (int)p.P;
  a.FS = FS;
  const size_t smem = grid_smem_bytes();
  e = cudaFuncSetAttribute(grid_att_init_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  grid_att_init_kernel<<<(unsigned)p.grid, GB_THREADS, 0, st>>>(a, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  grid_att_init_kernel<<<(unsigned)p.grid, GB_THREADS, smem, st>>>(a, 1);
  return cudaGetLastError();
}
