// K2: the whole k-beam search in one launch, for the StyleNet FactoredLSTM
// or the NIC decoder's torch LSTM cell.
//
// Replaces icee_tpu/ops/pallas_beam.py::mega_beam_decode (the TPU kernel
// _kernel at :54 with _beam_select at :244), cell="factored" (:110-128)
// and cell="lstm" (:129-143).  Semantics are those of
// decode/beam.py::beam_search_batched, in both feed_feature modes (serving:
// the image feature is the step-1 input; research: <start>'s embedding
// is): the step-1 single-row special case, rank < n_alive candidate
// validity, candidate order p*k + q over the k x k merge, strict->
// best-completed tracking with the list-order tie-break, length = t + 2,
// the [<end>] fallback (length 1, score -1e30).
//
// What bounds it on the H100: by the roofline, operations (a step of one
// row is 15.9 MFLOP factored, 11.7 lstm, at E = 300, F = H = 512, V =
// 8192).  At one image the work is ~0.1 GFLOP a step and what bounds it is
// latency: each output is one fmaf chain of up to 512 steps (812 for the
// LSTM gates), a step runs its stages one after another, and each chunk of
// a chain pays a fixed cost (its copies' issue, a block barrier).  At 64
// images the products run at ~30-40 fmaf a clock an SM, a third of its
// peak (scripts/probe_grid_beam.py): a thread's 2 x 4 tile takes a
// shared-memory load for every 3-4 fmaf.
//
// Design: ONE search spreads every step over the whole card.  The launch
// is cooperative, one block per SM (as many as co-reside), persistent over
// all steps; the blocks meet at a grid barrier (grid_common.cuh) between
// the stages of a step (the machinery, shared with K7, is grid_beam.cuh):
//   factored: [x V_w + V_b, h W_w + W_b] | v_g S_g + S_b | (s_g U_g + U_b)
//             + hW, then the cell | logits | tile partials | beam tail
//   lstm:     (x W_ih + b_ih) + h W_hh + b_hh, then the cell | logits |
//             tile partials | beam tail
// A product stage cuts its output columns into slabs (the table of
// ops/beam.py::grid_plan: 64 columns where a launch has rows enough to fill
// the grid so, else about one slab a block; a gate stage's slab holds the
// same columns of all four gates, so the block can run the cell on them)
// and the live rows into blocks of at most `br`; a block takes units
// (slab, row block) in turn.  Only live rows run: every block compacts the
// rows whose beam is alive (step 1: slot 0 of each image) at the start of
// a step, so the work follows each image's own length.  A block streams its
// units' weights and input rows, 64 k rows a chunk, through a ring of four
// shared-memory chunks by cp.async (three in flight, the next unit's while
// this one finishes); a thread owns 4 adjacent columns of one or two rows
// and runs each output's fmaf chain from shared memory.  Where a step's
// live rows reach a stage's threshold (ops/beam.py::plan_tiles, from the
// card's stage times) the stage runs in tiles of 128 live rows by 128
// columns instead, 4 x 8 outputs a thread in registers (grid_beam.cuh
// run_tiles; not the LSTM cell's two chains): at 900-2,048 live rows the
// slabs read each weight chunk once per 52 rows and a shared-memory load
// every 5 fmaf.  A launch whose plan has no tiles runs the instantiation
// without them.  Intermediates (v,
// hW, s, h', c', the logits, the tile partials) live in device memory (L2)
// and are read across a barrier through L2 only (cp.async.cg, __ldcg).  The
// tile partials stage takes every 256-wide logits tile of every live row
// through tile_reduce, a warp a tile; the beam tail runs each image in one
// block (merge_row of its live rows, the selection, the sequences,
// best-completed tracking).  Once no beam is alive every block leaves after
// the barrier.
//
// Beam widths above 8, up to V (wide_topk.cuh): the products do not
// depend on k (a launch holds at most MAX_ROWS = 1024 rows, so 4 images at
// k = 256, or one image of any k: ops/beam.py::launch_chunks splits a
// batch); the tile partials and tail give way to a row stage (a block a
// live row: logZ as merge_row takes it, the row's top-k by a radix select,
// into device memory) and a wide tail (an image's k x k candidates
// selected the same way from L2, the sequences double-buffered in device
// memory, so no tail state grows with k or L in shared memory).  The same
// wide selection takes k <= 8 where the narrow tail's partials outgrow the
// ring (V above ~80k).  Above KWIDE = 256 (SEL_SCAN) the survivors, and
// past MAX_ROWS rows the row lists, sit in device memory
// (grid_beam.cuh).  One instantiation a selection kind, so the narrower
// ones compile as they did.
//
// Bits: every output is the same sequential fmaf chain in k order from 0.f
// as dot4's (decode_common.cuh), with the same bias adds after and the same
// cell arithmetic, built with -fmad=false; a chain's k range is never
// split.  So a row's h', c', logits and top-k are those of K1 (both of its
// paths) and do not depend on the grid's size or on which rows share a
// step; the serving engine's serial and batched paths return the same
// captions.
#include "grid_beam.cuh"

namespace icee {

// The launch plan (ops/beam.py::GridPlan mirrors it field by field).
struct GridPlan {
  long long cell, E, F, H, V, k, n_img, max_seq, start, end, feed;
  long long Vp, n_tiles, grid, n_stages;
  long long cw[MAX_STAGES], br[MAX_STAGES], n_slabs[MAX_STAGES],
      slab0[MAX_STAGES];
  // the tile geometry: each stage's tile slabs, the first of them in the
  // slab table, and the least live rows that take them (0: none)
  long long t_slabs[MAX_STAGES], t_slab0[MAX_STAGES], t_min[MAX_STAGES];
  // float scratch offsets
  long long o_v, o_hw, o_s, o_hn, o_cn, o_logits, o_pm, o_pse, o_pv,
      o_scores, o_bscore;
  // int scratch offsets; SEL_SCAN's (grid_beam.cuh GridArgs) are 0 where
  // the plan has no such region
  long long o_pi, o_alive, o_word, o_prev, o_seqs, o_steps, o_bar, o_cand,
      o_lists, o_tstate;
};

template <int SEL, bool TILES>
__global__ void __launch_bounds__(GB_THREADS, 1)
grid_beam_kernel(const __grid_constant__ GridArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Job jobs[MAX_JOBS];        // read every chunk: kept on chip
  __shared__ Stage stages[MAX_STAGES];
  const Smem sm = carve_lists<SEL>(smem, a);
  load_plan(a, jobs, stages);
  init_search_state(a);

  unsigned gen = 0;
  for (int t = 0; t <= a.max_seq; ++t) {
    StepCtx c = step_ctx(a, t);
    gb_mark(-1);
    scan_rows(a, sm, c);
    if (c.n == 0) break;  // the same count in every block
    for (int s = 0; s < a.n_stages; ++s) {
      run_stage<TILES>(a, stages[s], sm, c);
      grid_sync(a.bar, gen);
      gb_stage(s, c.n, TILES && stage_geo(stages[s], c.n));
    }
    run_selection<SEL>(a, sm, c, gen);
  }
}

}  // namespace icee

using namespace icee;

// The launch: the plan's shared fields (search_args), then K2's step-1
// inputs; the slab table (device memory) is the wrapper's.
static int launch(const GridPlan& p, const int* slabs, const float* feats,
                  const float* emb, GridArgs& a, float* fs, int* is, int* tok,
                  int* len, float* score, void* stream) {
  if (p.feed && feats == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = search_args(a, p, slabs, fs, is, tok, len, score);
  if (e != cudaSuccess) return e;
  a.feats = p.feed ? feats : nullptr;
  a.emb = emb;
  a.feed = (int)p.feed;
  const void* kernel =
      has_tiles(p)
          ? sel_kernel(
                p, reinterpret_cast<const void*>(grid_beam_kernel<SEL_NARROW, true>),
                reinterpret_cast<const void*>(grid_beam_kernel<SEL_WIDE, true>),
                reinterpret_cast<const void*>(grid_beam_kernel<SEL_SCAN, true>))
          : sel_kernel(
                p, reinterpret_cast<const void*>(grid_beam_kernel<SEL_NARROW, false>),
                reinterpret_cast<const void*>(grid_beam_kernel<SEL_WIDE, false>),
                reinterpret_cast<const void*>(grid_beam_kernel<SEL_SCAN, false>));
  return grid_launch(kernel, a, (int)p.grid, stream);
}

// The search's profile marks (grid_beam.cuh gb_mark): out (8 words, or
// null) <- the sums so far, then zeroed, the marks on where on != 0.
extern "C" int icee_grid_profile(int on, unsigned long long* out) {
  return (int)grid_profile(on, out);
}

// The profile's stage records (grid_beam.cuh g_gb_rec): *n <- their count,
// out (2 * cap words) <- the first cap.
extern "C" int icee_grid_records(unsigned long long* out, int cap, int* n) {
  return (int)grid_records(out, cap, n);
}

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernel's dynamic shared memory (bytes) and its geometry, for the
// wrapper's plan: {smem, threads, KC, KCP, NSLOT, SLOT_FLOATS, MAX_ROWS,
// KWIDE, TOPK_FLOATS, MAX_K}.
extern "C" void icee_mega_beam_consts(long long* out) {
  out[0] = (long long)grid_smem_bytes();
  out[1] = GB_THREADS;
  out[2] = KC;
  out[3] = KCP;
  out[4] = NSLOT;
  out[5] = SLOT_FLOATS;
  out[6] = MAX_ROWS;
  out[7] = KWIDE;
  out[8] = TOPK_FLOATS;
  out[9] = MAX_K;
}

// Blocks of one cooperative launch on the current device (every
// instantiation).
extern "C" int icee_mega_beam_max_grid(int* out) {
  int plain = 0, tiled = 0;
  cudaError_t e = static_cast<cudaError_t>(grid_max_blocks3(
      reinterpret_cast<const void*>(grid_beam_kernel<SEL_NARROW, false>),
      reinterpret_cast<const void*>(grid_beam_kernel<SEL_WIDE, false>),
      reinterpret_cast<const void*>(grid_beam_kernel<SEL_SCAN, false>),
      &plain));
  if (e == cudaSuccess)
    e = static_cast<cudaError_t>(grid_max_blocks3(
        reinterpret_cast<const void*>(grid_beam_kernel<SEL_NARROW, true>),
        reinterpret_cast<const void*>(grid_beam_kernel<SEL_WIDE, true>),
        reinterpret_cast<const void*>(grid_beam_kernel<SEL_SCAN, true>),
        &tiled));
  *out = plain < tiled ? plain : tiled;
  return (int)e;
}

// factored: stages [x V_w + V_b, h W_w + W_b] | v_g S_g + S_b | the gates
// (s_g U_g + U_b + hW, then the cell) | logits.  fs holds v (rows, 4F), hw
// (rows, 4H) and s (rows, 4F) at the plan's offsets.
extern "C" int icee_mega_beam_decode(
    const GridPlan* plan, const int* slabs, const float* feats,
    const float* emb, const float* Vw, const float* Vb, const float* Sw,
    const float* Sb, const float* Uw, const float* Ub, const float* Ww,
    const float* Wb, const float* Cw, const float* Cb, float* fs, int* is,
    int* tok, int* len, float* score, void* stream) {
  const GridPlan& p = *plan;
  if (p.cell != 0 || p.n_stages != 4) return cudaErrorInvalidValue;
  const int E = (int)p.E, F = (int)p.F, H = (int)p.H, V = (int)p.V;
  float* v = fs + p.o_v;
  float* hw = fs + p.o_hw;
  float* s = fs + p.o_s;
  GridArgs a = {};
  a.jobs[0] = bias_job(Vw, 0, 4 * F, E, 1, 4 * F, A_X, nullptr, 0, 0, Vb, v,
                       4 * F);
  a.jobs[1] = bias_job(Ww, 0, 4 * H, H, 1, 4 * H, A_HPREV, nullptr, 0, 0, Wb,
                       hw, 4 * H);
  a.jobs[2] = bias_job(Sw, (long long)F * F, F, F, 4, F, A_DENSE, v, 4 * F,
                       F, Sb, s, 4 * F);
  Job z = bias_job(Uw, (long long)F * H, H, F, 4, H, A_DENSE, s, 4 * F, F, Ub,
                   nullptr, 0);
  z.gates = 1;
  z.epi = E_GATES_F;
  z.hw = hw;
  a.jobs[3] = z;
  a.jobs[4] = bias_job(Cw, 0, V, H, 1, V, A_HCUR, nullptr, 0, 0, Cb,
                       fs + p.o_logits, (int)p.Vp);
  a.n_jobs = 5;
  stage_of(a, 0, 0, 2);
  stage_of(a, 1, 2, 1);
  stage_of(a, 2, 3, 1);
  stage_of(a, 3, 4, 1);
  return launch(p, slabs, feats, emb, a, fs, is, tok, len, score, stream);
}

// lstm: stages ((x W_ih + b_ih) + h W_hh) + b_hh, then the cell | logits.
extern "C" int icee_mega_beam_decode_lstm(
    const GridPlan* plan, const int* slabs, const float* feats,
    const float* emb, const float* Wih, const float* bih, const float* Whh,
    const float* bhh, const float* Cw, const float* Cb, float* fs, int* is,
    int* tok, int* len, float* score, void* stream) {
  const GridPlan& p = *plan;
  if (p.cell != 1 || p.n_stages != 2) return cudaErrorInvalidValue;
  const int E = (int)p.E, H = (int)p.H, V = (int)p.V;
  GridArgs a = {};
  Job g = bias_job(Wih, H, 4 * H, E, 4, H, A_X, nullptr, 0, 0, bih, nullptr,
                   0);
  g.gates = 1;
  g.epi = E_GATES_L;
  g.W2 = Whh;
  g.K2 = H;
  g.amode2 = A_HPREV;
  g.bias2 = bhh;
  a.jobs[0] = g;
  a.jobs[1] = bias_job(Cw, 0, V, H, 1, V, A_HCUR, nullptr, 0, 0, Cb,
                       fs + p.o_logits, (int)p.Vp);
  a.n_jobs = 2;
  stage_of(a, 0, 0, 1);
  stage_of(a, 1, 1, 1);
  return launch(p, slabs, feats, emb, a, fs, is, tok, len, score, stream);
}
