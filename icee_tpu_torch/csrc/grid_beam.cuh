// The machinery of the whole-search kernels that spread each step of a
// beam search over the whole card: beam.cu (K2, the global-feature
// decoders) and att_beam.cu (K7, the attention decoders).
//
// A launch is cooperative, one block per SM, persistent over every step of
// the search; the blocks meet at a grid barrier (grid_common.cuh) between
// the stages of a step.  Each kernel names its own stage order; what they
// share is here:
//   - the live-row scan: every block compacts the rows whose beam is alive
//     (step 1: slot 0 of each image) at the start of a step, in row order,
//     and, where the kernel attends, the images that still have one;
//   - the product stage (run_stage): a stage's products (Job) cut their
//     output columns into slabs (the table of ops/beam.py::grid_plan and
//     ops/att_beam.py::att_grid_plan; a gate stage's slab holds the same
//     columns of all four gates, so the block runs the cell on them) and
//     the live rows into blocks of at most `br`; a block takes units (slab,
//     row block) in turn.  A per-image stage (K7's attention context, whose
//     weights are the image's own features) takes units (slab, live image)
//     with the image's live rows instead.  A block streams its units'
//     weights and input rows, 64 k rows a chunk, through a ring of four
//     shared-memory chunks by cp.async (three in flight, the next unit's
//     while this one finishes); a thread owns 4 adjacent columns of one or
//     two rows and runs each output's fmaf chain from shared memory.  A
//     chain may start from a stored partial (Job.init: the rows of x V_w /
//     x W_ih past the embedding, resumed at k = E), never from another
//     block's part of the same k range.  Where a step's live rows reach a
//     stage's threshold (the plan's, from the H100's stage times) the
//     stage runs in tiles instead (run_tiles): 128 live rows by 128
//     columns a unit (a gate tile: 32 columns of each gate), 4 x 8 outputs
//     a thread in registers, the same chains;
//   - the tile partials (run_partials: every 256-wide logits tile of every
//     live row through tile_reduce, a warp a tile) and the beam tail
//     (run_tail: each image in one block, merge_row of its live rows, the
//     selection, the sequences, best-completed tracking);
//   - above KMAX (k of 9 up to V, wide_topk.cuh; also at k <= KMAX where
//     the narrow tail's partials do not fit the ring, V above ~80k) the
//     row stage (run_rowsel: a block a live row, its logZ and exact top-k
//     into device memory) and the wide tail (run_tail_wide: each image in
//     one block, the top-k of its k x k candidates by block_topk, read
//     from L2, the sequences double-buffered in device memory); per-image
//     stages take a wide image's live rows in groups of at most KMAX
//     (scan_rows).  Above KWIDE (SCAN) each selection's survivors sit in a
//     block's own device-memory scratch (cand), the tail's slot state too
//     where it outgrows the ring (tstate), and an image of more than
//     MAX_ROWS rows (one image a launch) keeps each block's row lists in
//     device memory (lists) instead of shared memory.
// Intermediates live in device memory (L2) and are read across a barrier
// through L2 only (cp.async.cg, __ldcg); an image's search state has one
// owner block; no atomics touch data.  Once no beam is alive every block
// leaves after the barrier.
//
// Bits: every output is the same sequential fmaf chain in k order from 0.f
// (or from the stored partial of the same chain) as dot4's
// (decode_common.cuh), with the same bias adds after and the same cell
// arithmetic, built with -fmad=false; a chain's k range is never split
// across blocks.  So a row's h', c', logits and top-k are those of K1 and
// K6 (all of their paths) and do not depend on the grid's size or on which
// rows share a step.
#pragma once

#include "att_common.cuh"
#include "grid_common.cuh"
#include "wide_topk.cuh"

namespace icee {

constexpr int GB_THREADS = 512;
constexpr int GB_WARPS = GB_THREADS / 32;
constexpr int KC = 64;                 // k rows of a ring chunk
constexpr int KCP = KC + 4;            // row stride of a chunk's input rows
constexpr int NSLOT = 4;               // ring chunks (NSLOT - 1 in flight)
constexpr int SLOT_FLOATS = 7680;      // one chunk: weights, then input rows
constexpr int RING_FLOATS = NSLOT * SLOT_FLOATS;
constexpr int MAX_CW = 64;             // widest column slab
constexpr int MAX_BR = 64;             // most rows of a unit
constexpr int MAX_UNIT_ROWS = 128;     // input rows of a unit, all sets
constexpr int ZS_FLOATS = MAX_CW * MAX_BR;
constexpr int MAX_ROWS = 1024;         // rows (images x k) of one launch,
                                       // unless one image (SCAN)
constexpr int MAX_K = 46340;           // widest beam: k x k candidates
                                       // indexed by an int
constexpr int MAX_STAGES = 8;
constexpr int MAX_JOBS = 12;           // products of a launch, all stages
constexpr int TBM = 128;               // live rows of a tile
constexpr int TSLOTS = 3;              // the ring as tile chunks (TSLOTS - 1
                                       // in flight)
constexpr int TBN = 128;               // columns of a tile (a gate tile: 32
                                       // of each gate)
constexpr int MAX_P = 256;             // positions whose softmax rows sit
                                       // at the narrow stride ALD
constexpr int ALD = MAX_P + 4;         // row stride of a unit's softmax rows
constexpr int TSLOT_FLOATS = RING_FLOATS / TSLOTS;
// dynamic shared memory a search block may take (the block's own static
// plan copies, ~2 KB, take the rest of its 232,448 bytes)
constexpr size_t GRID_SMEM_MAX = 229376;

// The selection a launch runs (a kernel instantiation each): the tile
// partials and the narrow tail, the wide row stage and tail, or the same
// with survivors in device memory (k > KWIDE).
enum Sel { SEL_NARROW, SEL_WIDE, SEL_SCAN };

// A_ALPHA: the input rows are the unit's image's softmax rows (per-image
// stages), in shared memory for the whole unit
enum AMode { A_X, A_HPREV, A_HCUR, A_DENSE, A_ALPHA };
// E_GATES_R: the LSTM gates from a resumed x W_ih chain and a stored h
// W_hh; E_CTX: the attention context times sigmoid(its gate)
enum Epi { E_BIAS, E_GATES_F, E_GATES_L, E_GATES_R, E_CTX };

// One product of a stage: for segment s < nseg and column j < segw of it,
// the output of a live row is a chain over k < K of A[row][s * aseg + k] *
// W[img * wimg + s * wseg + k * ldw + j] (a gate product: then a second
// chain over K2 with W2 and amode2, the LSTM cell's h W_hh), from 0.f or
// from init[row][column], then the epilogue.
struct Job {
  const float* W;
  const float* W2;
  const float* A;       // A_DENSE: compact row i at A + i * lda
  const float* bias;    // E_BIAS (or null): (nseg * segw); gates: b1 (4H)
  const float* bias2;   // E_GATES_L, E_GATES_R: b_hh
  const float* hw;      // gates: (rows, 4H) the h product; E_CTX: (rows,
                        // ldo) the gate's pre-activation
  const float* init;    // null, or (rows, ldi): each chain's start
  float* out;           // E_BIAS, E_CTX: compact row i at out + i * ldo
  long long wseg, wimg;
  int ldw, K, K2, nseg, segw, gates, amode, amode2, lda, aseg, epi, ldo,
      ldi;
};

struct Stage {
  const Job* job;       // the stage's jobs (the kernel's shared copy)
  const int4* slabs;    // (job, segment, first column, width)
  const int4* tslabs;   // the tile geometry's slabs, as slabs (a gate
                        // tile's width: of each gate)
  int job0, n_jobs, cw, br, n_slabs, per_img;
  int n_tslabs, tmin;   // tmin: the least live rows that take the tiles
                        // (0: the stage has none)
};

struct GridArgs {
  Job jobs[MAX_JOBS];
  Stage st[MAX_STAGES];
  const float* feats;  // K2: (n_img * k, E) step-1 inputs, or null
  const float* emb;    // (V, E)
  float* hn;           // (2, rows, H) h' by step parity
  float* cn;           // (2, rows, H)
  float* logits;       // (rows, Vp) by compact row
  float* pm;           // (rows, n_tiles) tile max
  float* pse;          // (rows, n_tiles) tile sum-exp
  float* pv;           // (rows, n_tiles, k) tile top-k values
  int* pi;             // (rows, n_tiles, k) tile top-k ids
  float* scores;       // (rows,) beam scores
  float* bscore;       // (n_img,) best completed score
  int* alive;          // (rows,)
  int* word;           // (rows,) the word each beam slot took last step
  int* prev;           // (rows,) its parent slot
  int* seqs;           // (rows, L) sequences
  int* steps;          // (n_img, 2): steps run, live row-steps run
  unsigned* bar;       // the grid barrier's counter, 0 at launch
  int* tok;            // (n_img, L)
  int* len;            // (n_img,)
  float* score;        // (n_img,)
  // K7: the attention
  const float* afeats;  // (n_img, P, FS) spatial features
  const float* att1;    // (n_img, P, A) features enc_w + enc_b
  const float* att2;    // (rows, A) h dec_w + dec_b, by compact row
  const float* fullw;   // (A,)
  const float* fullb;   // (1,)
  float* esc;           // (rows, P) attention scores, by compact row
  float* mean;          // (n_img, FS) mean feature (h0/c0)
  int n_stages, n_jobs, E, H, V, Vp, n_tiles, k, n_img, rows, max_seq,
      start, end, feed, xvec;
  // att: the kernel attends: the scan lists the live images, and step 1's
  // h, c are the h0/c0 rows at row img * k (else zeros)
  int att, A, P, FS;
  int pu, upi;          // the scores stage: positions a unit, units an image
  // the softmax rows' stride in shared memory (0: each row in place in
  // esc, by a softmax stage of its own), esc's row stride, and whether
  // the scores stage stages att2 in the ring (else reads it from L2);
  // K2: ald = ALD, the rest unused
  int ald, eld, att2_ring;
  // SEL_SCAN: each block's survivors (k pairs), its tail state where it
  // does not fit the ring (tail_state_floats, else null), and its row
  // lists where the launch holds more than MAX_ROWS rows (8 rows ints:
  // xptr, list, hsrc, rmap, img, ifirst, icount; else null)
  unsigned long long* cand;
  float* tstate;
  int* lists;
};

struct Smem {
  float* ring;          // the chunk ring; the partials and tail scratch
  float* zs;            // a gate unit's z, (4, nr, cw / 4)
  float* alpha;         // a per-image unit's softmax rows, (KMAX, ald)
                        // (a unit's rows: an image's, or a group of KMAX;
                        // none where ald = 0: in device memory)
  const float** xptr;   // compact row -> its step input row
  int* list;            // compact row -> row
  int* hsrc;            // compact row -> the row of its h, c (-1: zeros)
  int* rmap;            // row -> compact row (-1: not live)
  int* img;             // live image (group) -> image
  int* ifirst;          // live image (group) -> its first compact row
  int* icount;          // live image (group) -> its live rows
  int* wcount;          // the scan's per-warp counts
};

// Dynamic shared memory of a search block whose softmax rows are `ald`
// floats apart (ALD; K7 past MAX_P positions its own; 0: none).
__host__ __device__ constexpr size_t grid_smem_bytes(int ald = ALD) {
  return sizeof(float) * (RING_FLOATS + ZS_FLOATS + (size_t)KMAX * ald) +
         sizeof(float*) * MAX_ROWS + sizeof(int) * (6 * MAX_ROWS + 32);
}

__device__ inline Smem carve_smem(float* base, int ald = ALD) {
  Smem s;
  s.ring = base;
  s.zs = s.ring + RING_FLOATS;
  s.alpha = s.zs + ZS_FLOATS;
  s.xptr = reinterpret_cast<const float**>(s.alpha + (size_t)KMAX * ald);
  s.list = reinterpret_cast<int*>(s.xptr + MAX_ROWS);
  s.hsrc = s.list + MAX_ROWS;
  s.rmap = s.hsrc + MAX_ROWS;
  s.img = s.rmap + MAX_ROWS;
  s.ifirst = s.img + MAX_ROWS;
  s.icount = s.ifirst + MAX_ROWS;
  s.wcount = s.icount + MAX_ROWS;
  return s;
}

// A kernel's lists: in shared memory, or (SEL_SCAN with a.lists) this
// block's own part of a.lists in device memory.
template <int SEL>
__device__ inline Smem carve_lists(float* base, const GridArgs& a) {
  Smem s = carve_smem(base, a.ald);
  if constexpr (SEL == SEL_SCAN) {
    if (a.lists != nullptr) {
      const size_t n = a.rows;
      int* b = a.lists + (size_t)blockIdx.x * 8 * n;
      s.xptr = reinterpret_cast<const float**>(b);
      s.list = b + 2 * n;
      s.hsrc = s.list + n;
      s.rmap = s.hsrc + n;
      s.img = s.rmap + n;
      s.ifirst = s.img + n;
      s.icount = s.ifirst + n;
    }
  }
  return s;
}

// The search's profile switch (icee_grid_profile, off unless a probe turns
// it on) and each block's copy of it, taken once a launch by load_plan:
// the profile marks read the copy.
__device__ int g_gb_prof_on;
__shared__ int g_gb_prof_blk;

// The launch's jobs and stages into shared memory (read every chunk), each
// stage pointed at its jobs, and the profile switch.  Ends with a barrier.
__device__ inline void load_plan(const GridArgs& a, Job* jobs,
                                 Stage* stages) {
  if (threadIdx.x == 0) g_gb_prof_blk = g_gb_prof_on;
  for (int i = threadIdx.x; i < a.n_jobs; i += GB_THREADS) jobs[i] = a.jobs[i];
  if (threadIdx.x < a.n_stages) {
    Stage s = a.st[threadIdx.x];
    s.job = jobs + s.job0;
    stages[threadIdx.x] = s;
  }
  __syncthreads();
}

// Each image's state, by the block that owns it: sequences [<start>,
// <end>, ...], every slot alive with score 0, the [<end>] fallback.
__device__ inline void init_search_state(const GridArgs& a) {
  const int tid = threadIdx.x, k = a.k, L = a.max_seq + 2;
  for (int img = blockIdx.x; img < a.n_img; img += gridDim.x) {
    const int base = img * k;
    for (int e = tid; e < k * L; e += GB_THREADS)
      a.seqs[(size_t)base * L + e] = (e % L == 0) ? a.start : a.end;
    for (int e = tid; e < L; e += GB_THREADS)
      a.tok[(size_t)img * L + e] = a.end;
    for (int q = tid; q < k; q += GB_THREADS) {
      a.alive[base + q] = 1;
      a.scores[base + q] = 0.f;
      a.word[base + q] = 0;
      a.prev[base + q] = 0;
    }
    if (tid == 0) {
      a.bscore[img] = NEG;
      a.len[img] = 1;
      a.score[img] = NEG;
      a.steps[2 * img] = a.steps[2 * img + 1] = 0;
    }
  }
}

struct StepCtx {
  int t, n, n_img, par;
  const float* hn_prev;
  const float* cn_prev;
  float* hn_cur;
  float* cn_cur;
};

__device__ inline StepCtx step_ctx(const GridArgs& a, int t) {
  const size_t plane = (size_t)a.rows * a.H;
  StepCtx c;
  c.t = t;
  c.par = t & 1;
  c.hn_cur = a.hn + c.par * plane;
  c.cn_cur = a.cn + c.par * plane;
  c.hn_prev = a.hn + (c.par ^ 1) * plane;
  c.cn_prev = a.cn + (c.par ^ 1) * plane;
  c.n = c.n_img = 0;
  return c;
}

// One unit: a slab over a block of live rows [i0, i0 + nr) (of image img,
// in a per-image stage).
struct Unit {
  int4 slab;
  int img, i0, nr, nch0, nch;
};

__device__ inline Unit unit_of(const Stage& S, const Smem& sm, int u, int n,
                               int n_rb) {
  Unit x;
  x.slab = __ldg(S.slabs + u % S.n_slabs);
  if (S.per_img) {
    const int li = u / S.n_slabs;
    x.img = sm.img[li];
    x.i0 = sm.ifirst[li];
    x.nr = sm.icount[li];
  } else {
    const int rb = u / S.n_slabs, base = n / n_rb, rem = n % n_rb;
    x.img = 0;
    x.i0 = rb * base + min(rb, rem);
    x.nr = base + (rb < rem ? 1 : 0);
  }
  const Job& J = S.job[x.slab.x];
  x.nch0 = (J.K + KC - 1) / KC;
  x.nch = x.nch0 + (J.W2 != nullptr ? (J.K2 + KC - 1) / KC : 0);
  return x;
}

// Block-wide stream compaction of i < n by live(i), in order: emit(idx, i)
// for every i, idx its rank among the live ones or -1.  Returns the count;
// ends with a barrier.  Every thread of the block must call it.
template <class Live, class Emit>
__device__ __forceinline__ int compact(int n, const Smem& sm, Live live,
                                       Emit emit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int r0 = 0; r0 < n; r0 += GB_THREADS) {
    const int r = r0 + tid;
    const bool lv = r < n && live(r);
    const unsigned bal = __ballot_sync(FULL, lv);
    if (lane == 0) sm.wcount[warp] = __popc(bal);
    __syncthreads();
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < GB_WARPS; ++w) {
        const int cnt = sm.wcount[w];
        sm.wcount[w] = s;
        s += cnt;
      }
      sm.wcount[GB_WARPS] = s;
    }
    __syncthreads();
    if (r < n)
      emit(lv ? base + sm.wcount[warp] + __popc(bal & ((1u << lane) - 1u))
              : -1,
           r);
    base += sm.wcount[GB_WARPS];
    __syncthreads();
  }
  return base;
}

// Every block: the live rows of step t, in row order (c.n of them).  Step 1
// runs slot 0 of each image (every candidate comes from it); later steps
// the slots whose beam is alive.  Where the kernel attends, also the
// images with a live row, in order (c.n_img), each with its first compact
// row and count (an image's live rows are adjacent); where k > KMAX, an
// image's slots in groups of KMAX (slots [g KMAX, (g + 1) KMAX)) take an
// image's place, so that a per-image unit holds at most KMAX rows.  Ends
// with a barrier.
__device__ void scan_rows(const GridArgs& a, const Smem& sm, StepCtx& c) {
  const int t = c.t;
  c.n = compact(
      a.rows, sm,
      [&](int r) {
        return t == 0 ? (r % a.k == 0) : (__ldcg(a.alive + r) != 0);
      },
      [&](int idx, int r) {
        if (idx >= 0) {
          sm.list[idx] = r;
          if (t == 0) {
            sm.xptr[idx] = a.feed ? a.feats + (size_t)r * a.E
                                  : a.emb + (size_t)a.start * a.E;
            sm.hsrc[idx] = a.att ? r : -1;
          } else {
            sm.xptr[idx] = a.emb + (size_t)__ldcg(a.word + r) * a.E;
            sm.hsrc[idx] = (r / a.k) * a.k + __ldcg(a.prev + r);
          }
        }
        sm.rmap[r] = idx;
      });
  if (!a.att) return;
  const int G = (a.k + KMAX - 1) / KMAX;  // groups an image: 1 at k <= KMAX
  c.n_img = compact(
      a.n_img * G, sm,
      [&](int grp) {
        const int base = (grp / G) * a.k, q0 = (grp % G) * KMAX;
        const int q1 = min(a.k, q0 + KMAX);
        bool any = false;
        for (int q = q0; q < q1; ++q) any |= sm.rmap[base + q] >= 0;
        return any;
      },
      [&](int idx, int grp) {
        if (idx < 0) return;
        const int base = (grp / G) * a.k, q0 = (grp % G) * KMAX;
        const int q1 = min(a.k, q0 + KMAX);
        int first = -1, cnt = 0;
        for (int q = q0; q < q1; ++q) {
          const int i = sm.rmap[base + q];
          if (i >= 0) {
            if (first < 0) first = i;
            ++cnt;
          }
        }
        sm.img[idx] = grp / G;
        sm.ifirst[idx] = first;
        sm.icount[idx] = cnt;
      });
}

// The thread's place in a stage: column quad q of each slab (of gate g,
// quad jq of the gate's columns, in a gate stage) for rows lane and lane +
// lanes of each unit; it also copies k rows lane + lanes j of the slab's
// weights and float4s tid % 8 and tid % 8 + 8 of input rows tid / 8 + 64 j.
struct Geo {
  int cw, br, QN, q, lane, lanes, g, jq;  // cw, br: the stage's, in registers
};

// Input-row sets a chunk of J holds in phase `amode`: 4 where each gate
// reads its own segment of a dense input, else 1.
__host__ __device__ __forceinline__ int row_sets(const Job& J, int amode) {
  return (J.gates && amode == A_DENSE && J.aseg != 0) ? 4 : 1;
}

// The output column of a unit's thread: its gate's (a gate product) or its
// segment's.
__device__ __forceinline__ int out_col(const Job& J, const Unit& x,
                                       const Geo& t) {
  return (J.gates ? t.g : x.slab.y) * J.segw + x.slab.z + 4 * t.jq;
}

// The input row of compact row i: its step input, its parent's h, its own
// h' or a dense buffer's row (at the segment of gate `set` or of the slab).
__device__ __forceinline__ const float* row_src(const GridArgs& a,
                                                const Job& J, const Smem& sm,
                                                const StepCtx& c, int amode,
                                                int set, int seg, int i) {
  if (amode == A_X) return sm.xptr[i];
  if (amode == A_HPREV)
    return sm.hsrc[i] < 0 ? nullptr : c.hn_prev + (size_t)sm.hsrc[i] * a.H;
  if (amode == A_HCUR) return c.hn_cur + (size_t)sm.list[i] * a.H;
  return J.A + (size_t)i * J.lda + (J.gates ? set : seg) * J.aseg;
}

// The issue cursor: the unit and chunk it loads next, and what this thread
// copies of the unit's phase (set when the cursor enters it, so a chunk's
// copies are address adds): its weight column at k = 0 and up to two input
// rows (sets x br <= MAX_UNIT_ROWS).  na < 0: the rows are copied a float at
// a time (an input width that is not a multiple of 4); na = 0 and no rows:
// the unit's input rows are in shared memory already (A_ALPHA).
struct IssueCur {
  int u, ch, phase, K, ldw, amode, sets, na;
  Unit x;
  const float* w;
  const float* ap[2];
  int adst[2];
};

__device__ __forceinline__ void enter_phase(IssueCur& ic, const GridArgs& a,
                                            const Stage& S, const Smem& sm,
                                            const StepCtx& c, const Geo& t,
                                            int phase) {
  const Job& J = S.job[ic.x.slab.x];
  const float* W = phase ? J.W2 : J.W;
  ic.phase = phase;
  ic.K = phase ? J.K2 : J.K;
  ic.amode = phase ? J.amode2 : J.amode;
  ic.ldw = J.ldw;
  const int seg = J.gates ? t.g : ic.x.slab.y;
  ic.w = 4 * t.jq < ic.x.slab.w
             ? W + ic.x.img * J.wimg + seg * J.wseg + ic.x.slab.z + 4 * t.jq
             : nullptr;
  ic.sets = row_sets(J, ic.amode);
  ic.na = -1;
  if (ic.amode == A_ALPHA) {
    ic.na = 0;
    return;
  }
  if (ic.amode != A_X || a.xvec) {
    ic.na = 0;
    const int m4 = 4 * (threadIdx.x & 7);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = (threadIdx.x >> 3) + 64 * j;
      ic.ap[j] = nullptr;
      ic.adst[j] = 0;
      if (r < ic.sets * ic.x.nr) {
        const int set = r / ic.x.nr, rr = r % ic.x.nr;
        ic.ap[j] = row_src(a, J, sm, c, ic.amode, set, ic.x.slab.y,
                           ic.x.i0 + rr);
        ic.adst[j] = (set * t.br + rr) * KCP + m4;
        ic.na = j + 1;
      }
    }
  }
}

// Loads the cursor's chunk into a ring slot: the slab's weight rows as (k,
// cw) floats, then the unit's input rows as (sets, br, KCP).
__device__ __forceinline__ void issue(const IssueCur& ic, const GridArgs& a,
                                      const Stage& S, const Smem& sm,
                                      const StepCtx& c, const Geo& t,
                                      float* slot) {
  const int k0 = (ic.phase ? ic.ch - ic.x.nch0 : ic.ch) * KC;
  const int kn = min(KC, ic.K - k0);
  if (ic.w != nullptr)
    for (int kk = t.lane; kk < kn; kk += t.lanes)
      cp_async16(slot + kk * t.cw + 4 * t.q, ic.w + (size_t)(k0 + kk) * ic.ldw);
  float* sa = slot + KC * t.cw;
  if (ic.na >= 0) {
    const int m4 = 4 * (threadIdx.x & 7);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < ic.na) {
#pragma unroll
        for (int h = 0; h < KC; h += 32) {
          if (m4 + h < kn) {
            float* d = sa + ic.adst[j] + h;
            if (ic.ap[j] != nullptr)
              cp_async16(d, ic.ap[j] + k0 + m4 + h);
            else
              *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
    }
    return;
  }
  const Job& J = S.job[ic.x.slab.x];
  for (int e = threadIdx.x; e < ic.sets * ic.x.nr * kn; e += GB_THREADS) {
    const int ar = e / kn, m = e % kn;
    const int set = ar / ic.x.nr, rr = ar % ic.x.nr;
    const float* src =
        row_src(a, J, sm, c, ic.amode, set, ic.x.slab.y, ic.x.i0 + rr);
    sa[(set * t.br + rr) * KCP + m] = src != nullptr ? __ldcg(src + k0 + m)
                                                     : 0.f;
  }
}

// The compute cursor: the unit and chunk whose chains run next, and this
// thread's part in the unit: whether it has a column quad and a row (and a
// second row), where its input rows sit in a slot, by phase (or in the
// softmax rows), and where its chains start (init).
struct CompCur {
  int u, ch, K0, K1, aoff0, aoff1, ldi, col;
  bool act, two, alpha;
  const float* init;
  Unit x;
};

__device__ __forceinline__ void enter_unit(CompCur& cc, const Stage& S,
                                           const Geo& t) {
  const Job& J = S.job[cc.x.slab.x];
  cc.K0 = J.K;
  cc.K1 = J.K2;
  cc.act = 4 * t.jq < cc.x.slab.w && t.lane < cc.x.nr;
  cc.two = t.lane + t.lanes < cc.x.nr;
  const int set0 = row_sets(J, J.amode) == 4 ? t.g : 0;
  const int set1 = row_sets(J, J.amode2) == 4 ? t.g : 0;
  cc.aoff0 = (set0 * t.br + t.lane) * KCP;
  cc.aoff1 = (set1 * t.br + t.lane) * KCP;
  cc.alpha = J.amode == A_ALPHA;
  cc.init = J.init;
  cc.ldi = J.ldi;
  cc.col = out_col(J, cc.x, t);
}

// A per-image unit's input rows: the softmax over P of each of its image's
// live rows' scores (K6's softmax_row, a warp a row), into sm.alpha.  All
// threads of the block must call it; it ends with a barrier.
__device__ void load_alpha(const GridArgs& a, const Smem& sm,
                           const Unit& x) {
  const int P = a.P;
  for (int e = threadIdx.x; e < x.nr * P; e += GB_THREADS) {
    const int r = e / P, p = e % P;
    sm.alpha[r * a.ald + p] = __ldcg(a.esc + (size_t)(x.i0 + r) * a.eld + p);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < x.nr) softmax_row(sm.alpha + warp * a.ald, P, nullptr);
  __syncthreads();
}

// Where the softmax rows do not fit shared memory (ald = 0): every live
// row's softmax over P in place in esc, a warp a row over the grid (K6's
// softmax_row, through L2), before the context stage reads them as dense
// input rows.
__device__ void run_softmax(const GridArgs& a, const StepCtx& c) {
  const int warp = blockIdx.x * GB_WARPS + (threadIdx.x >> 5);
  for (int i = warp; i < c.n; i += gridDim.x * GB_WARPS)
    softmax_row<true>(a.esc + (size_t)i * a.eld, a.P, nullptr);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A whole chunk (KC k rows) of the thread's chains, for a slab CW columns
// wide and one or (TWO) two rows: acc[m][j] = fmaf(a, w, acc) in k order,
// as dot4.  Unrolled whole; each group of 4 k rows' loads is issued two
// groups ahead of its fmafs (a shared-memory load outlasts one group's).
template <int CW, bool TWO>
__device__ __forceinline__ void chunk_full(const float* ws, const float* a0,
                                           const float* a1,
                                           float (&acc)[2][4]) {
  constexpr int NG = KC / 4, AHEAD = 2;
  float4 w[AHEAD + 1][4], x0[AHEAD + 1], x1[AHEAD + 1];
#pragma unroll
  for (int g = 0; g < AHEAD; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[g][i] = lds4(ws + (4 * g + i) * CW);
    x0[g] = lds4(a0 + 4 * g);
    if (TWO) x1[g] = lds4(a1 + 4 * g);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g + AHEAD < NG) {
      const int b = (g + AHEAD) % (AHEAD + 1), k = 4 * (g + AHEAD);
#pragma unroll
      for (int i = 0; i < 4; ++i) w[b][i] = lds4(ws + (k + i) * CW);
      x0[b] = lds4(a0 + k);
      if (TWO) x1[b] = lds4(a1 + k);
    }
    const int c = g % (AHEAD + 1);
    fma4(acc[0], x0[c].x, w[c][0]);
    fma4(acc[0], x0[c].y, w[c][1]);
    fma4(acc[0], x0[c].z, w[c][2]);
    fma4(acc[0], x0[c].w, w[c][3]);
    if (TWO) {
      fma4(acc[1], x1[c].x, w[c][0]);
      fma4(acc[1], x1[c].y, w[c][1]);
      fma4(acc[1], x1[c].z, w[c][2]);
      fma4(acc[1], x1[c].w, w[c][3]);
    }
  }
}

template <int CW>
__device__ __forceinline__ void chunk_rows(const float* ws, const float* a0,
                                           const float* a1, bool two,
                                           float (&acc)[2][4]) {
  if (two)
    chunk_full<CW, true>(ws, a0, a1, acc);
  else
    chunk_full<CW, false>(ws, a0, a1, acc);
}

// One chunk's k rows of the thread's chains (kn of them: a chain's last
// chunk may be short): weights from the slot, input rows from a0 (and a0 +
// astep), each at the chunk's first k.
__device__ __forceinline__ void compute(const float* slot, int cw, int kn,
                                        int q, const float* a0, int astep,
                                        bool two, float (&acc)[2][4]) {
  const float* ws = slot + 4 * q;
  const float* a1 = a0 + astep;
  if (kn == KC) {
    if (cw == 16)
      chunk_rows<16>(ws, a0, a1, two, acc);
    else if (cw == 32)
      chunk_rows<32>(ws, a0, a1, two, acc);
    else
      chunk_rows<64>(ws, a0, a1, two, acc);
    return;
  }
#pragma unroll 1
  for (int kk = 0; kk < kn; ++kk) {
    const float4 w = lds4(ws + kk * cw);
    fma4(acc[0], a0[kk], w);
    if (two) fma4(acc[1], a1[kk], w);
  }
}

// After a unit's last chunk: bias adds (or the gated context) into the
// job's output, or the gate pre-activations of four gates through shared
// memory and then the cell.  Every thread of the block calls it for every
// unit (a gate epilogue holds a barrier).
__device__ void epilogue(const GridArgs& a, const Stage& S, const Smem& sm,
                         const StepCtx& c, const Geo& t, const Unit& x,
                         const float (&acc)[2][4],
                         const float (&acc0)[2][4]) {
  const Job& J = S.job[x.slab.x];
  const bool quad = 4 * t.jq < x.slab.w;
  if (J.epi == E_BIAS || J.epi == E_CTX) {
    if (!quad) return;
    const int col = out_col(J, x, t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = t.lane + m * t.lanes;
      if (row < x.nr) {
        const size_t i = x.i0 + row;
        float* o = J.out + i * J.ldo + col;
        if (J.epi == E_CTX) {  // sigmoid(h f_beta_w + f_beta_b) * ctx
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = sigmoid(__ldcg(J.hw + i * J.ldo + col + j)) * acc[m][j];
        } else if (J.bias != nullptr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = acc[m][j] + __ldg(J.bias + col + j);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = acc[m][j];
        }
      }
    }
    return;
  }
  const int H = a.H, cw4 = t.cw / 4;
  if (quad) {
    const int o = t.g * H + x.slab.z + 4 * t.jq;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = t.lane + m * t.lanes;
      if (row < x.nr) {
        const size_t i = x.i0 + row;
        float* zs = sm.zs + (t.g * x.nr + row) * cw4 + 4 * t.jq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float z;
          if (J.epi == E_GATES_F)  // (s U + U_b) + (h W + W_b)
            z = (acc[m][j] + __ldg(J.bias + o + j)) +
                __ldcg(J.hw + i * 4 * H + o + j);
          else if (J.epi == E_GATES_L)  // ((x W_ih + b_ih) + h W_hh) + b_hh
            z = ((acc0[m][j] + __ldg(J.bias + o + j)) + acc[m][j]) +
                __ldg(J.bias2 + o + j);
          else  // the same, x W_ih resumed and h W_hh stored
            z = ((acc[m][j] + __ldg(J.bias + o + j)) +
                 __ldcg(J.hw + i * 4 * H + o + j)) +
                __ldg(J.bias2 + o + j);
          zs[j] = z;
        }
      }
    }
  }
  __syncthreads();
  const int w = x.slab.w, zg = x.nr * cw4;
  for (int e = threadIdx.x; e < x.nr * w; e += GB_THREADS) {
    const int row = e / w, jl = e % w, col = x.slab.z + jl;
    const int i = x.i0 + row;
    const float* z = sm.zs + row * cw4 + jl;
    const int src = sm.hsrc[i];
    const float cin = src < 0 ? 0.f : __ldcg(c.cn_prev + (size_t)src * H + col);
    float h_new, c_new;
    if (J.epi == E_GATES_F) {  // [i, f, o, c], h = o * c (no tanh)
      const float i_t = sigmoid(z[0]), f_t = sigmoid(z[zg]);
      const float o_t = sigmoid(z[2 * zg]), g_t = tanhf(z[3 * zg]);
      c_new = f_t * cin + i_t * g_t;
      h_new = o_t * c_new;
    } else {  // [i, f, g, o], h = o * tanh(c)
      const float i_t = sigmoid(z[0]), f_t = sigmoid(z[zg]);
      const float g_t = tanhf(z[2 * zg]), o_t = sigmoid(z[3 * zg]);
      c_new = f_t * cin + i_t * g_t;
      h_new = o_t * tanhf(c_new);
    }
    const size_t o = (size_t)sm.list[i] * H + col;
    c.cn_cur[o] = c_new;
    c.hn_cur[o] = h_new;
  }
}

// --- the tile geometry ------------------------------------------------------
//
// A stage whose live rows fill the card takes tiles (ops/beam.py
// plan_tiles: the least live rows from which the tiles beat the slabs):
// a unit is a tile slab (up to TBN columns of a job's segment; a gate
// tile's TBN / 4 of each of the four gates) over a row tile of at most
// TBM live rows, the live rows split evenly into ceil(n / TBM) row tiles.
// A slab's row tiles are adjacent in the unit order, so the blocks that
// take them read its weight chunks from L2 at about the same time.  The
// thread of warp w, half h (bit 4 of the thread) and column lane tx (its
// low four bits) owns 4 rows, 8 w + 4 h + i, and 8 columns, 4 tx + j and
// 64 + 4 tx + j: 32 outputs in registers.  A chunk (KT k rows: the weights
// (KT, TBN) row-major, the input rows (SETS, TBM, KT)) goes through the
// slabs' ring cut into TSLOTS larger slots.  At each k quad a thread reads
// a float4 of each of its rows (a warp's two halves read two addresses, 16
// banks apart) and two float4 of weights a k row: 12 loads for 128 fmaf,
// where a slab thread took 6 for 32, and a weight chunk serves 128 rows
// where a slab served at most 52.  Where each gate reads its own input
// rows (SETS = 4: the factored cell's s_g U_g) the chunk holds the four
// sets and a column quad reads its gate's.  In a gate tile column quad q
// of lane tx is gate 2 q + tx / 8, so lanes tx and tx ^ 8 of a warp hold
// the four gates of the same columns: after the chains they trade half
// their rows' pre-activations by shuffle and each runs the cell on its
// half, in registers.  Every output is still one fmaf chain in k order
// from 0.f or its init over the whole k range (a short last chunk runs
// only its k rows), with the slab path's epilogue arithmetic: the bits do
// not depend on the geometry.  The tiles are compiled only into the
// kernels of launches whose plan has them (TILES), so a launch without
// them runs the slab path's code as it was.

template <int SETS>
struct TileCfg {
  static constexpr int KT = SETS == 4 ? 12 : 36;      // k rows of a chunk
  static constexpr int LDA = KT;                      // an input row's stride
  static constexpr int SS = TBM * LDA + 8;            // a set's: 8 banks on
  static_assert(KT * TBN + SETS * SS <= TSLOT_FLOATS && KT % 4 == 0 &&
                    LDA % 8 == 4,
                "a tile chunk fits a tile slot; a warp's halves (4 rows "
                "apart) 16 banks apart");
};

// Whether a step of n live rows runs a stage in tiles.
__device__ __forceinline__ bool stage_geo(const Stage& S, int n) {
  return S.tmin > 0 && n >= S.tmin;
}

// A tile unit: tile slab (job, segment, first column, width) over live rows
// [i0, i0 + nr), and its chunks.
struct TileUnit {
  int4 slab;
  int i0, nr, nch;
};

template <class T>
__device__ __forceinline__ TileUnit tile_of(const Stage& S, int u, int n) {
  const int n_rt = (n + TBM - 1) / TBM;
  const int rt = u % n_rt, base = n / n_rt, rem = n % n_rt;
  TileUnit x;
  x.slab = __ldg(S.tslabs + u / n_rt);
  x.i0 = rt * base + min(rt, rem);
  x.nr = base + (rt < rem ? 1 : 0);
  x.nch = (S.job[x.slab.x].K + T::KT - 1) / T::KT;
  return x;
}

// The thread's first row in its tile (its rows: the next three too).
__device__ __forceinline__ int tile_row0() {
  return 8 * (threadIdx.x >> 5) + 4 * ((threadIdx.x >> 4) & 1);
}

// The output column of the thread's column quad q (plain: of its segment;
// a gate tile: of gate 2 q + tx / 8), and whether the tile holds it.
__device__ __forceinline__ int tile_col(const Job& J, const TileUnit& x,
                                        int q, bool& in) {
  const int tx = threadIdx.x & 15;
  if (J.gates) {
    const int cl = 4 * (tx & 7);
    in = cl < x.slab.w;
    return (2 * q + (tx >> 3)) * J.segw + x.slab.z + cl;
  }
  const int vc = 64 * q + 4 * tx;
  in = vc < x.slab.w;
  return x.slab.y * J.segw + x.slab.z + vc;
}

// Loads chunk ch of tile unit x into a ring slot: the weight rows as (kn,
// TBN) floats (a gate tile's as four gates of TBN / 4), then the input rows
// as (SETS, TBM, LDA), each row's kn k values.
template <class T, int SETS>
__device__ __forceinline__ void tile_issue(const GridArgs& a, const Stage& S,
                                           const Smem& sm, const StepCtx& c,
                                           const TileUnit& x, int ch,
                                           float* slot) {
  constexpr int QR = TBN / 4, QG = TBN / 16;
  const Job& J = S.job[x.slab.x];
  const int k0 = ch * T::KT, kn = min(T::KT, J.K - k0);
  for (int e = threadIdx.x; e < kn * QR; e += GB_THREADS) {
    const int kk = e / QR, q = e % QR;
    const int seg = J.gates ? q / QG : x.slab.y;
    const int cl = J.gates ? 4 * (q % QG) : 4 * q;
    if (cl < x.slab.w)
      cp_async16(slot + kk * TBN + 4 * q,
                 J.W + seg * J.wseg + (size_t)(k0 + kk) * J.ldw + x.slab.z +
                     cl);
  }
  float* sa = slot + T::KT * TBN;
  if (J.amode != A_X || a.xvec) {  // k0 and kn are multiples of 4 here
    const int qk = kn / 4;
    for (int e = threadIdx.x; e < SETS * x.nr * qk; e += GB_THREADS) {
      const int ar = e / qk, q = e % qk;
      const int set = SETS == 1 ? 0 : ar / x.nr;
      const int rr = SETS == 1 ? ar : ar % x.nr;
      const float* src =
          row_src(a, J, sm, c, J.amode, set, x.slab.y, x.i0 + rr);
      float* d = sa + set * T::SS + rr * T::LDA + 4 * q;
      if (src != nullptr)
        cp_async16(d, src + k0 + 4 * q);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < SETS * x.nr * kn; e += GB_THREADS) {
    const int ar = e / kn, m = e % kn;
    const int set = SETS == 1 ? 0 : ar / x.nr;
    const int rr = SETS == 1 ? ar : ar % x.nr;
    const float* src = row_src(a, J, sm, c, J.amode, set, x.slab.y, x.i0 + rr);
    sa[set * T::SS + rr * T::LDA + m] = src != nullptr ? __ldcg(src + k0 + m)
                                                       : 0.f;
  }
}

// k rows [k, k + KQ) of the thread's chains (KQ 4, or 1 for a ragged end):
// its rows' values at a0 (its second column quad's at a1: its gate's set)
// against its columns of the weight rows at ws: acc[i][.] = fmaf(x, w, acc)
// in k order.
template <class T, int SETS, int KQ>
__device__ __forceinline__ void tile_kq(const float* ws, const float* a0,
                                        const float* a1, int k,
                                        float (&acc)[4][8]) {
  float x0[4][KQ], x1[SETS == 1 ? 1 : 4][KQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (KQ == 4) {
      const float4 v = lds4(a0 + i * T::LDA + k);
      x0[i][0] = v.x, x0[i][1] = v.y, x0[i][2] = v.z, x0[i][3] = v.w;
      if constexpr (SETS != 1) {
        const float4 u = lds4(a1 + i * T::LDA + k);
        x1[i][0] = u.x, x1[i][1] = u.y, x1[i][2] = u.z, x1[i][3] = u.w;
      }
    } else {
      x0[i][0] = a0[i * T::LDA + k];
      if constexpr (SETS != 1) x1[i][0] = a1[i * T::LDA + k];
    }
  }
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const float4 w0 = lds4(ws + (k + kk) * TBN);
    const float4 w1 = lds4(ws + (k + kk) * TBN + 64);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float u = x0[i][kk];
      const float v = SETS == 1 ? x0[i][kk] : x1[SETS == 1 ? 0 : i][kk];
      acc[i][0] = fmaf(u, w0.x, acc[i][0]);
      acc[i][1] = fmaf(u, w0.y, acc[i][1]);
      acc[i][2] = fmaf(u, w0.z, acc[i][2]);
      acc[i][3] = fmaf(u, w0.w, acc[i][3]);
      acc[i][4] = fmaf(v, w1.x, acc[i][4]);
      acc[i][5] = fmaf(v, w1.y, acc[i][5]);
      acc[i][6] = fmaf(v, w1.z, acc[i][6]);
      acc[i][7] = fmaf(v, w1.w, acc[i][7]);
    }
  }
}

// One chunk's kn k rows of the thread's chains: whole k quads, then the k
// rows of a ragged end one at a time.
template <class T, int SETS>
__device__ __forceinline__ void tile_chunk(const float* slot, int kn,
                                           float (&acc)[4][8]) {
  const int tx = threadIdx.x & 15;
  const float* ws = slot + 4 * tx;
  const float* as = slot + T::KT * TBN + tile_row0() * T::LDA;
  const float* a0 = as + (SETS == 1 ? 0 : (tx >> 3) * T::SS);
  const float* a1 = as + (SETS == 1 ? 0 : (2 + (tx >> 3)) * T::SS);
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= kn; k += 4) tile_kq<T, SETS, 4>(ws, a0, a1, k, acc);
#pragma unroll 1
  for (; k < kn; ++k) tile_kq<T, SETS, 1>(ws, a0, a1, k, acc);
}

// A unit's chains start: from 0.f, or from the stored partial (init).
__device__ __forceinline__ void tile_start(const Stage& S, const TileUnit& x,
                                           float (&acc)[4][8]) {
  const Job& J = S.job[x.slab.x];
  const int r0 = tile_row0();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    bool in;
    const int col = tile_col(J, x, q, in);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][4 * q + j] =
            J.init != nullptr && in && r0 + i < x.nr
                ? __ldcg(J.init + (size_t)(x.i0 + r0 + i) * J.ldi + col + j)
                : 0.f;
  }
}

// After a unit's last chunk: the bias adds into the job's output, or the
// gate pre-activations (in place of acc) and the cell on them, each thread
// on its own outputs and lane tx ^ 8's (the slab epilogue's arithmetic; no
// barrier).
__device__ __forceinline__ void tile_epilogue(const GridArgs& a,
                                              const Stage& S, const Smem& sm,
                                              const StepCtx& c,
                                              const TileUnit& x,
                                              float (&acc)[4][8]) {
  const Job& J = S.job[x.slab.x];
  const int r0 = tile_row0(), H = a.H;
  if (!J.gates) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      bool in;
      const int col = tile_col(J, x, q, in);
      if (!in) continue;   // a quad is wholly in or out
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r0 + i >= x.nr) continue;
        float* o = J.out + (size_t)(x.i0 + r0 + i) * J.ldo + col;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = J.bias != nullptr ? acc[i][4 * q + j] + __ldg(J.bias + col + j)
                                   : acc[i][4 * q + j];
      }
    }
    return;
  }
  // the pre-activation z of gate 2 q + tx / 8 (column quad q; both quads
  // hold the same columns, of two gates)
  bool in = false;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int o = tile_col(J, x, q, in);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!in || r0 + i >= x.nr) continue;
      const float* hw = J.hw + (size_t)(x.i0 + r0 + i) * 4 * H + o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = acc[i][4 * q + j];
        if (J.epi == E_GATES_F)  // (s U + U_b) + (h W + W_b)
          acc[i][4 * q + j] = (v + __ldg(J.bias + o + j)) + __ldcg(hw + j);
        else  // ((x W_ih + b_ih) resumed + h W_hh stored) + b_hh
          acc[i][4 * q + j] = ((v + __ldg(J.bias + o + j)) + __ldcg(hw + j)) +
                              __ldg(J.bias2 + o + j);
      }
    }
  }
  // lanes tx < 8 hold gates 0 and 2, lanes tx ^ 8 gates 1 and 3: the lower
  // runs the cell on rows 0 and 1 of the thread's, the upper on 2 and 3
  const bool lower = (threadIdx.x & 8) == 0;
  const int cl = x.slab.z + 4 * (threadIdx.x & 7);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float g[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f0 = acc[m][j], f1 = acc[m][4 + j];
      const float u0 = acc[2 + m][j], u1 = acc[2 + m][4 + j];
      const float t0 = __shfl_xor_sync(FULL, lower ? u0 : f0, 8);
      const float t1 = __shfl_xor_sync(FULL, lower ? u1 : f1, 8);
      const float own0 = lower ? f0 : u0, own1 = lower ? f1 : u1;
      g[0][j] = lower ? own0 : t0;
      g[1][j] = lower ? t0 : own0;
      g[2][j] = lower ? own1 : t1;
      g[3][j] = lower ? t1 : own1;
    }
    const int row = r0 + (lower ? m : 2 + m);
    if (!in || row >= x.nr) continue;
    const int li = x.i0 + row;
    const int src = sm.hsrc[li];
    const size_t dst = (size_t)sm.list[li] * H + cl;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float cin =
          src < 0 ? 0.f : __ldcg(c.cn_prev + (size_t)src * H + cl + j);
      float h_new, c_new;
      if (J.epi == E_GATES_F) {  // [i, f, o, c], h = o * c (no tanh)
        const float i_t = sigmoid(g[0][j]), f_t = sigmoid(g[1][j]);
        const float o_t = sigmoid(g[2][j]), g_t = tanhf(g[3][j]);
        c_new = f_t * cin + i_t * g_t;
        h_new = o_t * c_new;
      } else {  // [i, f, g, o], h = o * tanh(c)
        const float i_t = sigmoid(g[0][j]), f_t = sigmoid(g[1][j]);
        const float g_t = tanhf(g[2][j]), o_t = sigmoid(g[3][j]);
        c_new = f_t * cin + i_t * g_t;
        h_new = o_t * tanhf(c_new);
      }
      c.cn_cur[dst + j] = c_new;
      c.hn_cur[dst + j] = h_new;
    }
  }
}

// A stage in tiles: this block's units in turn, their chunks streamed
// through the ring as run_stage streams a slab's (one barrier a chunk),
// the ring cut into TSLOTS larger slots.
template <int SETS>
__device__ __forceinline__ void run_tiles(const GridArgs& a, const Stage& S,
                                          const Smem& sm, const StepCtx& c) {
  using T = TileCfg<SETS>;
  const int n = c.n, n_units = S.n_tslabs * ((n + TBM - 1) / TBM);
  int iu = blockIdx.x, ich = 0, cu = blockIdx.x, cch = 0;
  float acc[4][8];
#pragma unroll 1
  for (int it = 1 - TSLOTS; cu < n_units; ++it) {
    if (it >= 0) {
      cp_async_wait<TSLOTS - 2>();  // chunk `it` has landed
      __syncthreads();              // ... for every thread; slot it - 1 free
    }
    if (iu < n_units) {   // (a unit's place is recomputed, not carried)
      const TileUnit ix = tile_of<T>(S, iu, n);
      tile_issue<T, SETS>(
          a, S, sm, c, ix, ich,
          sm.ring + ((it + TSLOTS - 1) % TSLOTS) * TSLOT_FLOATS);
      if (++ich == ix.nch) {
        ich = 0;
        iu += gridDim.x;
      }
    }
    cp_async_commit();
    if (it < 0) continue;
    const TileUnit cx = tile_of<T>(S, cu, n);
    if (cch == 0) tile_start(S, cx, acc);
    if (8 * (threadIdx.x >> 5) < cx.nr)   // a warp past the tile's rows rests
      tile_chunk<T, SETS>(sm.ring + (it % TSLOTS) * TSLOT_FLOATS,
                          min(T::KT, S.job[cx.slab.x].K - cch * T::KT), acc);
    if (++cch == cx.nch) {
      tile_epilogue(a, S, sm, c, cx, acc);
      cch = 0;
      cu += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// A stage's tiles, in the input-row sets of its job.
__device__ __forceinline__ void run_tile_stage(const GridArgs& a,
                                               const Stage& S, const Smem& sm,
                                               const StepCtx& c) {
  if (row_sets(S.job[0], S.job[0].amode) == 4)
    run_tiles<4>(a, S, sm, c);
  else
    run_tiles<1>(a, S, sm, c);
}

// One product stage: this block's units in turn, their chunks streamed
// through the ring (one barrier a chunk; the next unit's chunks are in
// flight while a unit finishes); in tiles where the kernel has them
// (TILES) and the step's live rows reach the stage's tmin.
template <bool TILES>
__device__ void run_stage(const GridArgs& a, const Stage& S, const Smem& sm,
                          const StepCtx& c) {
  const int n = c.n;
  if constexpr (TILES) {
    if (stage_geo(S, n)) {
      run_tile_stage(a, S, sm, c);
      return;
    }
  }
  const int n_rb = (n + S.br - 1) / S.br;
  const int n_units = S.n_slabs * (S.per_img ? c.n_img : n_rb);
  Geo t;
  t.cw = S.cw;
  t.br = S.br;
  t.QN = t.cw / 4;
  t.q = threadIdx.x % t.QN;
  t.lane = threadIdx.x / t.QN;
  t.lanes = GB_THREADS / t.QN;
  const int qg = t.QN / 4;  // quads of a gate in a gate slab
  t.g = S.job[0].gates ? t.q / qg : 0;
  t.jq = S.job[0].gates ? t.q % qg : t.q;

  // one loop: its first NSLOT - 1 turns only issue (the ring's fill), so
  // the issue, the unit and phase entries and the chains have one copy each
  IssueCur ic;
  ic.u = blockIdx.x;
  ic.ch = 0;
  CompCur cc;
  cc.u = blockIdx.x;
  cc.ch = 0;
  float acc[2][4] = {}, acc0[2][4] = {};
#pragma unroll 1
  for (int it = 1 - NSLOT; cc.u < n_units; ++it) {
    if (it >= 0) {
      cp_async_wait<NSLOT - 2>();  // chunk `it` has landed
      __syncthreads();             // ... for every thread; slot it - 1 free
    }
    if (ic.u < n_units) {
      if (ic.ch == 0) ic.x = unit_of(S, sm, ic.u, n, n_rb);
      if (ic.ch == 0 || ic.ch == ic.x.nch0)
        enter_phase(ic, a, S, sm, c, t, ic.ch != 0);
      issue(ic, a, S, sm, c, t,
            sm.ring + ((it + NSLOT - 1) % NSLOT) * SLOT_FLOATS);
      if (++ic.ch == ic.x.nch) {
        ic.ch = 0;
        ic.u += gridDim.x;
      }
    }
    cp_async_commit();
    if (it < 0) continue;
    if (cc.ch == 0) {
      cc.x = unit_of(S, sm, cc.u, n, n_rb);
      enter_unit(cc, S, t);
      if (cc.alpha) load_alpha(a, sm, cc.x);
    }
    const int ph = cc.ch >= cc.x.nch0;
    if (cc.ch == 0 || cc.ch == cc.x.nch0) {
      if (cc.ch != 0) {  // the second chain of a gate product starts
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc0[m][j] = acc[m][j];
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
      if (cc.ch == 0 && cc.init != nullptr && cc.act) {  // a resumed chain
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int row = t.lane + m * t.lanes;
          if (row < cc.x.nr) {
            const float* p = cc.init + (size_t)(cc.x.i0 + row) * cc.ldi + cc.col;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m][j] = __ldcg(p + j);
          }
        }
      }
    }
    if (cc.act) {
      const int k0 = (ph ? cc.ch - cc.x.nch0 : cc.ch) * KC;
      const float* slot = sm.ring + (it % NSLOT) * SLOT_FLOATS;
      const float* a0 = cc.alpha ? sm.alpha + t.lane * a.ald + k0
                                 : slot + KC * t.cw + (ph ? cc.aoff1 : cc.aoff0);
      compute(slot, t.cw, min(KC, (ph ? cc.K1 : cc.K0) - k0), t.q, a0,
              cc.alpha ? t.lanes * a.ald : t.lanes * KCP, cc.two, acc);
    }
    if (cc.ch + 1 == cc.x.nch) epilogue(a, S, sm, c, t, cc.x, acc, acc0);
    if (++cc.ch == cc.x.nch) {
      cc.ch = 0;
      cc.u += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// Every 256-wide logits tile of every live row through tile_reduce, a warp
// a tile; columns past V hold NEG.
__device__ void run_partials(const GridArgs& a, const Smem& sm, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = a.n_tiles;
  float* lt = sm.ring + warp * VT;
  for (int task = blockIdx.x * GB_WARPS + warp; task < n * nt;
       task += gridDim.x * GB_WARPS) {
    const int i = task / nt, tile = task % nt;
    float v[VT / 32];
#pragma unroll
    for (int u = 0; u < VT / 32; ++u) {
      const int col = tile * VT + lane + 32 * u;
      v[u] = col < a.V ? __ldcg(a.logits + (size_t)i * a.Vp + col) : NEG;
    }
#pragma unroll
    for (int u = 0; u < VT / 32; ++u) lt[lane + 32 * u] = v[u];
    __syncwarp();
    const size_t p = (size_t)i * nt + tile;
    tile_reduce(lt, tile * VT, a.k, a.pm + p, a.pse + p, a.pv + p * a.k,
                a.pi + p * a.k);
    __syncwarp();
  }
}

// Floats of one merging warp's copy of a row's partials.
__host__ __device__ inline int merge_floats(int n_tiles, int k) {
  return round4(n_tiles * (2 + 2 * k));
}

// Floats of the narrow tail's scratch: the merging warps' copies, then
// the per-image state: log-probs, ids, sequences old and new, and the
// k-slot state.
__host__ __device__ inline long long narrow_tail_floats(int n_tiles, int k,
                                                        int L) {
  return KMAX * (long long)merge_floats(n_tiles, k) + 2LL * k * k +
         2LL * k * L + 6LL * k + 4;
}

// Floats of the wide tail's k-slot state (scores, totals, alive, parents,
// words, then three flags).
__host__ __device__ inline long long tail_state_floats(int k) {
  return 5LL * k + 4;
}

// Whether the wide tail's k-slot state sits in the ring (else, SEL_SCAN,
// in tstate).
__host__ __device__ inline bool state_in_ring(int k) {
  return TOPK_FLOATS + tail_state_floats(k) <= RING_FLOATS;
}

// The selection of a search at k and V (n_tiles tiles): the narrow tail
// where k <= KMAX and its scratch fits the ring, the wide one up to KWIDE,
// then SEL_SCAN.
__host__ __device__ inline int sel_kind(int n_tiles, int k, int L) {
  if (k > KWIDE) return SEL_SCAN;
  if (k > KMAX || narrow_tail_floats(n_tiles, k, L) > RING_FLOATS)
    return SEL_WIDE;
  return SEL_NARROW;
}

// Floats of the ring a search's selection takes: the narrow tail's
// scratch, or the larger of the wide row stage's (the selection's scratch,
// a tile a warp, the tiles' max and sum-exp) and the wide tail's (the
// selection's scratch and the k-slot state where it sits in the ring; the
// candidates and sequences stay in device memory), whatever L.
__host__ __device__ inline long long tail_floats(int n_tiles, int k, int L) {
  if (sel_kind(n_tiles, k, L) == SEL_NARROW)
    return narrow_tail_floats(n_tiles, k, L);
  const long long rowsel = GB_WARPS * VT + 2LL * n_tiles;
  const long long tail = state_in_ring(k) ? tail_state_floats(k) : 0;
  return TOPK_FLOATS + (rowsel > tail ? rowsel : tail);
}

// The beam tail of the images this block owns (image b, b + G, ...): the
// live rows' merge_row, then the selection, sequence extension and
// best-completed tracking of decode/beam.py::beam_search_batched (the
// step-1 single-row special case, rank < n_alive candidate validity,
// candidate order p*k + q, strict-> tracking with the list-order
// tie-break, length = t + 2), over the image's k slots, with the image's
// state staged in shared memory.
__device__ void run_tail(const GridArgs& a, const Smem& sm,
                         const StepCtx& c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = a.k, L = a.max_seq + 2, nt = a.n_tiles, t = c.t;
  const bool first = t == 0;
  const int MW = merge_floats(nt, k);
  float* lp = sm.ring + KMAX * MW;               // (k, k) step log-probs
  int* li = reinterpret_cast<int*>(lp + k * k);  // (k, k) step ids
  int* seq = li + k * k;                         // (k, L) sequences
  int* nseq = seq + k * L;                       // (k, L) extended
  float* top = reinterpret_cast<float*>(nseq + k * L);
  float* sc = top + k;                           // beam scores
  int* al = reinterpret_cast<int*>(sc + k);      // alive
  int* pq = al + k;                              // parent slot
  int* wq = pq + k;                              // selected next words
  int* keep = wq + k;                            // [improved, slot, ...]
  float* best_s = reinterpret_cast<float*>(keep + 2);
  for (int img = blockIdx.x; img < a.n_img; img += gridDim.x) {
    const int base = img * k;
    int live_rows = 0;
    for (int q = 0; q < k; ++q) live_rows += sm.rmap[base + q] >= 0;
    if (live_rows == 0) continue;
    for (int e = tid; e < k * L; e += GB_THREADS)
      seq[e] = a.seqs[(size_t)base * L + e];
    if (tid < k) {
      al[tid] = a.alive[base + tid];
      sc[tid] = a.scores[base + tid];
    }
    if (tid == 0) *best_s = a.bscore[img];
    if (warp < k) {
      const int i = sm.rmap[base + warp];
      if (i >= 0) {
        float* mpm = sm.ring + warp * MW;
        float* mpse = mpm + nt;
        float* mpv = mpse + nt;
        int* mpi = reinterpret_cast<int*>(mpv + nt * k);
        const size_t p = (size_t)i * nt;
        for (int e = lane; e < nt; e += 32) {
          mpm[e] = __ldcg(a.pm + p + e);
          mpse[e] = __ldcg(a.pse + p + e);
        }
        for (int e = lane; e < nt * k; e += 32) {
          mpv[e] = __ldcg(a.pv + p * k + e);
          mpi[e] = __ldcg(a.pi + p * k + e);
        }
        __syncwarp();
        merge_row(mpm, mpse, mpv, mpi, nt, k, lp + warp * k, li + warp * k);
      }
    }
    __syncthreads();
    // beam select: exact top-k of the k*k candidates p*k + q, ties to the
    // lowest candidate index (lax.top_k over the flattened (k, k) totals);
    // a lane holds candidates lane and lane + 32 (k*k <= 64)
    if (warp == 0) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cand = lane + 32 * h, p = cand / k;
        v[h] = -INFINITY;
        if (cand < k * k) {
          const bool ok = first ? (p == 0) : (al[p] != 0);
          v[h] = ok ? sc[p] + lp[p * k + cand % k] : NEG;
        }
      }
      for (int q = 0; q < k; ++q) {
        const bool hi = v[1] > v[0];
        float bv = hi ? v[1] : v[0];
        int bc = lane + (hi ? 32 : 0), slot = bc;
        warp_argmax(bv, bc, slot);
        if (lane == (bc & 31)) {
          if (bc >> 5)
            v[1] = -INFINITY;
          else
            v[0] = -INFINITY;
        }
        if (lane == 0) {
          top[q] = bv;
          pq[q] = bc / k;
          wq[q] = li[(bc / k) * k + bc % k];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < k * L; e += GB_THREADS) {
      const int q = e / L, pos = e % L;
      const int v = pos == t + 1 ? wq[q] : seq[pq[q] * L + pos];
      nseq[e] = v;
      a.seqs[(size_t)base * L + e] = v;
    }
    // best-completed tracking (strict >, first rank among equals), then
    // the surviving beams become the next step's live slots
    if (tid == 0) {
      int n_take = k;
      if (!first) {
        n_take = 0;
        for (int p = 0; p < k; ++p) n_take += al[p];
      }
      float best = NEG;
      int ib = 0;
      for (int q = 0; q < k; ++q) {
        const bool completed = q < n_take && wq[q] == a.end;
        const float cv = completed ? top[q] : NEG;
        if (q == 0 || cv > best) {
          best = cv;
          ib = q;
        }
      }
      keep[0] = best > *best_s;
      keep[1] = ib;
      if (keep[0]) {
        a.bscore[img] = best;
        a.score[img] = best;
        a.len[img] = t + 2;
      }
      a.steps[2 * img] += 1;
      a.steps[2 * img + 1] += live_rows;
    }
    if (tid < k) {
      int n_take = k;
      if (!first) {
        n_take = 0;
        for (int p = 0; p < k; ++p) n_take += al[p];
      }
      const bool still = tid < n_take && wq[tid] != a.end;
      a.alive[base + tid] = still ? 1 : 0;
      a.scores[base + tid] = still ? top[tid] : NEG;
      a.word[base + tid] = wq[tid];
      a.prev[base + tid] = pq[tid];
    }
    __syncthreads();
    if (keep[0])
      for (int e = tid; e < L; e += GB_THREADS)
        a.tok[(size_t)img * L + e] = nseq[keep[1] * L + e];
    __syncthreads();
  }
}

// The ring past `used` floats (rounded up to 8 bytes) as a sort buffer of
// up to `want` pairs: its pairs, 0 where fewer than `want` fit.
__device__ __forceinline__ int ring_pairs(long long used, int want) {
  used = (used + 1) & ~1LL;
  return want > 0 && used + 2LL * want <= RING_FLOATS ? want : 0;
}

// The wide row stage: a block a live row in turn, its logZ and exact
// top-k (wide_row: K1's wide reduce, the same bits) into pv, pi at the
// row's place, (rows, k) each; SCAN: the survivors sorted in the ring
// where pow2_ceil(k) pairs fit it, else in the block's cand.  The row is
// staged in the ring where V floats still fit beside them.
template <bool SCAN>
__device__ void run_rowsel(const GridArgs& a, const Smem& sm, int n) {
  TopkScratch* s = reinterpret_cast<TopkScratch*>(sm.ring);
  float* lt = sm.ring + TOPK_FLOATS;  // a tile a warp
  float* pm = lt + GB_WARPS * VT;
  float* pse = pm + a.n_tiles;
  const long long used = (pse + a.n_tiles - sm.ring + 1) & ~1LL;
  const int scap = SCAN ? ring_pairs(used, pow2_ceil(a.k)) : 0;
  unsigned long long* sbuf =
      reinterpret_cast<unsigned long long*>(sm.ring + used);
  const long long used2 = used + 2LL * scap;
  float* stage = used2 + a.V <= RING_FLOATS ? sm.ring + used2 : nullptr;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const size_t r = sm.list[i];
    float* lp = a.pv + r * a.k;
    int* li = a.pi + r * a.k;
    wide_row<SCAN>(
        a.logits + (size_t)i * a.Vp, a.V, a.k, lt, pm, pse, s,
        [&](int q, int col, float v) {
          lp[q] = v;
          li[q] = col;
        },
        SCAN ? a.cand + (size_t)blockIdx.x * a.k : nullptr, stage, sbuf,
        scap);
  }
}

// Blocks an image's wide tail takes (SEL_SCAN): g = gridDim / images where
// that is at least 2 and an image has at least SPREAD_MIN candidates, else
// 1 (the image in one block).
constexpr long long SPREAD_MIN = 32768;
__device__ __forceinline__ int tail_spread(const GridArgs& a) {
  const int g = gridDim.x / a.n_img;
  return g >= 2 && (long long)a.k * a.k >= SPREAD_MIN ? g : 1;
}

// The selection of a spread wide tail (g blocks an image): block (image
// blockIdx / g, part blockIdx % g) takes candidates [n part / g, n (part +
// 1) / g) of its image's n = k k; block_select's radix passes, each block
// a histogram of its share into its own device-memory area (its cand,
// double-buffered by pass), merged by every block of the image in part
// order after a grid barrier; then each block's count of survivors, their
// places by a prefix over the parts, the survivors into part 0's cand, and
// part 0 (the owner) orders them (sorted in the ring where they fit, else
// ranked) -> emit(rank, candidate).  pair(c): the 64-bit (key, c).  Every
// block of the grid calls it with the same g (the same barriers).
template <class Pair, class Emit>
__device__ void spread_select(const GridArgs& a, TopkScratch* s, int g,
                              bool act, Pair pair, unsigned long long* sbuf,
                              int scap, Emit emit, unsigned& gen) {
  const int tid = threadIdx.x, nt = GB_THREADS, k = a.k;
  const int img = blockIdx.x / g, part = blockIdx.x % g;
  const long long n = (long long)k * k;
  const int c0 = (int)(n * part / g), c1 = (int)(n * (part + 1) / g);
  int* area = reinterpret_cast<int*>(a.cand + (size_t)blockIdx.x * k);
  auto area_of = [&](int q) {
    return reinterpret_cast<const int*>(a.cand + (size_t)(img * g + q) * k);
  };
  unsigned long long prefix = 0, mask = 0;
  bool done = !act;
  if (tid == 0) s->rem = k;
  int buf = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (shift > 0 && shift < 32 && ((unsigned)(n - 1) >> shift) == 0) {
      mask |= 0xffull << shift;
      continue;
    }
    for (int i = tid; i < 256; i += nt) s->hist[i] = 0;
    __syncthreads();
    if (!done) {
      int c = c0 + tid;
      for (; c + 3 * nt < c1; c += 4 * nt) {   // four reads in flight
        unsigned long long p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) p[u] = pair(c + u * nt);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if ((p[u] & mask) == prefix)
            atomicAdd(&s->hist[(p[u] >> shift) & 255], 1);
      }
      for (; c < c1; c += nt) {
        const unsigned long long p = pair(c);
        if ((p & mask) == prefix) atomicAdd(&s->hist[(p >> shift) & 255], 1);
      }
    }
    __syncthreads();
    for (int i = tid; i < 256; i += nt)
      __stcg(area + 256 * buf + i, s->hist[i]);
    grid_sync(a.bar, gen);
    if (!done) {   // the same in every block of the image
      for (int i = tid; i < 256; i += nt) {
        int sum = 0;
        for (int q = 0; q < g; ++q) sum += __ldcg(area_of(q) + 256 * buf + i);
        s->hist[i] = sum;
      }
      __syncthreads();
      if (tid < 32) pick_bin(s->hist, s->rem, s);
      __syncthreads();
      prefix |= (unsigned long long)s->bin << shift;
      mask |= 0xffull << shift;
      done = s->cnt == s->rem;
      __syncthreads();   // s->cnt, s->rem read before the next pass
    }
    buf ^= 1;
  }
  const unsigned long long tau = prefix | ~mask;   // exactly k pairs <= tau
  int mine = 0;
  if (act)
    for (int c = c0 + tid; c < c1; c += nt) mine += pair(c) <= tau;
  int total;
  int off = block_excl_scan(mine, s->wsum, total);
  if (tid == 0) __stcg(area + 512, total);
  grid_sync(a.bar, gen);
  if (act)
    for (int q = 0; q < part; ++q) off += __ldcg(area_of(q) + 512);
  grid_sync(a.bar, gen);   // every count read before part 0's cand is written
  unsigned long long* out = a.cand + (size_t)img * g * k;
  if (act)
    for (int c = c0 + tid; c < c1 && mine > 0; c += nt) {
      const unsigned long long p = pair(c);
      if (p <= tau) {
        __stcg(out + off++, p);
        --mine;
      }
    }
  grid_sync(a.bar, gen);
  if (!act || part != 0) return;
  const bool sorted = pow2_ceil(k) <= scap;
  if (sorted)
    for (int i = tid; i < k; i += nt) sbuf[i] = __ldcg(out + i);
  __syncthreads();
  emit_in_order(k, sorted ? sbuf : out, sorted, s, emit);
}

// The wide beam tail of the images this block owns: run_tail's semantics
// (candidate order p*k + q, rank < n_alive validity, strict-> tracking,
// length = t + 2) with the top-k of an image's k*k candidates taken by
// block_topk from the row stage's log-probs in device memory, and the
// sequences read from plane t % 2 of seqs and written to the other (seqs
// holds two (rows, L) planes).  SCAN: the survivors in the block's cand,
// the slot state in its tstate where it does not fit the ring.
template <bool SCAN>
__device__ void run_tail_wide(const GridArgs& a, const Smem& sm,
                              const StepCtx& c, unsigned& gen) {
  const int tid = threadIdx.x;
  const int k = a.k, L = a.max_seq + 2, t = c.t;
  const bool first = t == 0;
  TopkScratch* s = reinterpret_cast<TopkScratch*>(sm.ring);
  float* sc = sm.ring + TOPK_FLOATS;             // beam scores
  if (SCAN && !state_in_ring(k))
    sc = a.tstate + (size_t)blockIdx.x * tail_state_floats(k);
  float* top = sc + k;                           // selected totals
  int* al = reinterpret_cast<int*>(top + k);     // alive
  int* pq = al + k;                              // parent slot
  int* wq = pq + k;                              // selected next words
  int* keep = wq + k;                            // [improved, slot, n_take]
  float* best_s = reinterpret_cast<float*>(keep + 3);
  // SCAN: the survivors' sort buffer in the ring past the state
  const long long used =
      TOPK_FLOATS + (state_in_ring(k) ? tail_state_floats(k) : 0);
  const int scap = SCAN ? ring_pairs(used, pow2_ceil(k)) : 0;
  unsigned long long* sbuf =
      reinterpret_cast<unsigned long long*>(sm.ring + ((used + 1) & ~1LL));
  const size_t plane = (size_t)a.rows * L;
  const int* seq_in = a.seqs + (t & 1) * plane;
  int* seq_out = a.seqs + ((t & 1) ^ 1) * plane;
  const int g = SCAN ? tail_spread(a) : 1;
  for (int img = g > 1 ? blockIdx.x / g : blockIdx.x;
       g > 1 ? img == (int)blockIdx.x / g : img < a.n_img;
       img += g > 1 ? 1 : gridDim.x) {
    const int base = img * k;
    const bool in = img < a.n_img;
    int live_rows = 0;
    if (in)
      for (int q = 0; q < k; ++q) live_rows += sm.rmap[base + q] >= 0;
    if (live_rows == 0 && g == 1) continue;
    if (live_rows > 0) {
      for (int q = tid; q < k; q += GB_THREADS) {
        al[q] = a.alive[base + q];
        sc[q] = a.scores[base + q];
      }
      if (tid == 0) *best_s = a.bscore[img];
    }
    __syncthreads();
    const float* lp = a.pv + (size_t)base * k;  // candidate p*k + q at p*k + q
    const int* li = a.pi + (size_t)base * k;
    auto total = [&](int cand) {
      const int p = cand / k;
      const bool ok = first ? (p == 0) : (al[p] != 0);
      return ok ? sc[p] + __ldcg(lp + cand) : NEG;
    };
    auto emit = [&](int q, int cand) {
      top[q] = total(cand);
      pq[q] = cand / k;
      wq[q] = __ldcg(li + cand);
    };
    if (g > 1) {   // every block meets spread_select's barriers
      spread_select(
          a, s, g, live_rows > 0,
          [&](int cand) {
            return ((unsigned long long)desc_key(total(cand)) << 32) |
                   (unsigned)cand;
          },
          sbuf, scap, emit, gen);
      if (live_rows == 0 || blockIdx.x % g != 0) break;
    } else {
      block_topk<SCAN>(k * k, k, total, s, emit,
                       SCAN ? a.cand + (size_t)blockIdx.x * k : nullptr,
                       sbuf, scap);
    }
    for (int e = tid; e < k * L; e += GB_THREADS) {
      const int q = e / L, pos = e % L;
      seq_out[(size_t)base * L + e] =
          pos == t + 1 ? wq[q]
                       : __ldcg(seq_in + (size_t)(base + pq[q]) * L + pos);
    }
    if (tid == 0) {
      int n_take = k;
      if (!first) {
        n_take = 0;
        for (int p = 0; p < k; ++p) n_take += al[p];
      }
      float best = NEG;
      int ib = 0;
      for (int q = 0; q < k; ++q) {
        const bool completed = q < n_take && wq[q] == a.end;
        const float cv = completed ? top[q] : NEG;
        if (q == 0 || cv > best) {
          best = cv;
          ib = q;
        }
      }
      keep[0] = best > *best_s;
      keep[1] = ib;
      keep[2] = n_take;
      if (keep[0]) {
        a.bscore[img] = best;
        a.score[img] = best;
        a.len[img] = t + 2;
      }
      a.steps[2 * img] += 1;
      a.steps[2 * img + 1] += live_rows;
    }
    __syncthreads();
    for (int q = tid; q < k; q += GB_THREADS) {
      const bool still = q < keep[2] && wq[q] != a.end;
      a.alive[base + q] = still ? 1 : 0;
      a.scores[base + q] = still ? top[q] : NEG;
      a.word[base + q] = wq[q];
      a.prev[base + q] = pq[q];
    }
    if (keep[0]) {
      const int q = keep[1];
      for (int e = tid; e < L; e += GB_THREADS)
        a.tok[(size_t)img * L + e] =
            e == t + 1 ? wq[q]
                       : __ldcg(seq_in + (size_t)(base + pq[q]) * L + e);
    }
    __syncthreads();
  }
}

// Where a search's time goes, for a probe (off unless icee_grid_profile
// turned it on; a launch with it off pays one shared-memory load in block
// 0's thread 0 a mark): block 0's thread 0 stamps %globaltimer
// after the barriers that end a step's parts and adds each part's time,
// in ns, to g_gb_prof: [0] the live-row scan and the products, [1] the
// row stage (narrow: the tile partials), [2] the tail; [4] counts steps,
// [6] and [7] hold the last stamps.  Every block passed each barrier
// before block 0 leaves it, so a part's time is the card's.  Each product
// stage (and K7's scores and softmax stages) also appends a record to
// g_gb_rec: (live rows << 32 | stage << 8 | tiles taken, ns since the
// last record or the step's start), GB_RECORDS of them at most.
constexpr int GB_RECORDS = 4096;
constexpr int GB_SCORES = MAX_STAGES, GB_SOFTMAX = MAX_STAGES + 1;
__device__ unsigned long long g_gb_prof[8];
__device__ unsigned long long g_gb_rec[2 * GB_RECORDS];
__device__ int g_gb_nrec;

__device__ __forceinline__ unsigned long long gb_now() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

__device__ __forceinline__ void gb_mark(int part) {   // -1: a step starts
  if (blockIdx.x != 0 || threadIdx.x != 0 || !g_gb_prof_blk) return;
  const unsigned long long ns = gb_now();
  if (part >= 0) {
    g_gb_prof[part] += ns - g_gb_prof[7];
  } else {
    g_gb_prof[4] += 1;
    g_gb_prof[6] = ns;
  }
  g_gb_prof[7] = ns;
}

// After stage `id`'s barrier: its record (see g_gb_rec).
__device__ __forceinline__ void gb_stage(int id, int n, bool tiles) {
  if (blockIdx.x != 0 || threadIdx.x != 0 || !g_gb_prof_blk) return;
  const unsigned long long ns = gb_now();
  const int r = g_gb_nrec;
  if (r < GB_RECORDS) {
    g_gb_rec[2 * r] = ((unsigned long long)n << 32) | (id << 8) | tiles;
    g_gb_rec[2 * r + 1] = ns - g_gb_prof[6];
    g_gb_nrec = r + 1;
  }
  g_gb_prof[6] = ns;
}

// A step's selection after its logits: the tile partials and the beam tail
// (SEL_NARROW), or the wide row stage and tail; a grid barrier after each.
// The kernels are instantiated once for each Sel, so that the narrower
// kernels are compiled as they were before the wider paths.
template <int SEL>
__device__ void run_selection(const GridArgs& a, const Smem& sm,
                              const StepCtx& c, unsigned& gen) {
  gb_mark(0);
  if constexpr (SEL != SEL_NARROW) {
    run_rowsel<SEL == SEL_SCAN>(a, sm, c.n);
    grid_sync(a.bar, gen);
    gb_mark(1);
    run_tail_wide<SEL == SEL_SCAN>(a, sm, c, gen);
  } else {
    run_partials(a, sm, c.n);
    grid_sync(a.bar, gen);
    gb_mark(1);
    run_tail(a, sm, c);
  }
  grid_sync(a.bar, gen);
  gb_mark(2);
}

// The probe's switch: out (8 words of host memory, or null) <- the parts'
// sums so far; then the sums zeroed and the marks on (on != 0) or off.
inline cudaError_t grid_profile(int on, unsigned long long* out) {
  unsigned long long z[8] = {};
  const int none = 0;
  cudaError_t e = cudaSuccess;
  if (out != nullptr) e = cudaMemcpyFromSymbol(out, g_gb_prof, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_gb_prof, z, sizeof(z));
  if (e == cudaSuccess && on)
    e = cudaMemcpyToSymbol(g_gb_nrec, &none, sizeof(none));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_gb_prof_on, &on, sizeof(on));
  return e;
}

// The stage records since the profile was last turned on: *n <- their
// count, out (2 * cap words) <- the first cap of them.
inline cudaError_t grid_records(unsigned long long* out, int cap, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_gb_nrec, sizeof(int));
  const int m = *n < cap ? *n : cap;
  if (e == cudaSuccess && m > 0)
    e = cudaMemcpyFromSymbol(out, g_gb_rec, 2 * sizeof(unsigned long long) * m);
  return e;
}

}  // namespace icee

// --- host side ---------------------------------------------------------------

namespace icee {

inline Job bias_job(const float* W, long long wseg, int ldw, int K, int nseg,
                    int segw, int amode, const float* A, int lda, int aseg,
                    const float* bias, float* out, int ldo) {
  Job j = {};
  j.W = W;
  j.wseg = wseg;
  j.ldw = ldw;
  j.K = K;
  j.nseg = nseg;
  j.segw = segw;
  j.amode = amode;
  j.A = A;
  j.lda = lda;
  j.aseg = aseg;
  j.bias = bias;
  j.out = out;
  j.ldo = ldo;
  j.epi = E_BIAS;
  return j;
}

// The stages' slab tables and geometry from the plan's arrays, and the
// checks every product stage must pass: a slab width the chunk templates
// take, a row block the threads and the slot hold.
inline cudaError_t set_stages(GridArgs& a, int n_stages,
                              const long long* cw, const long long* br,
                              const long long* n_slabs,
                              const long long* slab0, const int* slabs,
                              const long long* t_slabs = nullptr,
                              const long long* t_slab0 = nullptr,
                              const long long* t_min = nullptr) {
  if (n_stages < 1 || n_stages > MAX_STAGES) return cudaErrorInvalidValue;
  a.n_stages = n_stages;
  for (int s = 0; s < n_stages; ++s) {
    Stage& S = a.st[s];
    S.cw = (int)cw[s];
    S.br = (int)br[s];
    S.n_slabs = (int)n_slabs[s];
    S.slabs = reinterpret_cast<const int4*>(slabs) + slab0[s];
    S.n_tslabs = t_min != nullptr ? (int)t_slabs[s] : 0;
    S.tmin = t_min != nullptr ? (int)t_min[s] : 0;
    S.tslabs = reinterpret_cast<const int4*>(slabs) +
               (t_min != nullptr ? t_slab0[s] : 0);
    if ((S.cw != 16 && S.cw != 32 && S.cw != 64) || S.br < 1 ||
        S.br > MAX_BR || S.br > 2 * (GB_THREADS / (S.cw / 4)) ||
        S.n_slabs < 1 || S.n_jobs < 1 || S.job0 < 0 ||
        S.job0 + S.n_jobs > a.n_jobs || S.tmin < 0 ||
        (S.tmin > 0 && (S.n_tslabs < 1 || S.per_img)))
      return cudaErrorInvalidValue;
    // tiles hold one gate job (they run the cell on its columns), of one
    // chain (not the LSTM cell's two), or plain jobs
    for (int j = 0; j < S.n_jobs && S.tmin > 0; ++j) {
      const Job& J = a.jobs[S.job0 + j];
      if ((J.gates && S.n_jobs > 1) || J.W2 != nullptr ||
          J.epi == E_GATES_L || J.epi == E_CTX)
        return cudaErrorInvalidValue;
    }
    for (int j = 0; j < S.n_jobs; ++j) {
      const Job& J = a.jobs[S.job0 + j];
      const int sets = (J.gates && J.amode == A_DENSE && J.aseg) ? 4 : 1;
      if (KC * S.cw + sets * S.br * KCP > SLOT_FLOATS ||
          sets * S.br > MAX_UNIT_ROWS)
        return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

// A stage of jobs [job0, job0 + n_jobs) (units (slab, live image) where
// per_img); returns the next free job.
inline int stage_of(GridArgs& a, int s, int job0, int n_jobs,
                    int per_img = 0) {
  a.st[s].job0 = job0;
  a.st[s].n_jobs = n_jobs;
  a.st[s].per_img = per_img;
  return job0 + n_jobs;
}

// What both kernels' plans (beam.cu GridPlan, att_beam.cu AttGridPlan)
// hold alike: checks them against what the kernels take, then fills the
// stages, the search's scratch (fs, is at the plan's offsets), its outputs
// and widths into the launch's arguments.
template <class Plan>
inline cudaError_t search_args(GridArgs& a, const Plan& p, const int* slabs,
                               float* fs, int* is, int* tok, int* len,
                               float* score) {
  if (p.k < 1 || p.k > MAX_K || p.n_img < 1 ||
      (p.n_img * p.k > MAX_ROWS && p.n_img > 1) || p.E < 1 || p.H < 4 ||
      p.H % 4 || p.F % 4 || p.V < p.k || p.V % 4 || p.max_seq < 0 ||
      p.grid < 1 || p.n_tiles != (p.V + VT - 1) / VT ||
      p.Vp != p.n_tiles * VT ||
      tail_floats((int)p.n_tiles, (int)p.k, (int)p.max_seq + 2) >
          RING_FLOATS)
    return cudaErrorInvalidValue;
  cudaError_t e = set_stages(a, (int)p.n_stages, p.cw, p.br, p.n_slabs,
                             p.slab0, slabs, p.t_slabs, p.t_slab0, p.t_min);
  if (e != cudaSuccess) return e;
  a.hn = fs + p.o_hn;
  a.cn = fs + p.o_cn;
  a.logits = fs + p.o_logits;
  a.pm = fs + p.o_pm;
  a.pse = fs + p.o_pse;
  a.pv = fs + p.o_pv;
  a.scores = fs + p.o_scores;
  a.bscore = fs + p.o_bscore;
  a.pi = is + p.o_pi;
  a.alive = is + p.o_alive;
  a.word = is + p.o_word;
  a.prev = is + p.o_prev;
  a.seqs = is + p.o_seqs;
  a.steps = is + p.o_steps;
  a.bar = reinterpret_cast<unsigned*>(is + p.o_bar);
  a.tok = tok;
  a.len = len;
  a.score = score;
  a.E = (int)p.E;
  a.H = (int)p.H;
  a.V = (int)p.V;
  a.Vp = (int)p.Vp;
  a.n_tiles = (int)p.n_tiles;
  a.k = (int)p.k;
  a.n_img = (int)p.n_img;
  a.rows = (int)(p.n_img * p.k);
  a.max_seq = (int)p.max_seq;
  a.start = (int)p.start;
  a.end = (int)p.end;
  a.xvec = p.E % 4 == 0;
  a.ald = ALD;
  a.cand = nullptr;
  a.tstate = nullptr;
  a.lists = nullptr;
  if (sel_kind(a.n_tiles, a.k, a.max_seq + 2) == SEL_SCAN) {
    a.cand = reinterpret_cast<unsigned long long*>(is + p.o_cand);
    if (!state_in_ring(a.k))
      a.tstate = reinterpret_cast<float*>(is + p.o_tstate);
    if (a.rows > MAX_ROWS) a.lists = is + p.o_lists;
  }
  return cudaSuccess;
}

// Whether a plan's search takes tiles in any stage (its kernel is then the
// instantiation that holds them).
template <class Plan>
inline bool has_tiles(const Plan& p) {
  for (int s = 0; s < p.n_stages; ++s)
    if (p.t_min[s] > 0) return true;
  return false;
}

// The kernel instantiation (of narrow, wide, scan) a plan's search runs.
template <class Plan>
inline const void* sel_kernel(const Plan& p, const void* narrow,
                              const void* wide, const void* scan) {
  const int sel = sel_kind((int)p.n_tiles, (int)p.k, (int)p.max_seq + 2);
  return sel == SEL_SCAN ? scan : sel == SEL_WIDE ? wide : narrow;
}

// Blocks of one cooperative launch of `kernel` on the current device:
// co-resident blocks per SM times the SMs.
inline int grid_max_blocks(const void* kernel, int* out) {
  *out = 0;
  int dev = 0, sms = 0, per = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)grid_smem_bytes());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, kernel, GB_THREADS, grid_smem_bytes());
  if (e == cudaSuccess && per < 1) e = cudaErrorInvalidConfiguration;
  *out = per * sms;
  return e;
}

// The blocks of one cooperative launch that every instantiation of a
// search kernel (one a Sel) holds: the fewest.
inline int grid_max_blocks3(const void* narrow, const void* wide,
                            const void* scan, int* out) {
  int n = 0, w = 0, x = 0;
  cudaError_t e = static_cast<cudaError_t>(grid_max_blocks(narrow, &n));
  if (e == cudaSuccess) e = static_cast<cudaError_t>(grid_max_blocks(wide, &w));
  if (e == cudaSuccess) e = static_cast<cudaError_t>(grid_max_blocks(scan, &x));
  n = n < w ? n : w;
  *out = n < x ? n : x;
  return e;
}

// One cooperative launch of `kernel` over `grid` blocks.
inline cudaError_t grid_launch(const void* kernel, const GridArgs& a,
                               int grid, void* stream) {
  const size_t smem = grid_smem_bytes(a.ald);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<GridArgs*>(&a)};
  e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid),
                                  dim3(GB_THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace icee
