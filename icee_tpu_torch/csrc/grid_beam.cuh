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
//     block's part of the same k range;
//   - the tile partials (run_partials: every 256-wide logits tile of every
//     live row through tile_reduce, a warp a tile) and the beam tail
//     (run_tail: each image in one block, merge_row of its live rows, the
//     selection, the sequences, best-completed tracking).
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
constexpr int MAX_ROWS = 1024;         // rows (images x k) of one launch
constexpr int MAX_STAGES = 8;
constexpr int MAX_JOBS = 12;           // products of a launch, all stages
constexpr int MAX_P = 256;             // positions of an attended image
constexpr int ALD = MAX_P + 4;         // row stride of a unit's softmax rows
constexpr int ALPHA_FLOATS = KMAX * ALD;

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
  int job0, n_jobs, cw, br, n_slabs, per_img;
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
};

struct Smem {
  float* ring;          // the chunk ring; the partials and tail scratch
  float* zs;            // a gate unit's z, (4, nr, cw / 4)
  float* alpha;         // a per-image unit's softmax rows, (KMAX, ALD)
  const float** xptr;   // compact row -> its step input row
  int* list;            // compact row -> row
  int* hsrc;            // compact row -> the row of its h, c (-1: zeros)
  int* rmap;            // row -> compact row (-1: not live)
  int* img;             // live image -> image
  int* ifirst;          // live image -> its first compact row
  int* icount;          // live image -> its live rows
  int* wcount;          // the scan's per-warp counts
};

__host__ __device__ constexpr size_t grid_smem_bytes() {
  return sizeof(float) * (RING_FLOATS + ZS_FLOATS + ALPHA_FLOATS) +
         sizeof(float*) * MAX_ROWS + sizeof(int) * (6 * MAX_ROWS + 32);
}

__device__ inline Smem carve_smem(float* base) {
  Smem s;
  s.ring = base;
  s.zs = s.ring + RING_FLOATS;
  s.alpha = s.zs + ZS_FLOATS;
  s.xptr = reinterpret_cast<const float**>(s.alpha + ALPHA_FLOATS);
  s.list = reinterpret_cast<int*>(s.xptr + MAX_ROWS);
  s.hsrc = s.list + MAX_ROWS;
  s.rmap = s.hsrc + MAX_ROWS;
  s.img = s.rmap + MAX_ROWS;
  s.ifirst = s.img + MAX_ROWS;
  s.icount = s.ifirst + MAX_ROWS;
  s.wcount = s.icount + MAX_ROWS;
  return s;
}

// The launch's jobs and stages into shared memory (read every chunk), each
// stage pointed at its jobs.  Ends with a barrier.
__device__ inline void load_plan(const GridArgs& a, Job* jobs,
                                 Stage* stages) {
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
    if (tid < k) {
      a.alive[base + tid] = 1;
      a.scores[base + tid] = 0.f;
      a.word[base + tid] = 0;
      a.prev[base + tid] = 0;
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
// row and count (an image's live rows are adjacent).  Ends with a barrier.
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
  c.n_img = compact(
      a.n_img, sm,
      [&](int img) {
        bool any = false;
        for (int q = 0; q < a.k; ++q) any |= sm.rmap[img * a.k + q] >= 0;
        return any;
      },
      [&](int idx, int img) {
        if (idx < 0) return;
        int first = -1, cnt = 0;
        for (int q = 0; q < a.k; ++q) {
          const int i = sm.rmap[img * a.k + q];
          if (i >= 0) {
            if (first < 0) first = i;
            ++cnt;
          }
        }
        sm.img[idx] = img;
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
__device__ __forceinline__ int row_sets(const Job& J, int amode) {
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
    sm.alpha[r * ALD + p] = __ldcg(a.esc + (size_t)(x.i0 + r) * P + p);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp < x.nr) softmax_row(sm.alpha + warp * ALD, P, nullptr);
  __syncthreads();
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

// One product stage: this block's units in turn, their chunks streamed
// through the ring (one barrier a chunk; the next unit's chunks are in
// flight while a unit finishes).
__device__ void run_stage(const GridArgs& a, const Stage& S, const Smem& sm,
                          const StepCtx& c) {
  const int n = c.n;
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
      const float* a0 = cc.alpha ? sm.alpha + t.lane * ALD + k0
                                 : slot + KC * t.cw + (ph ? cc.aoff1 : cc.aoff0);
      compute(slot, t.cw, min(KC, (ph ? cc.K1 : cc.K0) - k0), t.q, a0,
              cc.alpha ? t.lanes * ALD : t.lanes * KCP, cc.two, acc);
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

// Floats of the tail's per-image state after the merging warps' copies:
// log-probs, ids, sequences old and new, and the k-slot state.
__host__ __device__ inline int tail_floats(int n_tiles, int k, int L) {
  return KMAX * merge_floats(n_tiles, k) + 2 * k * k + 2 * k * L + 6 * k + 4;
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
                              const long long* slab0, const int* slabs) {
  if (n_stages < 1 || n_stages > MAX_STAGES) return cudaErrorInvalidValue;
  a.n_stages = n_stages;
  for (int s = 0; s < n_stages; ++s) {
    Stage& S = a.st[s];
    S.cw = (int)cw[s];
    S.br = (int)br[s];
    S.n_slabs = (int)n_slabs[s];
    S.slabs = reinterpret_cast<const int4*>(slabs) + slab0[s];
    if ((S.cw != 16 && S.cw != 32 && S.cw != 64) || S.br < 1 ||
        S.br > MAX_BR || S.br > 2 * (GB_THREADS / (S.cw / 4)) ||
        S.n_slabs < 1 || S.n_jobs < 1 || S.job0 < 0 ||
        S.job0 + S.n_jobs > a.n_jobs)
      return cudaErrorInvalidValue;
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
  if (p.k < 1 || p.k > KMAX || p.n_img < 1 || p.n_img * p.k > MAX_ROWS ||
      p.E < 1 || p.H < 4 || p.H % 4 || p.F % 4 || p.V < p.k || p.V % 4 ||
      p.max_seq < 0 || p.grid < 1 || p.n_tiles != (p.V + VT - 1) / VT ||
      p.Vp != p.n_tiles * VT ||
      tail_floats((int)p.n_tiles, (int)p.k, (int)p.max_seq + 2) >
          RING_FLOATS)
    return cudaErrorInvalidValue;
  cudaError_t e = set_stages(a, (int)p.n_stages, p.cw, p.br, p.n_slabs,
                             p.slab0, slabs);
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
  return cudaSuccess;
}

// Blocks of one cooperative launch of `kernel` on the current device:
// co-resident blocks per SM times the SMs.
inline int grid_max_blocks(const void* kernel, int* out) {
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

// One cooperative launch of `kernel` over `grid` blocks.
inline cudaError_t grid_launch(const void* kernel, const GridArgs& a,
                               int grid, void* stream) {
  const size_t smem = grid_smem_bytes();
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
