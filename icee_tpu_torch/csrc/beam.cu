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
// the stages of a step:
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
// and runs each output's fmaf chain from shared memory.  Intermediates (v,
// hW, s, h', c', the logits, the tile partials) live in device memory (L2)
// and are read across a barrier through L2 only (cp.async.cg, __ldcg).  The
// tile partials stage takes every 256-wide logits tile of every live row
// through tile_reduce, a warp a tile; the beam tail runs each image in one
// block (merge_row of its live rows, the selection, the sequences,
// best-completed tracking).  Once no beam is alive every block leaves after
// the barrier.
//
// Bits: every output is the same sequential fmaf chain in k order from 0.f
// as dot4's (decode_common.cuh), with the same bias adds after and the same
// cell arithmetic, built with -fmad=false; a chain's k range is never
// split.  So a row's h', c', logits and top-k are those of K1 (both of its
// paths) and do not depend on the grid's size or on which rows share a
// step; the serving engine's serial and batched paths return the same
// captions.
#include "decode_common.cuh"
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
constexpr int MAX_STAGES = 4;
constexpr int MAX_JOBS = 2;

enum AMode { A_X, A_HPREV, A_HCUR, A_DENSE };
enum Epi { E_BIAS, E_GATES_F, E_GATES_L };

// The launch plan (ops/beam.py::GridPlan mirrors it field by field).
struct GridPlan {
  long long cell, E, F, H, V, k, n_img, max_seq, start, end, feed;
  long long Vp, n_tiles, grid, n_stages;
  long long cw[MAX_STAGES], br[MAX_STAGES], n_slabs[MAX_STAGES],
      slab0[MAX_STAGES];
  // float scratch offsets
  long long o_v, o_hw, o_s, o_hn, o_cn, o_logits, o_pm, o_pse, o_pv,
      o_scores, o_bscore;
  // int scratch offsets
  long long o_pi, o_alive, o_word, o_prev, o_seqs, o_steps, o_bar;
};

// One product of a stage: for segment s < nseg and column j < segw of it,
// the output of a live row is a chain over k < K of A[row][s * aseg + k] *
// W[s * wseg + k * ldw + j] (a gate product: then a second chain over K2
// with W2 and amode2, the LSTM cell's h W_hh), then the epilogue.
struct Job {
  const float* W;
  const float* W2;
  const float* A;       // A_DENSE: compact row i at A + i * lda
  const float* bias;    // E_BIAS: (nseg * segw); a gate product: b1 (4H)
  const float* bias2;   // E_GATES_L: b_hh
  const float* hw;      // E_GATES_F: (rows, 4H) h W_w + W_b
  float* out;           // E_BIAS: compact row i at out + i * ldo
  long long wseg;
  int ldw, K, K2, nseg, segw, gates, amode, amode2, lda, aseg, epi, ldo;
};

struct Stage {
  Job job[MAX_JOBS];
  const int4* slabs;  // (job, segment, first column, width)
  int n_jobs, cw, br, n_slabs;
};

struct GridArgs {
  Stage st[MAX_STAGES];
  const float* feats;  // (n_img * k, E) or null (research mode)
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
  int n_stages, E, H, V, Vp, n_tiles, k, n_img, rows, max_seq, start, end,
      feed, xvec;
};

struct Smem {
  float* ring;          // the chunk ring; the partials and tail scratch
  float* zs;            // a gate unit's z, (4, nr, cw / 4)
  const float** xptr;   // compact row -> its step input row
  int* list;            // compact row -> row
  int* hsrc;            // compact row -> the row of its h, c (-1: zeros)
  int* rmap;            // row -> compact row (-1: not live)
  int* wcount;          // the scan's per-warp counts
};

__host__ __device__ constexpr size_t grid_smem_bytes() {
  return sizeof(float) * (RING_FLOATS + ZS_FLOATS) +
         sizeof(float*) * MAX_ROWS + sizeof(int) * (3 * MAX_ROWS + 32);
}

__device__ inline Smem carve_smem(float* base) {
  Smem s;
  s.ring = base;
  s.zs = s.ring + RING_FLOATS;
  s.xptr = reinterpret_cast<const float**>(s.zs + ZS_FLOATS);
  s.list = reinterpret_cast<int*>(s.xptr + MAX_ROWS);
  s.hsrc = s.list + MAX_ROWS;
  s.rmap = s.hsrc + MAX_ROWS;
  s.wcount = s.rmap + MAX_ROWS;
  return s;
}

struct StepCtx {
  int t, n, par;
  const float* hn_prev;
  const float* cn_prev;
  float* hn_cur;
  float* cn_cur;
};

// One unit: a slab over a block of live rows [i0, i0 + nr).
struct Unit {
  int4 slab;
  int i0, nr, nch0, nch;
};

__device__ __forceinline__ const Job& job_of(const Stage& S, int j) {
  return j ? S.job[1] : S.job[0];
}

__device__ inline Unit unit_of(const Stage& S, int u, int n, int n_rb) {
  Unit x;
  x.slab = __ldg(S.slabs + u % S.n_slabs);
  const int rb = u / S.n_slabs, base = n / n_rb, rem = n % n_rb;
  x.i0 = rb * base + min(rb, rem);
  x.nr = base + (rb < rem ? 1 : 0);
  const Job& J = job_of(S, x.slab.x);
  x.nch0 = (J.K + KC - 1) / KC;
  x.nch = x.nch0 + (J.W2 != nullptr ? (J.K2 + KC - 1) / KC : 0);
  return x;
}

// Every block: the live rows of step t, in row order.  Step 1 runs slot 0
// of each image (every candidate comes from it); later steps the slots
// whose beam is alive.  Returns their count; ends with a barrier.
__device__ int scan_rows(const GridArgs& a, const Smem& sm, int t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int base = 0;
  for (int r0 = 0; r0 < a.rows; r0 += GB_THREADS) {
    const int r = r0 + tid;
    bool live = false;
    if (r < a.rows)
      live = t == 0 ? (r % a.k == 0) : (__ldcg(a.alive + r) != 0);
    const unsigned bal = __ballot_sync(FULL, live);
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
    if (r < a.rows) {
      int idx = -1;
      if (live) {
        idx = base + sm.wcount[warp] + __popc(bal & ((1u << lane) - 1u));
        sm.list[idx] = r;
        if (t == 0) {
          sm.xptr[idx] = a.feed ? a.feats + (size_t)r * a.E
                                : a.emb + (size_t)a.start * a.E;
          sm.hsrc[idx] = -1;
        } else {
          sm.xptr[idx] = a.emb + (size_t)__ldcg(a.word + r) * a.E;
          sm.hsrc[idx] = (r / a.k) * a.k + __ldcg(a.prev + r);
        }
      }
      sm.rmap[r] = idx;
    }
    base += sm.wcount[GB_WARPS];
    __syncthreads();
  }
  return base;
}

// The thread's place in a stage: column quad q of each slab (of gate g,
// quad jq of the gate's columns, in a gate stage) for rows lane and lane +
// lanes of each unit; it also copies k rows lane + lanes j of the slab's
// weights and float4s tid % 8 and tid % 8 + 8 of input rows tid / 8 + 64 j.
struct Geo {
  int cw, br, QN, q, lane, lanes, g, jq;  // cw, br: the stage's, in registers
};

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
// a time (an input width that is not a multiple of 4).
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
  const Job& J = job_of(S, ic.x.slab.x);
  const float* W = phase ? J.W2 : J.W;
  ic.phase = phase;
  ic.K = phase ? J.K2 : J.K;
  ic.amode = phase ? J.amode2 : J.amode;
  ic.ldw = J.ldw;
  const int seg = J.gates ? t.g : ic.x.slab.y;
  ic.w = 4 * t.jq < ic.x.slab.w ? W + seg * J.wseg + ic.x.slab.z + 4 * t.jq
                                : nullptr;
  ic.sets = (J.gates && ic.amode == A_DENSE) ? 4 : 1;
  ic.na = -1;
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
  const Job& J = job_of(S, ic.x.slab.x);
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
// second row), and where its input rows sit in a slot, by phase.
struct CompCur {
  int u, ch, K0, K1, aoff0, aoff1;
  bool act, two;
  Unit x;
};

__device__ __forceinline__ void enter_unit(CompCur& cc, const Stage& S,
                                           const Geo& t) {
  const Job& J = job_of(S, cc.x.slab.x);
  cc.K0 = J.K;
  cc.K1 = J.K2;
  cc.act = 4 * t.jq < cc.x.slab.w && t.lane < cc.x.nr;
  cc.two = t.lane + t.lanes < cc.x.nr;
  const int set0 = (J.gates && J.amode == A_DENSE) ? t.g : 0;
  const int set1 = (J.gates && J.amode2 == A_DENSE) ? t.g : 0;
  cc.aoff0 = (set0 * t.br + t.lane) * KCP;
  cc.aoff1 = (set1 * t.br + t.lane) * KCP;
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
// chunk may be short).
__device__ __forceinline__ void compute(const float* slot, int cw, int kn,
                                        int q, int aoff, int astep, bool two,
                                        float (&acc)[2][4]) {
  const float* ws = slot + 4 * q;
  const float* a0 = slot + KC * cw + aoff;
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

// After a unit's last chunk: bias adds into the job's output, or the gate
// pre-activations of four gates through shared memory and then the cell.
// Every thread of the block calls it for every unit (a gate epilogue holds
// a barrier).
__device__ void epilogue(const GridArgs& a, const Stage& S, const Smem& sm,
                         const StepCtx& c, const Geo& t, const Unit& x,
                         const float (&acc)[2][4],
                         const float (&acc0)[2][4]) {
  const Job& J = job_of(S, x.slab.x);
  const bool quad = 4 * t.jq < x.slab.w;
  if (J.epi == E_BIAS) {
    if (!quad) return;
    const int col = x.slab.y * J.segw + x.slab.z + 4 * t.jq;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = t.lane + m * t.lanes;
      if (row < x.nr) {
        float* o = J.out + (size_t)(x.i0 + row) * J.ldo + col;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = acc[m][j] + __ldg(J.bias + col + j);
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
          else  // ((x W_ih + b_ih) + h W_hh) + b_hh
            z = ((acc0[m][j] + __ldg(J.bias + o + j)) + acc[m][j]) +
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
  const int n_rb = (n + S.br - 1) / S.br, n_units = S.n_slabs * n_rb;
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
      if (ic.ch == 0) ic.x = unit_of(S, ic.u, n, n_rb);
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
      cc.x = unit_of(S, cc.u, n, n_rb);
      enter_unit(cc, S, t);
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
    }
    if (cc.act) {
      const int k0 = (ph ? cc.ch - cc.x.nch0 : cc.ch) * KC;
      compute(sm.ring + (it % NSLOT) * SLOT_FLOATS, t.cw,
              min(KC, (ph ? cc.K1 : cc.K0) - k0), t.q,
              ph ? cc.aoff1 : cc.aoff0, t.lanes * KCP, cc.two, acc);
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
// live rows' merge_row, then beam_common.cuh's selection, sequence
// extension and best-completed tracking, over the image's k slots, with
// the image's state staged in shared memory.
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

__global__ void __launch_bounds__(GB_THREADS, 1)
grid_beam_kernel(const __grid_constant__ GridArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Stage stages[MAX_STAGES];  // read every chunk: kept on chip
  const Smem sm = carve_smem(smem);
  const int tid = threadIdx.x, k = a.k, L = a.max_seq + 2;
  if (tid < a.n_stages) stages[tid] = a.st[tid];
  __syncthreads();

  // each image's state, by the block that owns it: sequences [<start>,
  // <end>, ...], every slot alive with score 0, the [<end>] fallback
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

  unsigned gen = 0;
  const size_t plane = (size_t)a.rows * a.H;
  for (int t = 0; t <= a.max_seq; ++t) {
    StepCtx c;
    c.t = t;
    c.par = t & 1;
    c.hn_cur = a.hn + c.par * plane;
    c.cn_cur = a.cn + c.par * plane;
    c.hn_prev = a.hn + (c.par ^ 1) * plane;
    c.cn_prev = a.cn + (c.par ^ 1) * plane;
    c.n = scan_rows(a, sm, t);
    if (c.n == 0) break;  // the same count in every block
    for (int s = 0; s < a.n_stages; ++s) {
      run_stage(a, stages[s], sm, c);
      grid_sync(a.bar, gen);
    }
    run_partials(a, sm, c.n);
    grid_sync(a.bar, gen);
    run_tail(a, sm, c);
    grid_sync(a.bar, gen);
  }
}

}  // namespace icee

using namespace icee;

static Job bias_job(const float* W, long long wseg, int ldw, int K, int nseg,
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

// Checks the plan's numbers against what the kernel holds; the slab table
// (device memory) is the wrapper's.
static cudaError_t check_plan(const GridPlan& p, const GridArgs& a) {
  if (p.k < 1 || p.k > KMAX || p.n_img < 1 || p.n_img * p.k > MAX_ROWS ||
      p.E < 1 || p.H < 4 || p.H % 4 || p.F % 4 || p.V < p.k || p.V % 4 ||
      p.max_seq < 0 || p.grid < 1 || p.n_stages < 1 ||
      p.n_stages > MAX_STAGES || p.n_tiles != (p.V + VT - 1) / VT ||
      p.Vp != p.n_tiles * VT || (p.feed && a.feats == nullptr))
    return cudaErrorInvalidValue;
  if (tail_floats((int)p.n_tiles, (int)p.k, (int)p.max_seq + 2) >
      RING_FLOATS)
    return cudaErrorInvalidValue;
  for (int s = 0; s < p.n_stages; ++s) {
    const Stage& S = a.st[s];
    const int cw = S.cw, br = S.br;
    if ((cw != 16 && cw != 32 && cw != 64) || br < 1 || br > MAX_BR ||
        br > 2 * (GB_THREADS / (cw / 4)) || S.n_slabs < 1)
      return cudaErrorInvalidValue;
    for (int j = 0; j < S.n_jobs; ++j) {
      const Job& J = S.job[j];
      const int sets = (J.gates && J.amode == A_DENSE) ? 4 : 1;
      if (KC * cw + sets * br * KCP > SLOT_FLOATS ||
          sets * br > MAX_UNIT_ROWS)
        return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

static int launch(const GridPlan& p, const int* slabs, const float* feats,
                  const float* emb, Stage* st, float* fs, int* is, int* tok,
                  int* len, float* score, void* stream) {
  GridArgs a = {};
  const int n_stages = (int)p.n_stages;
  for (int s = 0; s < n_stages && s < MAX_STAGES; ++s) {
    a.st[s] = st[s];
    a.st[s].cw = (int)p.cw[s];
    a.st[s].br = (int)p.br[s];
    a.st[s].n_slabs = (int)p.n_slabs[s];
    a.st[s].slabs = reinterpret_cast<const int4*>(slabs) + p.slab0[s];
  }
  a.feats = p.feed ? feats : nullptr;
  a.emb = emb;
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
  a.n_stages = n_stages;
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
  a.feed = (int)p.feed;
  a.xvec = p.E % 4 == 0;
  cudaError_t e = check_plan(p, a);
  if (e != cudaSuccess) return e;
  const size_t smem = grid_smem_bytes();
  e = cudaFuncSetAttribute(grid_beam_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(grid_beam_kernel),
                                  dim3((unsigned)p.grid), dim3(GB_THREADS),
                                  args, smem,
                                  static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernel's dynamic shared memory (bytes) and its geometry, for the
// wrapper's plan: {smem, threads, KC, KCP, NSLOT, SLOT_FLOATS, MAX_ROWS}.
extern "C" void icee_mega_beam_consts(long long* out) {
  out[0] = (long long)grid_smem_bytes();
  out[1] = GB_THREADS;
  out[2] = KC;
  out[3] = KCP;
  out[4] = NSLOT;
  out[5] = SLOT_FLOATS;
  out[6] = MAX_ROWS;
}

// Blocks of one cooperative launch on the current device: co-resident
// blocks per SM times the SMs.
extern "C" int icee_mega_beam_max_grid(int* out) {
  int dev = 0, sms = 0, per = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(grid_beam_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)grid_smem_bytes());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, grid_beam_kernel, GB_THREADS, grid_smem_bytes());
  if (e == cudaSuccess && per < 1) e = cudaErrorInvalidConfiguration;
  *out = per * sms;
  return e;
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
  Stage st[4] = {};
  st[0].n_jobs = 2;
  st[0].job[0] = bias_job(Vw, 0, 4 * F, E, 1, 4 * F, A_X, nullptr, 0, 0, Vb,
                          v, 4 * F);
  st[0].job[1] = bias_job(Ww, 0, 4 * H, H, 1, 4 * H, A_HPREV, nullptr, 0, 0,
                          Wb, hw, 4 * H);
  st[1].n_jobs = 1;
  st[1].job[0] = bias_job(Sw, (long long)F * F, F, F, 4, F, A_DENSE, v, 4 * F,
                          F, Sb, s, 4 * F);
  st[2].n_jobs = 1;
  Job z = bias_job(Uw, (long long)F * H, H, F, 4, H, A_DENSE, s, 4 * F, F, Ub,
                   nullptr, 0);
  z.gates = 1;
  z.epi = E_GATES_F;
  z.hw = hw;
  st[2].job[0] = z;
  st[3].n_jobs = 1;
  st[3].job[0] = bias_job(Cw, 0, V, H, 1, V, A_HCUR, nullptr, 0, 0, Cb,
                          fs + p.o_logits, (int)p.Vp);
  return launch(p, slabs, feats, emb, st, fs, is, tok, len, score, stream);
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
  Stage st[2] = {};
  st[0].n_jobs = 1;
  Job g = bias_job(Wih, H, 4 * H, E, 4, H, A_X, nullptr, 0, 0, bih, nullptr,
                   0);
  g.gates = 1;
  g.epi = E_GATES_L;
  g.W2 = Whh;
  g.K2 = H;
  g.amode2 = A_HPREV;
  g.bias2 = bhh;
  st[0].job[0] = g;
  st[1].n_jobs = 1;
  st[1].job[0] = bias_job(Cw, 0, V, H, 1, V, A_HCUR, nullptr, 0, 0, Cb,
                          fs + p.o_logits, (int)p.Vp);
  return launch(p, slabs, feats, emb, st, fs, is, tok, len, score, stream);
}
