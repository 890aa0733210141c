// The beam search's per-block state and per-step tail, shared by the two
// whole-search kernels: beam.cu (K2, global-feature decoders) and
// att_beam.cu (K7, attention decoders).
//
// The tail is everything after the cell in one step (the counterpart of
// icee_tpu/ops/pallas_att_decode.py::_head_select_embed_phase and
// pallas_beam.py::_beam_select): the vocab head over tiles, the per-tile
// reduction and merge into each row's top-k log-probs (decode_common.cuh),
// the beam selection over the k x k candidates, the parent-state gather,
// the sequence extension, the next-token embedding gather, best-completed
// tracking and the "no beam alive" flag.  Semantics are those of
// decode/beam.py::beam_search_batched: the step-1 single-row special case,
// rank < n_alive candidate validity, candidate order p*k + q over the k x k
// merge, strict-> best-completed tracking with the list-order tie-break,
// length = t + 2, the [<end>] fallback (length 1, score -1e30).
#pragma once

#include "decode_common.cuh"

namespace icee {

constexpr int BEAM_ROWS = 8;       // most rows (images x k) one block holds
constexpr int MEGA_THREADS = 512;

// Sizes of one block's shared-memory planes for R rows: the step input
// (width xw, e.g. E, or E + FS with an attention context), beam h and c,
// the cell's two scratch planes (which also hold the logits tiles and this
// step's h', c'), the head's partials, and the search state.  `extra`
// floats follow the integer planes, 16-byte aligned, for a caller's own
// planes.
struct Layout {
  int R, xw, Hp, ld, L, n_tiles, npar;
  size_t floats, ints, extra_off, total;
};

// cw: the width of the cell's scratch planes (cell_width)
__host__ __device__ inline Layout beam_layout(int R, int xw, int cw, int H,
                                              int V, int k, int max_seq,
                                              size_t extra) {
  Layout l;
  l.R = R;
  l.xw = round4(xw);
  l.Hp = round4(H);
  // the scratch planes also hold the logits tiles: at least one tile wide
  l.ld = (cw + VT - 1) / VT * VT;
  l.L = max_seq + 2;
  l.n_tiles = (V + VT - 1) / VT;
  // logits tiles computed at once (>= 1): they live in the s1 plane
  l.npar = l.ld / VT < MEGA_THREADS / QT ? l.ld / VT : MEGA_THREADS / QT;
  const size_t r = R;
  l.floats = r * l.xw + 2 * r * l.Hp + 2 * r * l.ld + 2 * r * l.n_tiles +
             r * l.n_tiles * k + r * k + 3 * r;
  l.ints = r * l.n_tiles * k + r * k + 2 * r * l.L + 3 * r + 1;
  l.extra_off = (l.floats + l.ints + 3) & ~size_t(3);
  l.total = l.extra_off + extra;
  return l;
}

__host__ __device__ inline size_t layout_bytes(const Layout& l) {
  return sizeof(float) * l.total;  // ints are 4 bytes too
}

struct Planes {
  float* xs;      // (R, xw) step input
  float* hs;      // (R, Hp) beam h
  float* cs;      // (R, Hp) beam c
  float* s1;      // (R, ld) cell scratch; logits tiles
  float* s2;      // (R, ld) cell scratch; h', c'
  float* hn;      // (R, Hp) h' of this step, pre-gather (in s2)
  float* cn;      // (R, Hp) c'
  float* lt;      // (npar, R, VT) logits tiles (in s1)
  float* pm;      // (R, n_tiles) tile max
  float* pse;     // (R, n_tiles) tile sum-exp
  float* pv;      // (R, n_tiles, k) tile top-k values
  float* lp;      // (R, k) step log-probs
  float* scores;  // (R,) beam scores
  float* top;     // (R,) selected candidate scores
  float* bscore;  // (R,) best completed score, per image
  int* pi;        // (R, n_tiles, k) tile top-k ids
  int* li;        // (R, k) step ids
  int* seqs;      // (2, R, L) double-buffered sequences
  int* alive;     // (R,)
  int* prev;      // (R,) parent slot of each candidate
  int* words;     // (R,) selected next words
  int* done;      // (1,)
  float* extra;   // the caller's planes
};

__device__ inline Planes carve(float* smem, const Layout& l, int k) {
  const int R = l.R;
  Planes s;
  s.xs = smem;
  s.hs = s.xs + R * l.xw;
  s.cs = s.hs + R * l.Hp;
  s.s1 = s.cs + R * l.Hp;
  s.s2 = s.s1 + R * l.ld;
  s.hn = s.s2;
  s.cn = s.s2 + R * l.Hp;
  s.lt = s.s1;
  s.pm = s.s2 + R * l.ld;
  s.pse = s.pm + R * l.n_tiles;
  s.pv = s.pse + R * l.n_tiles;
  s.lp = s.pv + R * l.n_tiles * k;
  s.scores = s.lp + R * k;
  s.top = s.scores + R;
  s.bscore = s.top + R;
  s.pi = reinterpret_cast<int*>(s.bscore + R);
  s.li = s.pi + R * l.n_tiles * k;
  s.seqs = s.li + R * k;
  s.alive = s.seqs + 2 * R * l.L;
  s.prev = s.alive + R;
  s.words = s.prev + R;
  s.done = s.words + R;
  s.extra = smem + l.extra_off;
  return s;
}

// What the search writes for the images of one block.
struct BeamOut {
  int* tok;      // (images, L)
  int* len;      // (images,)
  float* score;  // (images,)
};

// Sequences start as [<start>, <end>, ...], every slot alive with score 0,
// and each image's result the [<end>] fallback.  No barrier.
__device__ inline void beam_init(const Planes& s, const Layout& l, int rows,
                                 int n_img, int img0, int start, int end,
                                 const BeamOut& o) {
  const int tid = threadIdx.x, nt = blockDim.x, L = l.L;
  for (int i = tid; i < rows * L; i += nt) s.seqs[i] = (i % L == 0) ? start : end;
  for (int i = tid; i < n_img * L; i += nt) o.tok[(size_t)img0 * L + i] = end;
  if (tid < rows) {
    s.scores[tid] = 0.f;
    s.alive[tid] = 1;
  }
  if (tid < n_img) {
    s.bscore[tid] = NEG;
    o.len[img0 + tid] = 1;  // the [<end>] fallback
    o.score[img0 + tid] = NEG;
  }
}

// One step's tail after the cell has left h', c' in (s.hn, s.cn): head,
// top-k, beam selection, parent gather, sequence extension, the next input
// emb[word] into s.xs[:, :E], best-completed tracking.  Returns true once
// no beam of the block is alive.  All threads of the block must call it;
// it ends with a barrier.
template <int MAXR>
__device__ bool beam_tail(const Planes& s, const Layout& l, int rows,
                          int n_img, int k, int t, int& cur,
                          const float* __restrict__ Cw,
                          const float* __restrict__ Cb, int H, int V,
                          const float* __restrict__ emb, int E, int end,
                          int img0, const BeamOut& o) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, n_warps = nt >> 5;
  const int R = l.R, Hp = l.Hp, L = l.L, n_tiles = l.n_tiles;
  const bool first = (t == 0);

  // head over vocab tiles, npar tiles at a time, reduced to partials
  for (int tb = 0; tb < n_tiles; tb += l.npar) {
    for (int q = tid; q < l.npar * QT; q += nt) {
      const int tl = q / QT, tile = tb + tl, c4 = 4 * (q % QT);
      if (tile < n_tiles)
        head_quad<MAXR>(s.hn, Hp, rows, Cw, Cb, H, V, tile * VT + c4,
                        s.lt + tl * R * VT + c4, VT);
    }
    __syncthreads();
    for (int task = warp; task < l.npar * rows; task += n_warps) {
      const int tl = task / rows, r = task % rows, tile = tb + tl;
      if (tile < n_tiles) {
        const int p = r * n_tiles + tile;
        tile_reduce(s.lt + (tl * R + r) * VT, tile * VT, k, s.pm + p,
                    s.pse + p, s.pv + p * k, s.pi + p * k);
      }
    }
    __syncthreads();
  }
  for (int r = warp; r < rows; r += n_warps)
    merge_row(s.pm + r * n_tiles, s.pse + r * n_tiles, s.pv + r * n_tiles * k,
              s.pi + r * n_tiles * k, n_tiles, k, s.lp + r * k, s.li + r * k);
  __syncthreads();

  // beam select: exact top-k of the k*k candidates p*k + q, ties to the
  // lowest candidate index (lax.top_k over the flattened (k, k) totals)
  if (tid < n_img) {
    const int base = tid * k;
    unsigned long long taken = 0ull;
    for (int q = 0; q < k; ++q) {
      float bv = -INFINITY;
      int bc = 0;
      for (int cand = 0; cand < k * k; ++cand) {
        if (taken & (1ull << cand)) continue;
        const int p = cand / k;
        const bool ok = first ? (p == 0) : (s.alive[base + p] != 0);
        const float v =
            ok ? s.scores[base + p] + s.lp[(base + p) * k + cand % k] : NEG;
        if (v > bv) {
          bv = v;
          bc = cand;
        }
      }
      taken |= 1ull << bc;
      s.top[base + q] = bv;
      s.prev[base + q] = bc / k;
      s.words[base + q] = s.li[(base + bc / k) * k + bc % k];
    }
  }
  __syncthreads();

  // gather the parent state, extend the sequences, embed the next words
  const int nxt = cur ^ 1;
  int* sc = s.seqs + cur * R * L;
  int* sn = s.seqs + nxt * R * L;
  for (int i = tid; i < rows * H; i += nt) {
    const int r = i / H, j = i % H;
    const int src = (r / k) * k + s.prev[r];
    s.hs[r * Hp + j] = s.hn[src * Hp + j];
    s.cs[r * Hp + j] = s.cn[src * Hp + j];
  }
  for (int i = tid; i < rows * L; i += nt) {
    const int r = i / L, pos = i % L;
    const int src = (r / k) * k + s.prev[r];
    sn[i] = (pos == t + 1) ? s.words[r] : sc[src * L + pos];
  }
  for (int i = tid; i < rows * E; i += nt) {
    const int r = i / E, e = i % E;
    s.xs[r * l.xw + e] = emb[(size_t)s.words[r] * E + e];
  }
  __syncthreads();

  // best-completed tracking (strict >, first rank among equals), then
  // the surviving beams become the next step's live slots
  if (tid < n_img) {
    const int base = tid * k;
    int n_take = k;
    if (!first) {
      n_take = 0;
      for (int p = 0; p < k; ++p) n_take += s.alive[base + p];
    }
    float best = NEG;
    int ib = 0;
    for (int q = 0; q < k; ++q) {
      const bool completed = q < n_take && s.words[base + q] == end;
      const float cv = completed ? s.top[base + q] : NEG;
      if (q == 0 || cv > best) {
        best = cv;
        ib = q;
      }
    }
    if (best > s.bscore[tid]) {
      const size_t img = (size_t)(img0 + tid);
      s.bscore[tid] = best;
      o.score[img] = best;
      o.len[img] = t + 2;
      for (int pos = 0; pos < L; ++pos)
        o.tok[img * L + pos] = sn[(base + ib) * L + pos];
    }
    for (int q = 0; q < k; ++q) {
      const bool still = q < n_take && s.words[base + q] != end;
      s.alive[base + q] = still ? 1 : 0;
      s.scores[base + q] = still ? s.top[base + q] : NEG;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    for (int r = 0; r < rows; ++r) any |= s.alive[r];
    *s.done = !any;
  }
  __syncthreads();
  cur = nxt;
  return *s.done != 0;
}

}  // namespace icee
