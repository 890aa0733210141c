// K2: the whole k-beam search in one launch, for the StyleNet FactoredLSTM
// or the NIC decoder's torch LSTM cell.
//
// Replaces icee_tpu/ops/pallas_beam.py::mega_beam_decode (the TPU kernel
// _kernel at :54 with _beam_select at :244), cell="factored" (:110-128)
// and cell="lstm" (:129-143).  The kernel is a template over the weight
// set (CellWeights or LstmWeights, decode_common.cuh); only the cell step
// differs, so the head, tile reduction, merge, beam selection, parent
// gather, best-completed tracking and embedding gather are one copy.
// Semantics are those of decode/beam.py::beam_search_batched: the step-1
// single-row special case, rank < n_alive candidate validity, candidate
// order p*k + q over the k x k merge, strict-> best-completed tracking with
// the list-order tie-break, length = t + 2, the [<end>] fallback (length 1, score -1e30),
// and both feed_feature modes (serving: the image feature is the step-1
// input; research: <start>'s embedding is).  Weights are float32, so the
// TPU kernel's rounding of h and c through the weight dtype is the identity.
//
// What bounds it on the H100: by the roofline, operations (every step runs
// the cell and the full vocabulary head for every row: 5.1 GFLOP per step
// at 64 images x 5 beams, V = 8192, for the factored cell and 3.7 GFLOP for
// the LSTM cell, against ~32 MB of weights that stay in the 50 MB L2).  In
// this design each block streams all the weights from L2 once per step for
// its few rows, so what limits it is the rate at which one SM can pull
// bytes from L2; the matmuls keep 128 bytes in flight per thread
// (decode_common.cuh dot4) to get close to that rate.
//
// Design: one block per group of n_img images (n_img * k <= 8 rows),
// persistent over all max_seq_length + 1 steps.  Per-beam x, h, c, the
// sequences, scores and alive flags live in shared memory; weights are read
// from L2 every step.  The cell, head, tile reduction and merge are the
// device functions K1 uses (decode_common.cuh), so both paths score beams
// bit-identically.  Beam selection, the parent-state gather and
// best-completed tracking run in the block; the next input is gathered as
// row emb[word] (exact, where the TPU kernel needed a one-hot matmul); the
// block leaves its step loop once none of its beams is alive.
#include "decode_common.cuh"

namespace icee {

constexpr int BEAM_ROWS = 8;
constexpr int MEGA_THREADS = 512;

template <class W>
struct MegaArgs {
  const float* feats;  // (n_blocks * n_img * k, E) or null (research mode)
  const float* emb;    // (V, E)
  W w;                 // CellWeights or LstmWeights
  const float* Cw;     // (H, V)
  const float* Cb;     // (V,)
  int* tok;            // (n_blocks * n_img, max_len)
  int* len;            // (n_blocks * n_img,)
  float* score;        // (n_blocks * n_img,)
  int* steps;          // (n_blocks,) steps each block ran
  int V, k, n_img, max_seq, start, end, feed;
};

struct Layout {
  int Ep, Hp, ld, L, n_tiles, npar;
  size_t floats, ints;
};

// cw: the width of the cell's scratch planes (cell_width)
__host__ __device__ inline Layout layout(int E, int cw, int H, int V, int k,
                                         int max_seq) {
  Layout l;
  l.Ep = round4(E);
  l.Hp = round4(H);
  // the scratch planes also hold the logits tiles: at least one tile wide
  l.ld = (cw + VT - 1) / VT * VT;
  l.L = max_seq + 2;
  l.n_tiles = (V + VT - 1) / VT;
  // logits tiles computed at once (>= 1): they live in the s1 plane
  l.npar = l.ld / VT < MEGA_THREADS / QT ? l.ld / VT : MEGA_THREADS / QT;
  const size_t R = BEAM_ROWS;
  l.floats = R * l.Ep + 2 * R * l.Hp + 2 * R * l.ld + 2 * R * l.n_tiles +
             R * l.n_tiles * k + R * k + 3 * R;
  l.ints = R * l.n_tiles * k + R * k + 2 * R * l.L + 3 * R + 1;
  return l;
}

template <class W>
__global__ void __launch_bounds__(MEGA_THREADS)
mega_beam_kernel(MegaArgs<W> a) {
  extern __shared__ __align__(16) float smem[];
  const W& w = a.w;
  const int E = w.E, H = w.H, k = a.k, n_img = a.n_img;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, n_warps = nt >> 5;
  const Layout l = layout(E, cell_width(w), H, a.V, k, a.max_seq);
  const int Ep = l.Ep, Hp = l.Hp, L = l.L, n_tiles = l.n_tiles;
  const int R = BEAM_ROWS;

  float* xs = smem;               // (R, Ep) step input
  float* hs = xs + R * Ep;        // (R, Hp) beam h
  float* cs = hs + R * Hp;        // (R, Hp) beam c
  float* s1 = cs + R * Hp;        // (R, ld) cell scratch; logits tiles
  float* s2 = s1 + R * l.ld;      // (R, ld) cell scratch; h', c'
  float* hn = s2;                 // (R, Hp) h' of this step, pre-gather
  float* cn = s2 + R * Hp;        // (R, Hp) c'
  float* lt = s1;                 // (npar, R, VT) logits tiles
  float* pm = s2 + R * l.ld;          // (R, n_tiles) tile max
  float* pse = pm + R * n_tiles;      // (R, n_tiles) tile sum-exp
  float* pv = pse + R * n_tiles;      // (R, n_tiles, k) tile top-k values
  float* lp = pv + R * n_tiles * k;   // (R, k) step log-probs
  float* scores = lp + R * k;         // (R,) beam scores
  float* top = scores + R;            // (R,) selected candidate scores
  float* bscore = top + R;            // (n_img,) best completed score
  int* pi = reinterpret_cast<int*>(bscore + R);  // (R, n_tiles, k) ids
  int* li = pi + R * n_tiles * k;     // (R, k) step ids
  int* seqs = li + R * k;             // (2, R, L) double-buffered sequences
  int* alive = seqs + 2 * R * L;      // (R,)
  int* prev = alive + R;              // (R,) parent slot of each candidate
  int* words = prev + R;              // (R,) selected next words
  int* done = words + R;

  const int rows = n_img * k;
  const int img0 = blockIdx.x * n_img;
  const size_t row0 = (size_t)img0 * k;

  for (int i = tid; i < rows * Ep; i += nt) {
    const int r = i / Ep, e = i % Ep;
    float v = 0.f;
    if (e < E)
      v = a.feed ? a.feats[(row0 + r) * E + e] : a.emb[(size_t)a.start * E + e];
    xs[i] = v;
  }
  for (int i = tid; i < rows * Hp; i += nt) hs[i] = cs[i] = 0.f;
  for (int i = tid; i < rows * L; i += nt) seqs[i] = (i % L == 0) ? a.start : a.end;
  for (int i = tid; i < n_img * L; i += nt) a.tok[(size_t)img0 * L + i] = a.end;
  if (tid < rows) {
    scores[tid] = 0.f;
    alive[tid] = 1;
  }
  if (tid < n_img) {
    bscore[tid] = NEG;
    a.len[img0 + tid] = 1;       // the [<end>] fallback
    a.score[img0 + tid] = NEG;
  }
  __syncthreads();

  int cur = 0, steps = 0;
  for (int t = 0; t <= a.max_seq; ++t) {
    const bool first = (t == 0);
    // cell: (xs, hs, cs) -> (hn, cn); ends with a barrier
    cell_step<BEAM_ROWS>(xs, Ep, hs, Hp, cs, Hp, w, s1, s2, l.ld, rows, hn,
                         Hp, cn, Hp);

    // head over vocab tiles, npar tiles at a time, reduced to partials
    for (int tb = 0; tb < n_tiles; tb += l.npar) {
      for (int q = tid; q < l.npar * QT; q += nt) {
        const int tl = q / QT, tile = tb + tl, c4 = 4 * (q % QT);
        if (tile < n_tiles)
          head_quad<BEAM_ROWS>(hn, Hp, rows, a.Cw, a.Cb, H, a.V,
                               tile * VT + c4, lt + tl * R * VT + c4, VT);
      }
      __syncthreads();
      for (int task = warp; task < l.npar * rows; task += n_warps) {
        const int tl = task / rows, r = task % rows, tile = tb + tl;
        if (tile < n_tiles) {
          const int p = r * n_tiles + tile;
          tile_reduce(lt + (tl * R + r) * VT, tile * VT, k, pm + p, pse + p,
                      pv + p * k, pi + p * k);
        }
      }
      __syncthreads();
    }
    for (int r = warp; r < rows; r += n_warps)
      merge_row(pm + r * n_tiles, pse + r * n_tiles, pv + r * n_tiles * k,
                pi + r * n_tiles * k, n_tiles, k, lp + r * k, li + r * k);
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
          const bool ok = first ? (p == 0) : (alive[base + p] != 0);
          const float v = ok ? scores[base + p] + lp[(base + p) * k + cand % k]
                             : NEG;
          if (v > bv) {
            bv = v;
            bc = cand;
          }
        }
        taken |= 1ull << bc;
        top[base + q] = bv;
        prev[base + q] = bc / k;
        words[base + q] = li[(base + bc / k) * k + bc % k];
      }
    }
    __syncthreads();

    // gather the parent state, extend the sequences, embed the next words
    const int nxt = cur ^ 1;
    int* sc = seqs + cur * R * L;
    int* sn = seqs + nxt * R * L;
    for (int i = tid; i < rows * H; i += nt) {
      const int r = i / H, j = i % H;
      const int src = (r / k) * k + prev[r];
      hs[r * Hp + j] = hn[src * Hp + j];
      cs[r * Hp + j] = cn[src * Hp + j];
    }
    for (int i = tid; i < rows * L; i += nt) {
      const int r = i / L, pos = i % L;
      const int src = (r / k) * k + prev[r];
      sn[i] = (pos == t + 1) ? words[r] : sc[src * L + pos];
    }
    for (int i = tid; i < rows * E; i += nt) {
      const int r = i / E, e = i % E;
      xs[r * Ep + e] = a.emb[(size_t)words[r] * E + e];
    }
    __syncthreads();

    // best-completed tracking (strict >, first rank among equals), then
    // the surviving beams become the next step's live slots
    if (tid < n_img) {
      const int base = tid * k;
      int n_take = k;
      if (!first) {
        n_take = 0;
        for (int p = 0; p < k; ++p) n_take += alive[base + p];
      }
      float best = NEG;
      int ib = 0;
      for (int q = 0; q < k; ++q) {
        const bool completed = q < n_take && words[base + q] == a.end;
        const float cv = completed ? top[base + q] : NEG;
        if (q == 0 || cv > best) {
          best = cv;
          ib = q;
        }
      }
      if (best > bscore[tid]) {
        const size_t o = (size_t)(img0 + tid);
        bscore[tid] = best;
        a.score[o] = best;
        a.len[o] = t + 2;
        for (int pos = 0; pos < L; ++pos) a.tok[o * L + pos] = sn[(base + ib) * L + pos];
      }
      for (int q = 0; q < k; ++q) {
        const bool still = q < n_take && words[base + q] != a.end;
        alive[base + q] = still ? 1 : 0;
        scores[base + q] = still ? top[base + q] : NEG;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int any = 0;
      for (int r = 0; r < rows; ++r) any |= alive[r];
      *done = !any;
    }
    __syncthreads();
    cur = nxt;
    ++steps;
    if (*done) break;
  }
  if (tid == 0) a.steps[blockIdx.x] = steps;
}

}  // namespace icee

using namespace icee;

template <class W>
static int launch(const float* feats, const float* emb, const W& w,
                  const float* Cw, const float* Cb, int* tok, int* len,
                  float* score, int* steps, int n_blocks, int n_img, int k,
                  int V, int max_seq, int start, int end, int feed,
                  void* stream) {
  if (n_blocks <= 0 || k < 1 || k > KMAX || n_img < 1 ||
      n_img * k > BEAM_ROWS || w.H % 4 || V % 4 ||
      (feed && feats == nullptr))
    return cudaErrorInvalidValue;
  const Layout l = layout(w.E, cell_width(w), w.H, V, k, max_seq);
  const size_t smem = sizeof(float) * l.floats + sizeof(int) * l.ints;
  cudaError_t e = cudaFuncSetAttribute(
      mega_beam_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  MegaArgs<W> a{feats, emb, w, Cw, Cb, tok, len, score, steps, V, k, n_img,
                max_seq, start, end, feed};
  mega_beam_kernel<W><<<n_blocks, MEGA_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory one block needs (bytes), for the wrapper's checks; the
// LSTM cell's planes are those of F = H.
extern "C" long long icee_mega_beam_smem(int E, int F, int H, int V, int k,
                                         int max_seq) {
  const Layout l = layout(E, cell_ld(F, H), H, V, k, max_seq);
  return (long long)(sizeof(float) * l.floats + sizeof(int) * l.ints);
}

extern "C" int icee_mega_beam_decode(
    const float* feats, const float* emb, const float* Vw, const float* Vb,
    const float* Sw, const float* Sb, const float* Uw, const float* Ub,
    const float* Ww, const float* Wb, const float* Cw, const float* Cb,
    int* tok, int* len, float* score, int* steps, int n_blocks, int n_img,
    int k, int E, int F, int H, int V, int max_seq, int start, int end,
    int feed, void* stream) {
  if (F % 4) return cudaErrorInvalidValue;
  return launch(feats, emb, CellWeights{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E, F, H},
                Cw, Cb, tok, len, score, steps, n_blocks, n_img, k, V,
                max_seq, start, end, feed, stream);
}

extern "C" int icee_mega_beam_decode_lstm(
    const float* feats, const float* emb, const float* Wih, const float* bih,
    const float* Whh, const float* bhh, const float* Cw, const float* Cb,
    int* tok, int* len, float* score, int* steps, int n_blocks, int n_img,
    int k, int E, int H, int V, int max_seq, int start, int end, int feed,
    void* stream) {
  return launch(feats, emb, LstmWeights{Wih, bih, Whh, bhh, E, H}, Cw, Cb,
                tok, len, score, steps, n_blocks, n_img, k, V, max_seq, start,
                end, feed, stream);
}
