// K2: the whole k-beam search in one launch, for the StyleNet FactoredLSTM
// or the NIC decoder's torch LSTM cell.
//
// Replaces icee_tpu/ops/pallas_beam.py::mega_beam_decode (the TPU kernel
// _kernel at :54 with _beam_select at :244), cell="factored" (:110-128)
// and cell="lstm" (:129-143).  The kernel is a template over the weight
// set (CellWeights or LstmWeights, decode_common.cuh); only the cell step
// differs, so the head, tile reduction, merge, beam selection, parent
// gather, best-completed tracking and embedding gather are one copy: the
// step's tail after the cell, beam_common.cuh's beam_tail, which the
// attention search (K7, att_beam.cu) runs too.  Semantics are those of
// decode/beam.py::beam_search_batched (beam_common.cuh lists them), in both
// feed_feature modes (serving: the image feature is the step-1 input;
// research: <start>'s embedding is).  Weights are float32, so the
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
#include "beam_common.cuh"

namespace icee {

template <class W>
struct MegaArgs {
  const float* feats;  // (n_blocks * n_img * k, E) or null (research mode)
  const float* emb;    // (V, E)
  W w;                 // CellWeights or LstmWeights
  const float* Cw;     // (H, V)
  const float* Cb;     // (V,)
  BeamOut out;         // (n_blocks * n_img, ...) results
  int* steps;          // (n_blocks,) steps each block ran
  int V, k, n_img, max_seq, start, end, feed;
};

template <class W>
__host__ __device__ inline Layout mega_layout(const W& w, int V, int k,
                                              int max_seq) {
  return beam_layout(BEAM_ROWS, w.E, cell_width(w), w.H, V, k, max_seq, 0);
}

template <class W>
__global__ void __launch_bounds__(MEGA_THREADS)
mega_beam_kernel(MegaArgs<W> a) {
  extern __shared__ __align__(16) float smem[];
  const W& w = a.w;
  const int E = w.E, H = w.H, k = a.k, n_img = a.n_img;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout l = mega_layout(w, a.V, k, a.max_seq);
  const Planes s = carve(smem, l, k);
  const int rows = n_img * k;
  const int img0 = blockIdx.x * n_img;
  const size_t row0 = (size_t)img0 * k;

  for (int i = tid; i < rows * l.xw; i += nt) {
    const int r = i / l.xw, e = i % l.xw;
    float v = 0.f;
    if (e < E)
      v = a.feed ? a.feats[(row0 + r) * E + e] : a.emb[(size_t)a.start * E + e];
    s.xs[i] = v;
  }
  for (int i = tid; i < rows * l.Hp; i += nt) s.hs[i] = s.cs[i] = 0.f;
  beam_init(s, l, rows, n_img, img0, a.start, a.end, a.out);
  __syncthreads();

  int cur = 0, steps = 0;
  for (int t = 0; t <= a.max_seq; ++t) {
    // cell: (xs, hs, cs) -> (hn, cn); ends with a barrier
    cell_step<BEAM_ROWS>(s.xs, l.xw, s.hs, l.Hp, s.cs, l.Hp, w, s.s1, s.s2,
                         l.ld, rows, s.hn, l.Hp, s.cn, l.Hp);
    ++steps;
    if (beam_tail<BEAM_ROWS>(s, l, rows, n_img, k, t, cur, a.Cw, a.Cb, H,
                             a.V, a.emb, E, a.end, img0, a.out))
      break;
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
  const size_t smem = layout_bytes(mega_layout(w, V, k, max_seq));
  cudaError_t e = cudaFuncSetAttribute(
      mega_beam_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  MegaArgs<W> a{feats, emb, w, Cw, Cb, BeamOut{tok, len, score}, steps, V,
                k, n_img, max_seq, start, end, feed};
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
  return (long long)layout_bytes(
      beam_layout(BEAM_ROWS, E, cell_ld(F, H), H, V, k, max_seq, 0));
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
