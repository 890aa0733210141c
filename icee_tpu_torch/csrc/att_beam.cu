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
// spatial feature (init_state), step 1 embeds <start> (the image enters
// only through h0/c0 and the attention context), each step re-attends with
// the current h, and the search tail is K2's (beam_common.cuh).
//
// What bounds it on the H100: by the roofline, operations (~28 MFLOP per
// row-step for the factored cell, ~24 for the LSTM cell).  In this design
// each block streams every weight (~54 MB for the factored cell with
// V_w of 2348 x 2048, ~45 MB for the LSTM cell) plus its image's 2 MB of
// att1 and features once per step for its 5 rows; 64 blocks' weights and
// features exceed the 50 MB L2 that held K2's ~32 MB, so what limits it is
// the rate at which the SMs pull those bytes.  Making it fast (wgmma, TMA,
// several images per block sharing weight tiles) is later work.
//
// Design: K2's, extended.  One block per image (k <= 8 rows), persistent
// over all max_seq_length + 1 steps, leaving its loop once no beam is
// alive.  Per step: att_common.cuh attend_rows writes gate * ctx into the
// step input's columns [E, E + FS), the cell (decode_common.cuh, input width
// E + FS) leaves h', c', and beam_tail runs the head, top-k, selection,
// gather, tracking and the emb[word] gather into columns [0, E).  The
// attention, cell, head, reduction and merge are the device functions K6
// runs, so the serial (K6) and batched (K7) paths give the same bits.
#include "att_common.cuh"
#include "beam_common.cuh"

namespace icee {

template <class W>
struct AttMegaArgs {
  const float* feats;  // (n_img, P, FS)
  const float* att1;   // (n_img, P, A)
  const float* emb;    // (V, E)
  W w;                 // cell weights, input width E + FS
  AttWeights aw;
  InitWeights iw;
  const float* Cw;     // (H, V)
  const float* Cb;     // (V,)
  BeamOut out;         // (n_img, ...) results
  int* steps;          // (n_img,) steps each block ran
  int E, V, k, max_seq, start, end;
};

// The beam planes for one image's k rows, then attend_rows' scratch and the
// mean feature of init_state.
template <class W>
__host__ __device__ inline Layout att_layout(const W& w, const AttWeights& a,
                                             int V, int k, int max_seq) {
  return beam_layout(k, w.E, cell_width(w), w.H, V, k, max_seq,
                     att_scratch(a, k) + round4(a.FS));
}

template <class W>
__global__ void __launch_bounds__(MEGA_THREADS)
mega_att_kernel(AttMegaArgs<W> a) {
  extern __shared__ __align__(16) float smem[];
  const W& w = a.w;
  const AttWeights& aw = a.aw;
  const int E = a.E, H = w.H, k = a.k, P = aw.P, FS = aw.FS;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout l = att_layout(w, aw, a.V, k, a.max_seq);
  const Planes s = carve(smem, l, k);
  float* scratch = s.extra;                      // attend_rows' planes
  float* mean = scratch + att_scratch(aw, k);    // (FS,)
  const int rows = k, img = blockIdx.x;
  const float* feat = a.feats + (size_t)img * P * FS;
  const float* att1 = a.att1 + (size_t)img * P * aw.A;

  // h0, c0 from the mean spatial feature into slot 0, then every slot
  init_state(feat, P, FS, a.iw, H, mean, s.hs, s.cs);
  for (int i = tid; i < (rows - 1) * l.Hp; i += nt) {
    s.hs[l.Hp + i] = s.hs[i % l.Hp];
    s.cs[l.Hp + i] = s.cs[i % l.Hp];
  }
  // research semantics: step 1 embeds <start>
  for (int i = tid; i < rows * l.xw; i += nt) {
    const int r = i / l.xw, e = i % l.xw;
    s.xs[r * l.xw + e] = e < E ? a.emb[(size_t)a.start * E + e] : 0.f;
  }
  beam_init(s, l, rows, 1, img, a.start, a.end, a.out);
  __syncthreads();

  int cur = 0, steps = 0;
  for (int t = 0; t <= a.max_seq; ++t) {
    // x[:, E:] = gate * ctx from the beams' h; ends with a barrier
    attend_rows<ATT_ROWS>(s.hs, l.Hp, rows, aw, feat, att1, scratch,
                          s.xs + E, l.xw, nullptr);
    // cell: (xs, hs, cs) -> (hn, cn); ends with a barrier
    cell_step<ATT_ROWS>(s.xs, l.xw, s.hs, l.Hp, s.cs, l.Hp, w, s.s1, s.s2,
                        l.ld, rows, s.hn, l.Hp, s.cn, l.Hp);
    ++steps;
    if (beam_tail<ATT_ROWS>(s, l, rows, 1, k, t, cur, a.Cw, a.Cb, H, a.V,
                            a.emb, E, a.end, img, a.out))
      break;
  }
  if (tid == 0) a.steps[img] = steps;
}

}  // namespace icee

using namespace icee;

template <class W>
static int launch(const AttMegaArgs<W>& a, int n_img, void* stream) {
  const AttWeights& aw = a.aw;
  if (n_img <= 0 || a.k < 1 || a.k > ATT_ROWS || aw.A % 4 ||
      aw.FS % 4 || aw.H % 4 || a.V % 4 || a.w.E != a.E + aw.FS)
    return cudaErrorInvalidValue;
  const size_t smem = layout_bytes(att_layout(a.w, aw, a.V, a.k, a.max_seq));
  cudaError_t e = cudaFuncSetAttribute(
      mega_att_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  mega_att_kernel<W><<<n_img, MEGA_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory one block needs (bytes), for the wrapper's checks; the
// LSTM cell's planes are those of F = H.
extern "C" long long icee_mega_att_beam_smem(int E, int F, int H, int V,
                                             int k, int max_seq, int A, int P,
                                             int FS) {
  const AttWeights aw{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      H, A, P, FS};
  return (long long)layout_bytes(beam_layout(
      k, E + FS, cell_ld(F, H), H, V, k, max_seq,
      att_scratch(aw, k) + round4(FS)));
}

// feats (n_img, P, FS), att1 (n_img, P, A), emb (V, E); V_w has E + FS
// rows; outputs tok (n_img, max_seq + 2), len, score (n_img,), steps
// (n_img,).
extern "C" int icee_mega_att_beam_decode(
    const float* feats, const float* att1, const float* emb,
    const float* decw, const float* decb, const float* fullw,
    const float* fullb, const float* fbw, const float* fbb, const float* ihw,
    const float* ihb, const float* icw, const float* icb, const float* Vw,
    const float* Vb, const float* Sw, const float* Sb, const float* Uw,
    const float* Ub, const float* Ww, const float* Wb, const float* Cw,
    const float* Cb, int* tok, int* len, float* score, int* steps, int n_img,
    int k, int E, int F, int H, int V, int A, int P, int FS, int max_seq,
    int start, int end, void* stream) {
  if (F % 4) return cudaErrorInvalidValue;
  const AttMegaArgs<CellWeights> a{
      feats, att1, emb,
      CellWeights{Vw, Vb, Sw, Sb, Uw, Ub, Ww, Wb, E + FS, F, H},
      AttWeights{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS},
      InitWeights{ihw, ihb, icw, icb}, Cw, Cb, BeamOut{tok, len, score},
      steps, E, V, k, max_seq, start, end};
  return launch(a, n_img, stream);
}

extern "C" int icee_mega_att_beam_decode_lstm(
    const float* feats, const float* att1, const float* emb,
    const float* decw, const float* decb, const float* fullw,
    const float* fullb, const float* fbw, const float* fbb, const float* ihw,
    const float* ihb, const float* icw, const float* icb, const float* Wih,
    const float* bih, const float* Whh, const float* bhh, const float* Cw,
    const float* Cb, int* tok, int* len, float* score, int* steps, int n_img,
    int k, int E, int H, int V, int A, int P, int FS, int max_seq, int start,
    int end, void* stream) {
  const AttMegaArgs<LstmWeights> a{
      feats, att1, emb, LstmWeights{Wih, bih, Whh, bhh, E + FS, H},
      AttWeights{decw, decb, fullw, fullb, fbw, fbb, H, A, P, FS},
      InitWeights{ihw, ihb, icw, icb}, Cw, Cb, BeamOut{tok, len, score},
      steps, E, V, k, max_seq, start, end};
  return launch(a, n_img, stream);
}
