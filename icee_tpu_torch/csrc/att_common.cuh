// Device functions of the attention decoders (StyleNet+Att, NIC+Att),
// shared by K6 (att_decode_step.cu, one beam step) and K7 (att_beam.cu,
// the whole beam search).
//
// The re-attention of icee_tpu/ops/pallas_att_decode.py::_attend_block
// (:46) for the beam rows of one image:
//   att2  = h dec_w + dec_b                                  (rows, A)
//   e_p   = relu(att1_p + att2) . full_w + full_b            (rows, P)
//   alpha = softmax_p(e)
//   ctx   = sum_p alpha_p feat_p                             (rows, FS)
//   out   = sigmoid(h f_beta_w + f_beta_b) * ctx
//
// att_score and softmax_row are its scores and softmax; K6's launches
// (att_decode_step.cu's many-row ones, split_step.cuh's column-split ones)
// and K7 (att_beam.cu, on grid_beam.cuh) call them, and write att2, the
// context and the gate as chains in the same k order (dot4's, from 0.f,
// the bias after).  The search's h0/c0 (_mega_att_kernel's _init, :455)
// is K7's own stages, which att_beam.cu also runs alone for the
// fused-step path.
//
// So K6 and K7 compute every output as the same fixed chain of fmaf/adds
// (-fmad=false), and one row's arithmetic does not depend on how many rows
// a block holds: a beam run step by step through K6 scores as the same
// beam inside K7.  The contraction orders are not the XLA oracle's
// (one dot over A; sum over P of feat * alpha) nor the TPU kernel's (A in
// 128-wide pieces; P in tiles in the streamed call): the port is held to
// them with a tolerance.
//
// What bounds it: bytes.  Per step one image's att1 (P x A) and features
// (P x FS), 2 MB at the serving shape, stream from L2/HBM for a few rows;
// the features do not fit the 227 KB of shared memory (the TPU kernel kept
// them resident in VMEM).  The score pass reads att1 as float4 rows (one
// warp per position).
#pragma once

#include "decode_common.cuh"

namespace icee {

// most beam rows a block attends at once (register tiles); K6 and K7 take
// a wider beam's rows in groups of ATT_ROWS
constexpr int ATT_ROWS = KMAX;

struct AttWeights {
  const float* __restrict__ decw;   // (H, A)
  const float* __restrict__ decb;   // (A,)
  const float* __restrict__ fullw;  // (A,)  full_att weight (A, 1)
  const float* __restrict__ fullb;  // (1,)
  const float* __restrict__ fbw;    // (H, FS) f_beta
  const float* __restrict__ fbb;    // (FS,)
  int H, A, P, FS;
};

// One warp scores one position for `rows` (<= MAXR) rows: each lane a
// chain over its A quads of relu(att1_p + att2_r) * full_w, then the warp's
// butterfly sum, the bias after; lane 0 writes dst[r * ldd].  a1 is the
// position's att1 row (A floats, global), att2 (rows x ld2) is in shared
// memory, or (CG) in device memory written by other blocks, read through
// L2.  The whole warp must call it.
template <int MAXR, bool CG = false>
__device__ __forceinline__ void att_score(const float* __restrict__ a1,
                                          const AttWeights& w,
                                          const float* att2, int ld2,
                                          int rows, float* dst, int ldd) {
  const int lane = threadIdx.x & 31, A = w.A;
  float e[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) e[r] = 0.f;
  for (int a = 4 * lane; a < A; a += 128) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(a1 + a));
    const float4 fw = __ldg(reinterpret_cast<const float4*>(w.fullw + a));
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < rows) {
        const float4* dp =
            reinterpret_cast<const float4*>(att2 + (size_t)r * ld2 + a);
        float4 d;
        if constexpr (CG)
          d = __ldcg(dp);
        else
          d = *dp;
        e[r] = fmaf(fmaxf(v.x + d.x, 0.f), fw.x, e[r]);
        e[r] = fmaf(fmaxf(v.y + d.y, 0.f), fw.y, e[r]);
        e[r] = fmaf(fmaxf(v.z + d.z, 0.f), fw.z, e[r]);
        e[r] = fmaf(fmaxf(v.w + d.w, 0.f), fw.w, e[r]);
      }
    }
  }
  const float fb = w.fullb[0];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {  // rows is the same for the whole warp
      const float sum = warp_sum(e[r]);
      if (lane == 0) dst[r * ldd] = sum + fb;
    }
  }
}

// One warp: softmax over the P scores of one row, exp(e - max) / sum, in
// place in er (shared memory, or (CG) device memory that other blocks
// wrote, read through L2: the same reduction either way); also into
// out[p] when out is not null.
template <bool CG = false>
__device__ __forceinline__ void softmax_row(float* er, int P, float* out) {
  const int lane = threadIdx.x & 31;
  auto e_at = [&](int p) {
    if constexpr (CG)
      return __ldcg(er + p);
    else
      return er[p];
  };
  float m = -INFINITY;
  for (int p = lane; p < P; p += 32) m = fmaxf(m, e_at(p));
  m = warp_max(m);
  float sum = 0.f;
  for (int p = lane; p < P; p += 32) sum += expf(e_at(p) - m);
  sum = warp_sum(sum);
  for (int p = lane; p < P; p += 32) {
    const float a = expf(e_at(p) - m) / sum;
    er[p] = a;
    if (out != nullptr) out[p] = a;
  }
}

}  // namespace icee
