// Device functions of the attention decoders (StyleNet+Att, NIC+Att),
// shared by K6 (att_decode_step.cu, one beam step) and K7 (att_beam.cu,
// the whole beam search).
//
// attend_rows is the re-attention of icee_tpu/ops/pallas_att_decode.py::
// _attend_block (:46) for the beam rows of ONE image:
//   att2  = h dec_w + dec_b                                  (rows, A)
//   e_p   = relu(att1_p + att2) . full_w + full_b            (rows, P)
//   alpha = softmax_p(e)
//   ctx   = sum_p alpha_p feat_p                             (rows, FS)
//   out   = sigmoid(h f_beta_w + f_beta_b) * ctx
// init_state is the h0/c0 of the search (_mega_att_kernel's _init, :455):
// the mean of the image's P feature rows through init_h and init_c.
//
// K6 and K7 call the very same functions, and every output is a fixed chain
// of fmaf/adds (-fmad=false), so one row's arithmetic does not depend on how
// many rows a block holds: a beam run step by step through K6 scores as the
// same beam inside K7.  The contraction orders are not the XLA oracle's
// (one dot over A; sum over P of feat * alpha) nor the TPU kernel's (A in
// 128-wide pieces; P in tiles in the streamed call): the port is held to
// them with a tolerance.
//
// What bounds it: bytes.  Per step one image's att1 (P x A) and features
// (P x FS), 2 MB at the serving shape, plus dec_w and f_beta_w (5 MB) stream
// from L2/HBM for a few rows; the features do not fit the 227 KB of shared
// memory (the TPU kernel kept them resident in VMEM).  What the design does
// about it: the score pass reads att1 as float4 rows (one warp per
// position), and the context and gate products run as column quads with 8
// loads in flight (decode_common.cuh dot4).
#pragma once

#include "decode_common.cuh"

namespace icee {

constexpr int ATT_ROWS = KMAX;  // most beam rows of one image (register tiles)

struct AttWeights {
  const float* __restrict__ decw;   // (H, A)
  const float* __restrict__ decb;   // (A,)
  const float* __restrict__ fullw;  // (A,)  full_att weight (A, 1)
  const float* __restrict__ fullb;  // (1,)
  const float* __restrict__ fbw;    // (H, FS) f_beta
  const float* __restrict__ fbb;    // (FS,)
  int H, A, P, FS;
};

struct InitWeights {
  const float* __restrict__ ihw;  // (FS, H) init_h
  const float* __restrict__ ihb;  // (H,)
  const float* __restrict__ icw;  // (FS, H) init_c
  const float* __restrict__ icb;  // (H,)
};

// Shared floats attend_rows needs for `rows` rows: att2 then alpha.
__host__ __device__ inline int att_scratch(const AttWeights& w, int rows) {
  return rows * (round4(w.A) + round4(w.P));
}

// `rows` (<= MAXR) beam rows of one image attend over its P positions.  hs
// (rows x ldh) is in shared memory; feat (P, FS) and att1 (P, A) are the
// image's, in global memory; scratch holds att_scratch(w, rows) floats of
// shared memory (16-byte aligned).  Writes out[r * ldo + j] = gate * ctx
// for j < FS, and alpha_out[r * P + p] when alpha_out is not null.  A, FS
// and H must be multiples of 4.  All threads of the block must call it; it
// ends with a barrier.
template <int MAXR>
__device__ void attend_rows(const float* hs, int ldh, int rows,
                            const AttWeights& w,
                            const float* __restrict__ feat,
                            const float* __restrict__ att1, float* scratch,
                            float* out, int ldo, float* alpha_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int A = w.A, P = w.P, FS = w.FS, H = w.H;
  const int Ap = round4(A), Pp = round4(P);
  float* att2 = scratch;             // (rows, Ap)
  float* alpha = att2 + rows * Ap;   // (rows, Pp) scores, then weights
  float acc[MAXR][4];

  // att2 = h dec_w + dec_b
  for (int q = tid; q < A / 4; q += nt) {
    const int col = 4 * q;
    dot4<MAXR>(hs, ldh, rows, w.decw, A, col, H, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          att2[r * Ap + col + j] = acc[r][j] + w.decb[col + j];
  }
  __syncthreads();

  // scores: one warp per position, each lane a chain over its A quads, then
  // the warp's butterfly sum; the bias after
  const float fb = w.fullb[0];
  for (int p = warp; p < P; p += n_warps) {
    float e[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) e[r] = 0.f;
    const float* a1 = att1 + (size_t)p * A;
    for (int a = 4 * lane; a < A; a += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(a1 + a));
      const float4 fw = __ldg(reinterpret_cast<const float4*>(w.fullw + a));
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < rows) {
          const float4 d = *reinterpret_cast<const float4*>(att2 + r * Ap + a);
          e[r] = fmaf(fmaxf(v.x + d.x, 0.f), fw.x, e[r]);
          e[r] = fmaf(fmaxf(v.y + d.y, 0.f), fw.y, e[r]);
          e[r] = fmaf(fmaxf(v.z + d.z, 0.f), fw.z, e[r]);
          e[r] = fmaf(fmaxf(v.w + d.w, 0.f), fw.w, e[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < rows) {  // rows is the same for the whole block
        const float sum = warp_sum(e[r]);
        if (lane == 0) alpha[r * Pp + p] = sum + fb;
      }
    }
  }
  __syncthreads();

  // softmax over P, one warp per row: exp(e - max) / sum
  for (int r = warp; r < rows; r += n_warps) {
    float* er = alpha + r * Pp;
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, er[p]);
    m = warp_max(m);
    float sum = 0.f;
    for (int p = lane; p < P; p += 32) sum += expf(er[p] - m);
    sum = warp_sum(sum);
    for (int p = lane; p < P; p += 32) {
      const float a = expf(er[p] - m) / sum;
      er[p] = a;
      if (alpha_out != nullptr) alpha_out[(size_t)r * P + p] = a;
    }
  }
  __syncthreads();

  // ctx = alpha feat (a chain over P), then out = sigmoid(h f_beta_w +
  // f_beta_b) * ctx; each thread rereads only what it wrote
  for (int q = tid; q < FS / 4; q += nt) {
    const int col = 4 * q;
    dot4<MAXR>(alpha, Pp, rows, feat, FS, col, P, acc);
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[r * ldo + col + j] = acc[r][j];
    dot4<MAXR>(hs, ldh, rows, w.fbw, FS, col, H, acc);
    const float4 b = __ldg(reinterpret_cast<const float4*>(w.fbb + col));
    const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[r * ldo + col + j] = sigmoid(acc[r][j] + bb[j]) * out[r * ldo + col + j];
  }
  __syncthreads();
}

// h0, c0 of one image (H floats each, shared or global): the mean of its P
// feature rows (a sequential sum over P, then / P) into m (shared, FS
// floats, 16-byte aligned), then m init_h_w + init_h_b and m init_c_w +
// init_c_b.  FS and H must be multiples of 4.  All threads of the block
// must call it; it ends with a barrier.
__device__ inline void init_state(const float* __restrict__ feat, int P,
                                  int FS, const InitWeights& w, int H,
                                  float* m, float* h_out, float* c_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int f = tid; f < FS; f += nt) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += feat[(size_t)p * FS + f];
    m[f] = s / (float)P;
  }
  __syncthreads();
  float acc[1][4];
  for (int q = tid; q < H / 4; q += nt) {
    const int col = 4 * q;
    dot4<1>(m, FS, 1, w.ihw, H, col, FS, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) h_out[col + j] = acc[0][j] + w.ihb[col + j];
    dot4<1>(m, FS, 1, w.icw, H, col, FS, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) c_out[col + j] = acc[0][j] + w.icb[col + j];
  }
  __syncthreads();
}

}  // namespace icee
