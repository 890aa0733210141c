// K5: the attention training scan of StyleNet+Att and NIC+Att, teacher-
// forced and scheduled-sampling, forward and backward.
//
// Replaces icee_tpu/ops/pallas_att_train.py::fused_att_scan (:540) and
// fused_att_scan_sampled (:887): the custom_vjp around the Pallas kernels
// _fwd_kernel (:197, call :623) and _bwd_kernel (:275, call :758) with the
// weight grads of _bwd_impl (:786-876).  Per step t, with h = h_{t-1}:
//   att2 = h dec_w + dec_b, e_p = relu(att1_p + att2) . full_w + full_b,
//   alpha = softmax_p(e), ctx = sum_p alpha_p feat_p,
//   gate = sigmoid(h fb_w + fb_b), x = [emb_t ; gate * ctx],
//   then the factored cell (gates [i, f, o, c], h = o c) or the LSTM cell
//   ([i, f, g, o], h = o tanh c) on x (cell_gates.cuh, shared with K3/K4);
// sampled: emb_t is the teacher's where coin_t = 1, else the raw embedding
// of the previous step's argmax (emb_raw at t = 0); the head h C_w + C_b
// and its argmax (lowest index on ties) run after every step.
//
// What bounds it on the H100.  At B = 128, T = 25, E = 300, F = H = A =
// 512, P = 196, FS = 2048 a forward is ~62 GFLOP of products (the sampled
// head adds ~27) against 257 MB of att1 and features.  The TPU kernel held
// a batch tile's features and att1 in VMEM across all T steps; one image's
// features (1.6 MB) are 7x a block's shared memory and all of them 4x the
// L2, so here they stream from HBM every step in both directions (6.4 GB,
// ~1.9 ms a direction at 3.35 TB/s): that is the floor.  The products were
// ~70% of each direction on the CUDA cores (gemm_f32.cuh, ~9.5 TFLOP/s:
// 64 x 64 tiles with M = 128 give 64-256 blocks on 132 SMs, no copy in
// flight).  What the design does:
//   - every product runs on the tensor cores at float32 accuracy
//     (gemm_tf32x3.cuh: three TF32 passes, hi/lo split of each operand,
//     cp.async ring, 128 x 64 block tiles), 495 / 3 TFLOP/s at most, and a
//     split-K schedule fixed by the shape brings every per-step product,
//     the batched S, U, ds and dv too, near two blocks an SM;
//   - everything that depends on h_{t-1} is ONE product per step,
//     h [dec_w | fb_w | W], so the weights are read once per 128 x 64
//     output tile, not once per image;
//   - the per-image passes (scores, softmax, context, gate; backward:
//     d_alpha, the softmax backward, d_att2) are one launch of one block
//     per image that streams its att1 and features as float4 with several
//     loads in flight per thread (~77% of HBM's rate);
//   - the forward SAVES what the backward needs (x, ctx, the gate
//     pre-activations and att2, the gate activations), so the backward
//     reads the features once a step (for d_alpha), not twice: the TPU
//     kernel recomputed them because its re-reads were free;
//   - d_att1 and full_w's grad are not accumulated every step (51 MB of
//     read-modify-write a step): the backward keeps the score grads d_e
//     (B, P) of each step and one pass after the loop sums the T steps for
//     each (image, p, a), reading att1 once.  A block of that pass holds
//     the image's att2 of every step, (T, A), in shared memory; where that
//     does not fit (A = 2048 from T = 28, A = 1024 from T = 56), the pass
//     splits A into column blocks that do (datt1_cols), each (p, a) sum
//     and each column's share of full_w's grad as before, so the same
//     bits: any A, and T up to ~1,800.  Past that (not even 4 columns of
//     the plane fit) the pass also cuts T into chunks of steps
//     (datt1_steps), a column a thread: each (p, a) sum is the same chain
//     in s order, carried in registers from one chunk to the next, and
//     full_w's grad a column's chain over (chunk, position, step): any T.
// What bounds it now (PERF.md): the products still take about half of
// each direction, 16-31 TFLOP/s for the per-step ones, bound by a launch's
// fixed costs (pipeline fill, the partial sums) more than by their
// arithmetic; the attention passes, at ~77% of HBM, take the rest.
// No atomics, every sum in a fixed order: the same inputs give the same
// bits on every run.  Built with -fmad=false like every library here.
// gemm_f32.cuh is included for colsum and for icee_f32_gemm, the CUDA-core
// product that the card tests hold the new one against; K5 launches none
// of its products.
#include "cell_gates.cuh"
#include "decode_common.cuh"
#include "gemm_f32.cuh"
#include "gemm_tf32x3.cuh"

namespace icee {

constexpr int AT_THREADS = 512;   // per-image attention blocks
constexpr int EW_THREADS = 256;   // elementwise launches
constexpr int AM_THREADS = 256;   // argmax blocks (one per row)
constexpr int D1_PCH = 28;        // positions per block of the d_att1 pass
constexpr int D1_THREADS = 256;
constexpr size_t SMEM_MAX = 232448;

// ---- forward ------------------------------------------------------------

// Step t's attention for image blockIdx.x.  hp (B, NCAT): att2 in [0, A),
// the gate pre-activation in [A, A + FS).  Writes alpha (B, P), ctx (B, FS)
// and x (B, E + FS) = [emb ; sigmoid(gate pre) * ctx], emb the step's
// teacher row (B, E) or, where coin is given and 0, pemb (B, E).
__global__ void __launch_bounds__(AT_THREADS)
att_fwd_kernel(const float* __restrict__ emb, const float* __restrict__ pemb,
               const float* __restrict__ coin,
               const float* __restrict__ att1,
               const float* __restrict__ feats,
               const float* __restrict__ fullw,
               const float* __restrict__ fullb, const float* __restrict__ hp,
               float* alpha, float* ctx, float* x, int E, int A, int P,
               int FS, int NCAT) {
  extern __shared__ __align__(16) float sm[];
  float* att2 = sm;             // (round4(A))
  float* al = sm + round4(A);   // (round4(P)): scores, then weights
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const float* hrow = hp + (size_t)b * NCAT;
  float* xrow = x + (size_t)b * (E + FS);
  for (int a = tid; a < A; a += nt) att2[a] = hrow[a];
  const float* src = (coin == nullptr || *coin != 0.f) ? emb : pemb;
  for (int e = tid; e < E; e += nt) xrow[e] = src[(size_t)b * E + e];
  __syncthreads();

  // scores: one warp per position, a chain over A quads, the warp's sum
  const float* a1 = att1 + (size_t)b * P * A;
  const float fb = fullb[0];
  for (int p = warp; p < P; p += n_warps) {
    const float* row = a1 + (size_t)p * A;
    float acc = 0.f;
    for (int a = 4 * lane; a < A; a += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + a));
      const float4 w = __ldg(reinterpret_cast<const float4*>(fullw + a));
      const float4 d = *reinterpret_cast<const float4*>(att2 + a);
      acc = fmaf(fmaxf(v.x + d.x, 0.f), w.x, acc);
      acc = fmaf(fmaxf(v.y + d.y, 0.f), w.y, acc);
      acc = fmaf(fmaxf(v.z + d.z, 0.f), w.z, acc);
      acc = fmaf(fmaxf(v.w + d.w, 0.f), w.w, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) al[p] = acc + fb;
  }
  __syncthreads();

  // softmax over P: exp(e - max) / sum
  if (warp == 0) {
    float m = -INFINITY;
    for (int p = lane; p < P; p += 32) m = fmaxf(m, al[p]);
    m = warp_max(m);
    float s = 0.f;
    for (int p = lane; p < P; p += 32) s += expf(al[p] - m);
    s = warp_sum(s);
    for (int p = lane; p < P; p += 32) {
      const float w = expf(al[p] - m) / s;
      al[p] = w;
      alpha[(size_t)b * P + p] = w;
    }
  }
  __syncthreads();

  // context, one column quad per thread: a chain over P with four rows of
  // loads in flight; then the gate
  const float* fr = feats + (size_t)b * P * FS;
  for (int q = tid; q < FS / 4; q += nt) {
    const int f = 4 * q;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    int p = 0;
    for (; p + 4 <= P; p += 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __ldg(reinterpret_cast<const float4*>(fr + (size_t)(p + u) * FS + f));
#pragma unroll
      for (int u = 0; u < 4; ++u) fma4(c, al[p + u], v[u]);
    }
    for (; p < P; ++p)
      fma4(c, al[p], __ldg(reinterpret_cast<const float4*>(fr + (size_t)p * FS + f)));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ctx[(size_t)b * FS + f + j] = c[j];
      xrow[E + f + j] = sigmoid(hrow[A + f + j]) * c[j];
    }
  }
}

// The cell's gates for all B x H units of one step: z (B, 4H) holds the
// input side (u, or x W_ih + b_ih) on entry and the activations on exit;
// hw (ld ldhw) holds h_{t-1} W (no bias).
template <class Gates>
__global__ void __launch_bounds__(EW_THREADS)
cell_fwd_kernel(float* z, const float* __restrict__ bias,
                const float* __restrict__ hw, int ldhw,
                const float* __restrict__ c_prev, float* c_new, float* h_new,
                int B, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  float acc[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) acc[g] = hw[(size_t)b * ldhw + g * H + j];
  float c, h;
  Gates::forward(z + (size_t)b * 4 * H, bias, acc, H, j, c_prev[i], c, h);
  c_new[i] = c;
  h_new[i] = h;
}

// Row blockIdx.x of logits (B, V): the argmax, lowest index on ties, into
// idx, and that token's raw embedding Bemb[idx] (E floats) into pemb, the
// next step's feedback input.
__global__ void __launch_bounds__(AM_THREADS)
argmax_embed_kernel(const float* __restrict__ logits, int V,
                    const float* __restrict__ Bemb, int E, int* idx,
                    float* pemb) {
  __shared__ float sv[AM_THREADS / 32];
  __shared__ int si[AM_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n_warps = blockDim.x >> 5;
  const float* row = logits + (size_t)b * V;
  float best = -INFINITY;
  int bi = V;  // V: no column seen
  for (int j = tid; j < V; j += blockDim.x) {
    const float v = row[j];
    if (bi == V || v > best) {
      best = v;
      bi = j;
    }
  }
  int slot = 0;
  warp_argmax(best, bi, slot);
  if ((tid & 31) == 0) {
    sv[tid >> 5] = best;
    si[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid < 32) {
    float v = tid < n_warps ? sv[tid] : -INFINITY;
    int k = tid < n_warps ? si[tid] : V;
    warp_argmax(v, k, slot);
    if (tid == 0) {
      si[0] = k;
      idx[b] = k;
    }
  }
  __syncthreads();
  const int k = si[0];
  for (int e = tid; e < E; e += blockDim.x)
    pemb[(size_t)b * E + e] = Bemb[(size_t)k * E + e];
}

// ---- backward -----------------------------------------------------------

// Reverse step s of the cell for all B x H units: dh_total = dh + the
// carry (none at the last step), the gate derivatives into dz (ld ldz) and
// the carried dc, from the forward's activations.
template <class Gates>
__global__ void __launch_bounds__(EW_THREADS)
cell_bwd_kernel(const float* __restrict__ gates,
                const float* __restrict__ c_new,
                const float* __restrict__ c_prev,
                const float* __restrict__ dh,
                const float* __restrict__ dh_carry, float* dc, float* dz,
                int ldz, int B, int H, int last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  const float dh_total = last ? dh[i] : dh[i] + dh_carry[i];
  const float dc_in = last ? 0.f : dc[i];
  dc[i] = Gates::backward(gates + (size_t)b * 4 * H, dz + (size_t)b * ldz, H,
                          j, c_new[i], c_prev[i], dh_total, dc_in);
}

// Reverse step s of the attention for image blockIdx.x.  dx (B, E + FS):
// the step's input grads [d_emb ; d_gctx].  Writes dcat (B, NCAT): d_att2
// in [0, A) and dpre_fb in [A, A + FS); de (B, P), the score grads; demb
// (B, E), the teacher share of d_emb, and where coin is given, dsamp (B,
// E), the sampled share.  The formulas of _bwd_kernel :418-475.
__global__ void __launch_bounds__(AT_THREADS)
att_bwd_kernel(const float* __restrict__ dx, const float* __restrict__ ctx,
               const float* __restrict__ hp,
               const float* __restrict__ alpha,
               const float* __restrict__ dalpha,
               const float* __restrict__ att1,
               const float* __restrict__ feats,
               const float* __restrict__ fullw,
               const float* __restrict__ coin, float* dcat, float* de,
               float* demb, float* dsamp, int E, int A, int P, int FS,
               int NCAT) {
  extern __shared__ __align__(16) float sm[];
  float* dctx = sm;                 // (round4(FS))
  float* att2 = dctx + round4(FS);  // (round4(A))
  float* dal = att2 + round4(A);    // (round4(P)): d_alpha, then d_e
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const float* hrow = hp + (size_t)b * NCAT;
  const float* dxr = dx + (size_t)b * (E + FS);
  const float* crow = ctx + (size_t)b * FS;
  float* drow = dcat + (size_t)b * NCAT;
  for (int f = tid; f < FS; f += nt) {
    const float g = sigmoid(hrow[A + f]);
    const float dg = dxr[E + f];
    dctx[f] = dg * g;
    const float d_gate = dg * crow[f];
    drow[A + f] = d_gate * g * (1.f - g);
  }
  for (int a = tid; a < A; a += nt) att2[a] = hrow[a];
  if (coin == nullptr) {
    for (int e = tid; e < E; e += nt) demb[(size_t)b * E + e] = dxr[e];
  } else {
    const float cn = *coin;
    for (int e = tid; e < E; e += nt) {
      const float d = dxr[e];
      demb[(size_t)b * E + e] = cn * d;
      dsamp[(size_t)b * E + e] = (1.f - cn) * d;
    }
  }
  __syncthreads();

  // d_alpha_p = d_ctx . feat_p + dalpha_p: one warp per position (the
  // features cotangent is dropped)
  const float* fr = feats + (size_t)b * P * FS;
  for (int p = warp; p < P; p += n_warps) {
    const float* row = fr + (size_t)p * FS;
    float acc = 0.f;
    for (int f = 4 * lane; f < FS; f += 128) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + f));
      const float4 d = *reinterpret_cast<const float4*>(dctx + f);
      acc = fmaf(d.x, v.x, acc);
      acc = fmaf(d.y, v.y, acc);
      acc = fmaf(d.z, v.z, acc);
      acc = fmaf(d.w, v.w, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) dal[p] = acc + dalpha[(size_t)b * P + p];
  }
  __syncthreads();

  // softmax backward: d_e = alpha (d_alpha - sum_p d_alpha alpha)
  if (warp == 0) {
    const float* ar = alpha + (size_t)b * P;
    float s = 0.f;
    for (int p = lane; p < P; p += 32) s += dal[p] * ar[p];
    s = warp_sum(s);
    for (int p = lane; p < P; p += 32) {
      const float d = ar[p] * (dal[p] - s);
      dal[p] = d;
      de[(size_t)b * P + p] = d;
    }
  }
  __syncthreads();

  // d_att2_a = sum_p (att1_pa + att2_a > 0) d_e_p full_w_a: one column per
  // thread, four rows of loads in flight (relu' is 0 at 0)
  const float* a1 = att1 + (size_t)b * P * A;
  for (int a = tid; a < A; a += nt) {
    const float fw = fullw[a], a2 = att2[a];
    float acc = 0.f;
    int p = 0;
    for (; p + 4 <= P; p += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldg(a1 + (size_t)(p + u) * A + a);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v[u] + a2 > 0.f) acc += dal[p + u] * fw;
    }
    for (; p < P; ++p)
      if (__ldg(a1 + (size_t)p * A + a) + a2 > 0.f) acc += dal[p] * fw;
    drow[a] = acc;
  }
}

// After the reverse loop, block (b, chunk, column block) for positions
// [chunk D1_PCH, ...) of image b and columns [z Ac, (z + 1) Ac) of A:
// d_att1[b, p, a] = sum over steps s = T - 1 .. 0 of (att1 + att2_s > 0)
// d_e_s[p] full_w[a], and the block's share of full_w's grad, sum over its
// positions and steps of relu(att1 + att2_s) d_e_s[p], into its columns of
// its row of fw_part (the rows are summed in block order after).  Ac = A
// where the whole (T, A) plane fits (one column block).  Tc < T (Ac <=
// D1_THREADS, a column a thread): the steps in chunks of Tc from the last,
// each chunk's (Tc, Ac) plane of att2 and (Tc, D1_PCH) of d_e in shared
// memory in turn, the thread's D1_PCH sums d and its full_w sum carried
// in registers.
__global__ void __launch_bounds__(D1_THREADS)
datt1_kernel(const float* __restrict__ att1, const float* __restrict__ hp,
             const float* __restrict__ de, const float* __restrict__ fullw,
             float* datt1, float* fw_part, int B, int T, int P, int A,
             int NCAT, int Ac, int Tc) {
  extern __shared__ __align__(16) float sm[];
  const int a0 = blockIdx.z * Ac, na = min(Ac, A - a0);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int p0 = blockIdx.y * D1_PCH, np = min(D1_PCH, P - p0);
  if (Tc < T) {
    float* a2c = sm;              // (Tc, na): att2 of a chunk of steps
    float* dec = sm + Tc * na;    // (Tc, D1_PCH): their d_e
    const bool mine = tid < na;
    const int a = a0 + (mine ? tid : 0);
    const float fw = fullw[a];
    float x[D1_PCH], d[D1_PCH];
#pragma unroll
    for (int q = 0; q < D1_PCH; ++q) {
      x[q] = mine && q < np ? att1[((size_t)b * P + p0 + q) * A + a] : 0.f;
      d[q] = 0.f;
    }
    float wacc = 0.f;
    for (int s1 = T; s1 > 0; s1 -= Tc) {   // steps [s0, s1), from the last
      const int s0 = max(0, s1 - Tc), ns = s1 - s0;
      __syncthreads();   // the last chunk is read
      for (int i = tid; i < ns * na; i += nt) {
        const int s = i / na, al = i % na;
        a2c[i] = hp[((size_t)(s0 + s) * B + b) * NCAT + a0 + al];
      }
      for (int i = tid; i < ns * D1_PCH; i += nt) {
        const int s = i / D1_PCH, q = i % D1_PCH;
        dec[i] = q < np ? de[((size_t)(s0 + s) * B + b) * P + p0 + q] : 0.f;
      }
      __syncthreads();
      if (!mine) continue;
#pragma unroll
      for (int q = 0; q < D1_PCH; ++q) {
        if (q >= np) continue;
        for (int s = ns - 1; s >= 0; --s) {
          const float pre = x[q] + a2c[s * na + tid];
          if (pre > 0.f) {
            const float e = dec[s * D1_PCH + q];
            d[q] += e * fw;
            wacc += pre * e;
          }
        }
      }
    }
    if (!mine) return;
#pragma unroll
    for (int q = 0; q < D1_PCH; ++q)
      if (q < np) datt1[((size_t)b * P + p0 + q) * A + a] = d[q];
    fw_part[((size_t)b * gridDim.y + blockIdx.y) * A + a] = wacc;
    return;
  }
  float* a2s = sm;              // (T, na): att2 of image b at every step
  float* des = sm + T * na;     // (T, D1_PCH): this chunk's d_e
  for (int i = tid; i < T * na; i += nt) {
    const int s = i / na, a = i % na;
    a2s[i] = hp[((size_t)s * B + b) * NCAT + a0 + a];
  }
  for (int i = tid; i < T * D1_PCH; i += nt) {
    const int s = i / D1_PCH, q = i % D1_PCH;
    des[i] = q < np ? de[((size_t)s * B + b) * P + p0 + q] : 0.f;
  }
  __syncthreads();
  for (int al = tid; al < na; al += nt) {
    const int a = a0 + al;
    const float fw = fullw[a];
    float wacc = 0.f;
    for (int q = 0; q < np; ++q) {
      const size_t at = ((size_t)b * P + p0 + q) * A + a;
      const float x = att1[at];
      float d = 0.f;
      for (int s = T - 1; s >= 0; --s) {
        const float pre = x + a2s[s * na + al];
        if (pre > 0.f) {
          const float e = des[s * D1_PCH + q];
          d += e * fw;
          wacc += pre * e;
        }
      }
      datt1[at] = d;
    }
    fw_part[((size_t)b * gridDim.y + blockIdx.y) * A + a] = wacc;
  }
}

// d_B[v] = sum over i < n, in i order, of rows[i] (E floats) where tok[i]
// == v: the sampled steps' input grads scattered into the raw embedding
// table by their tokens, no atomics.  One warp per vocab row: the warp
// scans the tokens 32 at a time (a ballot of the matches) and adds the
// matching rows in index order, lane by lane over E in passes of
// 32 * SC_ACC columns.  A token the argmax picks for most rows makes one
// warp add thousands of rows, so the loads of SC_MB matches are started
// together before they are added (in order).  Every row of d_B is written.
constexpr int SC_ACC = 10;  // E = 300 in one pass
constexpr int SC_MB = 8;
constexpr int SC_THREADS = 256;

__global__ void __launch_bounds__(SC_THREADS)
scatter_rows_kernel(const int* __restrict__ tok,
                    const float* __restrict__ rows, int n, int E, int V,
                    float* dB) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * (SC_THREADS / 32) + (threadIdx.x >> 5);
  if (v >= V) return;  // whole warps leave together
  for (int e0 = 0; e0 < E; e0 += 32 * SC_ACC) {
    float acc[SC_ACC];
#pragma unroll
    for (int q = 0; q < SC_ACC; ++q) acc[q] = 0.f;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      unsigned m = __ballot_sync(FULL, i < n && __ldg(tok + i) == v);
      while (m) {
        int js[SC_MB];
        float vals[SC_MB][SC_ACC];
#pragma unroll
        for (int u = 0; u < SC_MB; ++u) {
          js[u] = m ? i0 + __ffs(m) - 1 : -1;
          m &= m - 1;
        }
#pragma unroll
        for (int u = 0; u < SC_MB; ++u)
#pragma unroll
          for (int q = 0; q < SC_ACC; ++q) {
            const int e = e0 + lane + 32 * q;
            vals[u][q] = js[u] >= 0 && e < E
                             ? __ldg(rows + (size_t)js[u] * E + e) : 0.f;
          }
#pragma unroll
        for (int u = 0; u < SC_MB; ++u)
          if (js[u] >= 0)
#pragma unroll
            for (int q = 0; q < SC_ACC; ++q) acc[q] += vals[u][q];
      }
    }
#pragma unroll
    for (int q = 0; q < SC_ACC; ++q) {
      const int e = e0 + lane + 32 * q;
      if (e < E) dB[(size_t)v * E + e] = acc[q];
    }
  }
}

inline size_t datt1_smem(int T, int Ac) {
  return sizeof(float) * ((size_t)T * Ac + (size_t)T * D1_PCH);
}

// Columns of a d_att1 block (ops/att_scan.py::datt1_plan mirrors it): A
// where the (T, A) plane fits, else the fewest column blocks whose planes
// do, their width a multiple of 4 (the last may be narrower); past T ~
// 1,816, where not even 4 columns fit, a column a thread: min(A,
// D1_THREADS), the steps then chunked (datt1_steps).
inline int datt1_cols(int T, int A) {
  if (datt1_smem(T, A) <= SMEM_MAX) return A;
  const long long most =
      (((long long)(SMEM_MAX / sizeof(float)) - (long long)T * D1_PCH) / T) &
      ~3LL;
  if (most < 4) return A < D1_THREADS ? A : D1_THREADS;
  const long long n = (A + most - 1) / most;
  return (int)(((A + n - 1) / n + 3) & ~3LL);
}

// Steps of att2 a d_att1 block holds at once: T where the pass fits as
// above, else the most whose (steps, datt1_cols) plane and d_e do.
inline int datt1_steps(int T, int A) {
  const int Ac = datt1_cols(T, A);
  if (datt1_smem(T, Ac) <= SMEM_MAX) return T;
  return (int)(SMEM_MAX / sizeof(float) / ((size_t)Ac + D1_PCH));
}

// ---- the two scans ------------------------------------------------------

// Layouts: rows are time-major, (t, b).  emb (T, B, E); hbuf, cbuf (T + 1,
// B, H) with h0, c0 in slot 0; saved: alpha (T, B, P), x (T, B, E + FS),
// hp (T, B, NCAT), ctx (T, B, FS), z (T, B, 4H) gate activations, v, s
// (T, B, 4F) for the factored cell.  Win (E + FS, 4F or 4H) with bias bin;
// brec the bias the gates add (W_b or b_hh).  coins != null: sampled, with
// pemb (B, E) = emb_raw[:, 0] on entry, logits (B, V) scratch, pidx (T, B).
template <class Gates>
static int scan_fwd(bool factored, const float* emb, const float* att1,
                    const float* feats, const float* Wcat, const float* bcat,
                    const float* fullw, const float* fullb, const float* Win,
                    const float* bin, const float* Sw, const float* Sb,
                    const float* Uw, const float* Ub, const float* brec,
                    const float* coins, const float* Cw, const float* Cb,
                    const float* Bemb, float* pemb, float* logits, int* pidx,
                    float* hbuf, float* cbuf, float* alpha, float* x,
                    float* hp, float* ctx, float* z, float* v, float* s,
                    float* part, int B, int T, int E, int F, int H, int A,
                    int P, int FS, int V, cudaStream_t st) {
  const int NCAT = A + FS + 4 * H, EX = E + FS, H4 = 4 * H, F4 = 4 * F;
  const size_t BH = (size_t)B * H;
  const size_t att_smem = sizeof(float) * (round4(A) + round4(P));
  const int ew_blocks = (int)((BH + EW_THREADS - 1) / EW_THREADS);
  for (int t = 0; t < T; ++t) {
    float* hp_t = hp + (size_t)t * B * NCAT;
    float* x_t = x + (size_t)t * B * EX;
    float* z_t = z + (size_t)t * B * H4;
    // everything that depends on h_{t-1}: att2, the gate's pre-activation,
    // h W (its bias is the gates')
    ICEE_TRY(tf32x3_gemm('N', hbuf + t * BH, H, Wcat, NCAT, hp_t, NCAT,
                         bcat, B, NCAT, H, 1, 0, 0, 0, 0, part, st));
    att_fwd_kernel<<<B, AT_THREADS, att_smem, st>>>(
        emb + (size_t)t * B * E, pemb, coins ? coins + t : nullptr, att1,
        feats, fullw, fullb, hp_t, alpha + (size_t)t * B * P,
        ctx + (size_t)t * B * FS, x_t, E, A, P, FS, NCAT);
    ICEE_TRY(cudaGetLastError());
    if (factored) {
      float* v_t = v + (size_t)t * B * F4;
      float* s_t = s + (size_t)t * B * F4;
      // v = x V + V_b, s_g = v_g S_g + S_b[g], u_g = s_g U_g + U_b[g]
      ICEE_TRY(tf32x3_gemm('N', x_t, EX, Win, F4, v_t, F4, bin, B, F4, EX,
                           1, 0, 0, 0, 0, part, st));
      ICEE_TRY(tf32x3_gemm('N', v_t, F4, Sw, F, s_t, F4, Sb, B, F, F, 4, F,
                           (long long)F * F, F, F, part, st));
      ICEE_TRY(tf32x3_gemm('N', s_t, F4, Uw, H, z_t, H4, Ub, B, H, F, 4, F,
                           (long long)F * H, H, H, part, st));
    } else {
      ICEE_TRY(tf32x3_gemm('N', x_t, EX, Win, H4, z_t, H4, bin, B, H4, EX,
                           1, 0, 0, 0, 0, part, st));
    }
    cell_fwd_kernel<Gates><<<ew_blocks, EW_THREADS, 0, st>>>(
        z_t, brec, hp_t + A + FS, NCAT, cbuf + t * BH, cbuf + (t + 1) * BH,
        hbuf + (t + 1) * BH, B, H);
    ICEE_TRY(cudaGetLastError());
    if (coins) {
      ICEE_TRY(tf32x3_gemm('N', hbuf + (t + 1) * BH, H, Cw, V, logits, V,
                           Cb, B, V, H, 1, 0, 0, 0, 0, part, st));
      argmax_embed_kernel<<<B, AM_THREADS, 0, st>>>(logits, V, Bemb, E,
                                                    pidx + (size_t)t * B,
                                                    pemb);
      ICEE_TRY(cudaGetLastError());
    }
  }
  return 0;
}

// From the forward's buffers and dh, dalpha (T, B, H / P): demb (T, B, E)
// (sampled: the teacher share, dsamp the rest), dh_c = dh0 and dc = dc0
// (B, H), and the grads: gatt1 (B, P, A), gWcat (H, NCAT), gbcat (NCAT),
// gfullw (A), gfullb (1), gWin (E + FS, 4F or 4H), and for the factored
// cell gVb, gSw, gSb, gUw.  Scratch: dcat (T, B, NCAT) = [d_att2 | dpre_fb
// | dz] per row, ds, dv (T, B, 4F), dx (B, E + FS), de (T, B, P), part
// (icee_att_scan_part_floats), fw_part (B ceil(P / D1_PCH) A + P).
template <class Gates>
static int scan_bwd(bool factored, const float* att1, const float* feats,
                    const float* Wcat, const float* fullw, const float* Win,
                    const float* Sw, const float* Uw, const float* coins,
                    const float* hbuf, const float* cbuf, const float* alpha,
                    const float* x, const float* hp, const float* ctx,
                    const float* z, const float* v, const float* s,
                    const float* dh, const float* dalpha, float* demb,
                    float* dsamp, float* dcat, float* ds, float* dv,
                    float* dx, float* de, float* dh_c, float* dc,
                    float* part, float* fw_part, float* gatt1, float* gWcat,
                    float* gbcat, float* gfullw, float* gfullb, float* gWin,
                    float* gVb, float* gSw, float* gSb, float* gUw, int B,
                    int T, int E, int F, int H, int A, int P, int FS,
                    cudaStream_t st) {
  const int NCAT = A + FS + 4 * H, EX = E + FS, H4 = 4 * H, F4 = 4 * F;
  const size_t BH = (size_t)B * H;
  const size_t att_smem =
      sizeof(float) * (round4(FS) + round4(A) + round4(P));
  const int ew_blocks = (int)((BH + EW_THREADS - 1) / EW_THREADS);
  for (int t = T - 1; t >= 0; --t) {
    float* dcat_t = dcat + (size_t)t * B * NCAT;
    float* dz_t = dcat_t + A + FS;  // row stride NCAT
    cell_bwd_kernel<Gates><<<ew_blocks, EW_THREADS, 0, st>>>(
        z + (size_t)t * B * H4, cbuf + (t + 1) * BH, cbuf + t * BH,
        dh + t * BH, dh_c, dc, dz_t, NCAT, B, H, t == T - 1);
    ICEE_TRY(cudaGetLastError());
    if (factored) {
      float* ds_t = ds + (size_t)t * B * F4;
      float* dv_t = dv + (size_t)t * B * F4;
      // ds_g = dz_g U_g^T, dv_g = ds_g S_g^T, dx = dv [V_we ; V_wc]^T
      ICEE_TRY(tf32x3_gemm('T', dz_t, NCAT, Uw, H, ds_t, F4, nullptr, B, F,
                           H, 4, H, (long long)F * H, F, 0, part, st));
      ICEE_TRY(tf32x3_gemm('T', ds_t, F4, Sw, F, dv_t, F4, nullptr, B, F, F,
                           4, F, (long long)F * F, F, 0, part, st));
      ICEE_TRY(tf32x3_gemm('T', dv_t, F4, Win, F4, dx, EX, nullptr, B, EX,
                           F4, 1, 0, 0, 0, 0, part, st));
    } else {
      ICEE_TRY(tf32x3_gemm('T', dz_t, NCAT, Win, H4, dx, EX, nullptr, B, EX,
                           H4, 1, 0, 0, 0, 0, part, st));
    }
    att_bwd_kernel<<<B, AT_THREADS, att_smem, st>>>(
        dx, ctx + (size_t)t * B * FS, hp + (size_t)t * B * NCAT,
        alpha + (size_t)t * B * P, dalpha + (size_t)t * B * P, att1, feats,
        fullw, coins ? coins + t : nullptr, dcat_t, de + (size_t)t * B * P,
        demb + (size_t)t * B * E, dsamp ? dsamp + (size_t)t * B * E : nullptr,
        E, A, P, FS, NCAT);
    ICEE_TRY(cudaGetLastError());
    // dh_{t-1} = [d_att2 | dpre_fb | dz] [dec_w | fb_w | W]^T (t = 0: dh0)
    ICEE_TRY(tf32x3_gemm('T', dcat_t, NCAT, Wcat, NCAT, dh_c, H, nullptr, B,
                         H, NCAT, 1, 0, 0, 0, 0, part, st));
  }

  // d_att1 and full_w's grad: one pass over att1 summing the T steps
  const int n_ch = (P + D1_PCH - 1) / D1_PCH;
  const int Ac = datt1_cols(T, A), n_col = (A + Ac - 1) / Ac;
  const int Tc = datt1_steps(T, A);
  const size_t d1_smem = datt1_smem(Tc, Ac);
  ICEE_TRY(cudaFuncSetAttribute(datt1_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)d1_smem));
  datt1_kernel<<<dim3(B, n_ch, n_col), D1_THREADS, d1_smem, st>>>(
      att1, hp, de, fullw, gatt1, fw_part, B, T, P, A, NCAT, Ac, Tc);
  ICEE_TRY(cudaGetLastError());
  ICEE_TRY(colsum(fw_part, A, B * n_ch, A, gfullw, 0, st));
  float* de_col = fw_part + (size_t)B * n_ch * A;  // (P,) sums of d_e
  ICEE_TRY(colsum(de, P, T * B, P, de_col, 0, st));
  ICEE_TRY(colsum(de_col, 1, P, 1, gfullb, 0, st));

  // every other weight grad: one product over all N = T B rows
  const int N = T * B;
  ICEE_TRY(tf32x3_gemm('A', hbuf, H, dcat, NCAT, gWcat, NCAT, nullptr, H,
                       NCAT, N, 1, 0, 0, 0, 0, part, st));
  ICEE_TRY(colsum(dcat, NCAT, N, NCAT, gbcat, 0, st));
  if (factored) {
    ICEE_TRY(tf32x3_gemm('A', x, EX, dv, F4, gWin, F4, nullptr, EX, F4, N,
                         1, 0, 0, 0, 0, part, st));
    ICEE_TRY(colsum(dv, F4, N, F4, gVb, 0, st));
    ICEE_TRY(tf32x3_gemm('A', v, F4, ds, F4, gSw, F, nullptr, F, F, N, 4,
                         F, F, (long long)F * F, 0, part, st));
    ICEE_TRY(colsum(ds, F4, N, F4, gSb, 0, st));
    ICEE_TRY(tf32x3_gemm('A', s, F4, dcat + A + FS, NCAT, gUw, H, nullptr,
                         F, H, N, 4, F, H, (long long)F * H, 0, part, st));
  } else {
    ICEE_TRY(tf32x3_gemm('A', x, EX, dcat + A + FS, NCAT, gWin, H4, nullptr,
                         EX, H4, N, 1, 0, 0, 0, 0, part, st));
  }
  return 0;
}

}  // namespace icee

using namespace icee;

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of split-K partials (gemm_tf32x3.cuh) the larger of the two
// scans needs: every product either launches, the weight grads' over T B
// rows included (V = 0: teacher-forced, no head).
long long icee_att_scan_part_floats(int lstm, int B, int T, int E, int F,
                                    int H, int A, int FS, int V) {
  const int NCAT = A + FS + 4 * H, EX = E + FS, G4 = 4 * (lstm ? H : F);
  const int N = T * B;
  const long long each[] = {
      tf32x3_part_floats(B, NCAT, H, 1), tf32x3_part_floats(B, G4, EX, 1),
      V > 0 ? tf32x3_part_floats(B, V, H, 1) : 0,
      tf32x3_part_floats(B, EX, G4, 1), tf32x3_part_floats(B, H, NCAT, 1),
      tf32x3_part_floats(H, NCAT, N, 1), tf32x3_part_floats(EX, G4, N, 1),
      lstm ? 0 : tf32x3_part_floats(B, F, F, 4),
      lstm ? 0 : tf32x3_part_floats(B, H, F, 4),
      lstm ? 0 : tf32x3_part_floats(B, F, H, 4),
      lstm ? 0 : tf32x3_part_floats(F, F, N, 4),
      lstm ? 0 : tf32x3_part_floats(F, H, N, 4)};
  long long n = 1;
  for (long long m : each) n = m > n ? m : n;
  return n;
}

// The product alone, for the card tests and chip_smoke.py: C = A B
// [+ bias] in form 'N', 'T' or 'A' (an int, the letter's code), row strides
// and batch offsets in floats; part: icee_tf32x3_part_floats floats.
long long icee_tf32x3_part_floats(int M, int N, int K, int batch) {
  return tf32x3_part_floats(M, N, K, batch);
}

int icee_tf32x3_gemm(int form, const float* A, long long lda, const float* B,
                     long long ldb, float* C, long long ldc,
                     const float* bias, int M, int N, int K, int batch,
                     long long za, long long zb, long long zc,
                     long long zbias, float* part, void* stream) {
  return tf32x3_gemm((char)form, A, lda, B, ldb, C, ldc, bias, M, N, K,
                     batch, za, zb, zc, zbias, part,
                     static_cast<cudaStream_t>(stream));
}

// gemm_f32.cuh's CUDA-core product on the same arguments: the yardstick of
// the card tests' error bound.  K5 does not call it.
int icee_f32_gemm(int form, const float* A, long long lda, const float* B,
                  long long ldb, float* C, long long ldc, const float* bias,
                  int M, int N, int K, int batch, long long za, long long zb,
                  long long zc, long long zbias, void* stream) {
  if (form != 'N' && form != 'T' && form != 'A') return cudaErrorInvalidValue;
  return gemm((char)form, A, lda, B, ldb, C, ldc, bias, M, N, K, batch, za,
              zb, zc, zbias, static_cast<cudaStream_t>(stream));
}

// Floats of the d_att1 pass's scratch.
long long icee_att_scan_fw_part_floats(int B, int T, int P, int A) {
  return (long long)B * ((P + D1_PCH - 1) / D1_PCH) * A + P;
}

// Columns and steps of a d_att1 block at T and A (datt1_cols,
// datt1_steps), for the wrapper's mirror.
int icee_att_scan_datt1_cols(int T, int A) { return datt1_cols(T, A); }
int icee_att_scan_datt1_steps(int T, int A) { return datt1_steps(T, A); }

int icee_att_scan_fwd(int lstm, const float* emb, const float* att1,
                      const float* feats, const float* Wcat,
                      const float* bcat, const float* fullw,
                      const float* fullb, const float* Win, const float* bin,
                      const float* Sw, const float* Sb, const float* Uw,
                      const float* Ub, const float* brec, const float* coins,
                      const float* Cw, const float* Cb, const float* Bemb,
                      float* pemb, float* logits, int* pidx, float* hbuf,
                      float* cbuf, float* alpha, float* x, float* hp,
                      float* ctx, float* z, float* v, float* s, float* part,
                      int B, int T, int E, int F, int H, int A, int P, int FS,
                      int V, void* stream) {
  if (B < 1 || T < 1 || A % 4 || FS % 4 || (coins && V < 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lstm)
    return scan_fwd<NicGates>(false, emb, att1, feats, Wcat, bcat, fullw,
                              fullb, Win, bin, Sw, Sb, Uw, Ub, brec, coins,
                              Cw, Cb, Bemb, pemb, logits, pidx, hbuf, cbuf,
                              alpha, x, hp, ctx, z, v, s, part, B, T, E, F, H,
                              A, P, FS, V, st);
  return scan_fwd<FactoredGates>(true, emb, att1, feats, Wcat, bcat, fullw,
                                 fullb, Win, bin, Sw, Sb, Uw, Ub, brec, coins,
                                 Cw, Cb, Bemb, pemb, logits, pidx, hbuf, cbuf,
                                 alpha, x, hp, ctx, z, v, s, part, B, T, E, F,
                                 H, A, P, FS, V, st);
}

int icee_att_scan_bwd(int lstm, const float* att1, const float* feats,
                      const float* Wcat, const float* fullw, const float* Win,
                      const float* Sw, const float* Uw, const float* coins,
                      const float* hbuf, const float* cbuf,
                      const float* alpha, const float* x, const float* hp,
                      const float* ctx, const float* z, const float* v,
                      const float* s, const float* dh, const float* dalpha,
                      float* demb, float* dsamp, float* dcat, float* ds,
                      float* dv, float* dx, float* de, float* dh_c, float* dc,
                      float* part, float* fw_part, float* gatt1,
                      float* gWcat, float* gbcat, float* gfullw,
                      float* gfullb, float* gWin, float* gVb, float* gSw,
                      float* gSb, float* gUw, int B, int T, int E, int F,
                      int H, int A, int P, int FS, void* stream) {
  if (B < 1 || T < 1 || A % 4 || FS % 4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lstm)
    return scan_bwd<NicGates>(false, att1, feats, Wcat, fullw, Win, Sw, Uw,
                              coins, hbuf, cbuf, alpha, x, hp, ctx, z, v, s,
                              dh, dalpha, demb, dsamp, dcat, ds, dv, dx, de,
                              dh_c, dc, part, fw_part, gatt1, gWcat, gbcat,
                              gfullw, gfullb, gWin, gVb, gSw, gSb, gUw, B, T,
                              E, F, H, A, P, FS, st);
  return scan_bwd<FactoredGates>(true, att1, feats, Wcat, fullw, Win, Sw, Uw,
                                 coins, hbuf, cbuf, alpha, x, hp, ctx, z, v,
                                 s, dh, dalpha, demb, dsamp, dcat, ds, dv, dx,
                                 de, dh_c, dc, part, fw_part, gatt1, gWcat,
                                 gbcat, gfullw, gfullb, gWin, gVb, gSw, gSb,
                                 gUw, B, T, E, F, H, A, P, FS, st);
}

// tok (n,), rows (n, E) -> dB (V, E), every row written.
int icee_scatter_rows(const int* tok, const float* rows, int n, int E, int V,
                      float* dB, void* stream) {
  if (V < 1 || E < 1 || n < 0) return cudaErrorInvalidValue;
  const int per_block = SC_THREADS / 32;
  scatter_rows_kernel<<<(V + per_block - 1) / per_block, SC_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(tok, rows, n,
                                                             E, V, dB);
  return cudaGetLastError();
}

}  // extern "C"
