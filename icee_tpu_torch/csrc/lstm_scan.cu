// K3: the teacher-forced FactoredLSTM training scan, forward and backward.
//
// Replaces icee_tpu/ops/pallas_lstm.py::fused_factored_scan (a custom_vjp
// around the Pallas kernels _fwd_kernel :66 and _bwd_kernel :91): T steps of
// the factored cell from zero state, h = o * c with no tanh, gate order
// [i, f, o, c]; the backward returns dx and the grads of V_w, V_b, the S
// style slice, its bias, U_w, U_b, W_w and W_b.
//
// What bounds it on the H100: float32 operations.  At the flagship shapes
// (N = B * T = 64 * 25 = 1600 rows, E = 300, F = H = 512) the forward is
// 2 N (E 4F + 4F F + 4F H + H 4H) = 12.0 GFLOP and the backward twice that,
// against ~15 MB of weights and ~50 MB of activations: far above the card's
// operations-per-byte line.  72% of the forward's work and 86% of the
// backward's are products over all N rows; the rest is the recurrence,
// T steps that each depend on the last.  The TPU kernel kept every weight
// resident in VMEM for all T steps.  What the design does about it:
//   the products over all rows run on the tensor cores at float32
//     accuracy (3xTF32: each operand split into TF32 hi and lo, three
//     passes, a rounded float32 add a 32-deep k tile).  Where B is a weight
//     ('N': v = x V_w + V_b, s_g = v_g S_g + S_b, u_g = s_g U_g + U_b;
//     'T': ds_g = dz_g U_g^T, dv_g = ds_g S_g^T, dx = dv V_w^T) the call
//     lays the weight out once as TF32 planes and the product is wgmma
//     (planes_product.cuh; the planes of W^T are W's own rows).  The
//     weight grads ('A': dW_w = h_prev^T dZ, dU_g, dS_g, dV_w, each reduced
//     over the N rows) run on gemm_tf32x3.cuh's mma.sync product, which
//     reads both operands as they are stored: TF32 wgmma needs both
//     k-major, and these are m- and n-major, so the wgmma route would
//     first write both activations transposed as planes (dZ alone is 13
//     MB) and would win only if the product ran well above mma.sync's
//     rate at these shapes (measured slower: PERF.md's K3 findings);
//   the recurrence is ONE cooperative launch a direction (scan_grid.cuh)
//     with each block's slice of W_w resident in shared memory as TF32
//     planes (past that plan's reach, H from ~736 or large B, streamed a
//     pass from device memory), one grid barrier a forward step and two a
//     backward step,
//     its step products 3xTF32 wgmma with the gates after them
//     (cell_gates.cuh's FactoredGates); what bounds a step is in
//     scan_grid.cuh's note;
//   the bias grads stay fixed-order column sums (gemm_f32.cuh's colsum).
// What bounds it now (PERF.md's K3 findings): the recurrence, ~60% of the
// forward's device time and ~30% of the backward's, each step streaming
// h_{t-1} or dZ_{t+1} from L2 behind a latency chain (scan_grid.cuh); then
// the products, at 19-43 TFLOP/s float32-equivalent.  The forward saves
// v, s and the gate activations, so the backward recomputes nothing.  No
// atomics in any sum: a call gives the same bits on every run.
#include "gemm_f32.cuh"       // colsum
#include "gemm_tf32x3.cuh"    // the 'A' products
#include "planes_product.cuh"
#include "scan_grid.cuh"

using namespace icee;

namespace {

inline long long r16(long long floats) { return (floats + 15) / 16 * 16; }

// The forward's workspace: the planes of V_w, S (4), U (4), the
// recurrence's (scan_grid.cuh's sg_fwd_ws_floats), then the barrier's
// counter.
struct FwdSpace {
  long long pv, ps, pu, grid, count, total;
  FwdSpace(const ScanPlan& p, int E, int F, int H) {
    pv = 0;
    ps = pv + r16(sp_planes_floats(E, 4 * F));
    pu = ps + r16(4 * sp_planes_floats(F, F));
    grid = pu + r16(4 * sp_planes_floats(F, H));
    count = grid + r16(sg_fwd_ws_floats(p));
    total = count + 16;
  }
};

// The backward's: the planes of U_g^T (4), S_g^T (4), V_w^T, the
// recurrence's partial sums and its sg_bwd_ws_floats, the 'A' products'
// partials, the counter.
struct BwdSpace {
  long long put, pst, pvt, part, grid, tc, count, total;
  BwdSpace(const ScanPlan& p, int B, int T, int E, int F, int H) {
    const int N = B * T;
    long long tcf = tf32x3_part_floats(H, 4 * H, N, 1);
    const long long u = tf32x3_part_floats(F, H, N, 4);
    const long long s = tf32x3_part_floats(F, F, N, 4);
    const long long v = tf32x3_part_floats(E, 4 * F, N, 1);
    tcf = tcf > u ? tcf : u;
    tcf = tcf > s ? tcf : s;
    tcf = tcf > v ? tcf : v;
    put = 0;
    pst = put + r16(4 * sp_planes_floats(H, F));
    pvt = pst + r16(4 * sp_planes_floats(F, F));
    part = pvt + r16(sp_planes_floats(4 * F, E));
    grid = part + r16((long long)p.b_splits * B * H);
    tc = grid + r16(sg_bwd_ws_floats(p));
    count = tc + r16(tcf);
    total = count + 16;
  }
};

}  // namespace

extern "C" {

const char* icee_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Recurrence launches issued by this library so far (scan_grid.cuh).
unsigned long long icee_scan_recurrence_launches() { return sg_launches(); }

// Floats of the forward's and the backward's workspaces -> out[0], out[1].
int icee_lstm_scan_workspace(const ScanPlan* plan, int B, int T, int E,
                             int F, int H, long long* out) {
  out[0] = FwdSpace(*plan, E, F, H).total;
  out[1] = BwdSpace(*plan, B, T, E, F, H).total;
  return 0;
}

// x (B, T, E); weights in the JAX layout with S_w / S_b the style slice
// (4, F, F) / (4, F).  Outputs h_seq, c_seq (B, T, H); saved for the
// backward: v, s (N, 4F) and gates (N, 4H) = [i, f, o, g] activations.
// ws: the forward's workspace (icee_lstm_scan_workspace), 16-byte aligned.
int icee_lstm_scan_fwd(const ScanPlan* plan, const float* x, const float* Vw,
                       const float* Vb, const float* Sw, const float* Sb,
                       const float* Uw, const float* Ub, const float* Ww,
                       const float* Wb, float* h_seq, float* c_seq, float* v,
                       float* s, float* gates, float* ws,
                       long long ws_floats, int B, int T, int E, int F, int H,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanPlan& p = *plan;
  ICEE_TRY((cudaError_t)sg_check_plan(p, B, H));
  const FwdSpace w(p, E, F, H);
  if (ws_floats < w.total || !tc_aligned16(ws)) return cudaErrorInvalidValue;
  const int N = B * T, F4 = 4 * F, H4 = 4 * H;
  float *pv = ws + w.pv, *ps = ws + w.ps, *pu = ws + w.pu;
  ICEE_TRY(sb_prepare(Vw, E, F4, pv, st));
  ICEE_TRY(sb_prepare_strided(Sw, F, F, F, 1, (long long)F * F, 4, ps, st));
  ICEE_TRY(sb_prepare_strided(Uw, F, H, H, 1, (long long)F * H, 4, pu, st));
  // v = x V_w + V_b
  const float* bv[1] = {Vb};
  ICEE_TRY(sb_product(x, E, 0, pv, 0, sp_round_up(E, SP_BK), bv, v, F4, 0,
                      0, N, F4, E, 1, 1, st));
  // s_g = v_g S_g + S_b[g]
  const float* bs[4] = {Sb, Sb + F, Sb + 2 * F, Sb + 3 * F};
  ICEE_TRY(sb_product(v, F4, F, ps, sp_planes_floats(F, F),
                      sp_round_up(F, SP_BK), bs, s, F4, F, 0, N, F, F, 4, 1,
                      st));
  // u_g = s_g U_g + U_b[g], parked in gates until each step overwrites it
  const float* bu[4] = {Ub, Ub + H, Ub + 2 * H, Ub + 3 * H};
  ICEE_TRY(sb_product(s, F4, F, pu, sp_planes_floats(F, H),
                      sp_round_up(F, SP_BK), bu, gates, H4, H, 0, N, H, F,
                      4, 1, st));
  return (int)scan_fwd_grid<FactoredGates>(
      p, Ww, Wb, gates, h_seq, c_seq,
      reinterpret_cast<unsigned*>(ws + w.count), ws + w.grid, B, T, H, st);
}

// From the forward's saved tensors and dh_seq (B, T, H): dx (N, E) and the
// grads dVw (E, 4F), dVb (4F), dSw (4, F, F), dSb (4F), dUw (4, F, H), dUb
// (4H), dWw (H, 4H), dWb (4H).  h_prev (N, H) is h_seq shifted one step
// (zero at t = 0).  Scratch: dZ (N, 4H), dS (N, 4F), dv (N, 4F) and ws,
// the backward's workspace.
int icee_lstm_scan_bwd(const ScanPlan* plan, const float* x, const float* Vw,
                       const float* Sw, const float* Uw, const float* Ww,
                       const float* h_prev, const float* c_seq,
                       const float* v, const float* s, const float* gates,
                       const float* dh_seq, float* dx, float* dVw,
                       float* dVb, float* dSw, float* dSb, float* dUw,
                       float* dUb, float* dWw, float* dWb, float* dZ,
                       float* dS, float* dv, float* ws,
                       long long ws_floats, int B, int T, int E, int F, int H,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanPlan& p = *plan;
  ICEE_TRY((cudaError_t)sg_check_plan(p, B, H));
  const BwdSpace w(p, B, T, E, F, H);
  if (ws_floats < w.total || !tc_aligned16(ws)) return cudaErrorInvalidValue;
  const int N = B * T, F4 = 4 * F, H4 = 4 * H;
  float *put = ws + w.put, *pst = ws + w.pst, *pvt = ws + w.pvt;
  float* tc = ws + w.tc;
  // the planes of U_g^T (H, F), S_g^T (F, F) and V_w^T (4F, E): each
  // weight's own rows
  ICEE_TRY(sb_prepare_strided(Uw, H, F, 1, H, (long long)F * H, 4, put, st));
  ICEE_TRY(sb_prepare_strided(Sw, F, F, 1, F, (long long)F * F, 4, pst, st));
  ICEE_TRY(sb_prepare_strided(Vw, F4, E, 1, F4, 0, 1, pvt, st));
  ICEE_TRY(scan_bwd_grid<FactoredGates>(
      p, Ww, gates, c_seq, dh_seq, dZ, ws + w.part,
      reinterpret_cast<unsigned*>(ws + w.count), ws + w.grid, B, T, H, 0.f,
      st));
  // W branch: dW_w = h_prev^T dZ, dW_b = sum dZ; U branch: dU_b is the
  // same sum
  ICEE_TRY(tf32x3_gemm('A', h_prev, H, dZ, H4, dWw, H4, nullptr, H, H4, N, 1,
                       0, 0, 0, 0, tc, st));
  ICEE_TRY(colsum(dZ, H4, N, H4, dWb, 0, st));
  ICEE_TRY(cudaMemcpyAsync(dUb, dWb, sizeof(float) * H4,
                           cudaMemcpyDeviceToDevice, st));
  // dU_g = s_g^T dz_g
  ICEE_TRY(tf32x3_gemm('A', s, F4, dZ, H4, dUw, H, nullptr, F, H, N, 4, F, H,
                       (long long)F * H, 0, tc, st));
  // ds_g = dz_g U_g^T
  ICEE_TRY(sb_product(dZ, H4, H, put, sp_planes_floats(H, F),
                      sp_round_up(H, SP_BK), nullptr, dS, F4, F, 0, N, F, H,
                      4, 1, st));
  // dS_g = v_g^T ds_g, dS_b = sum ds
  ICEE_TRY(tf32x3_gemm('A', v, F4, dS, F4, dSw, F, nullptr, F, F, N, 4, F, F,
                       (long long)F * F, 0, tc, st));
  ICEE_TRY(colsum(dS, F4, N, F4, dSb, 0, st));
  // dv_g = ds_g S_g^T
  ICEE_TRY(sb_product(dS, F4, F, pst, sp_planes_floats(F, F),
                      sp_round_up(F, SP_BK), nullptr, dv, F4, F, 0, N, F, F,
                      4, 1, st));
  // V branch: dV_w = x^T dv, dV_b = sum dv, dx = dv V_w^T
  ICEE_TRY(tf32x3_gemm('A', x, E, dv, F4, dVw, F4, nullptr, E, F4, N, 1, 0, 0,
                       0, 0, tc, st));
  ICEE_TRY(colsum(dv, F4, N, F4, dVb, 0, st));
  ICEE_TRY(sb_product(dv, F4, 0, pvt, 0, sp_round_up(F4, SP_BK), nullptr,
                      dx, E, 0, 0, N, E, F4, 1, 1, st));
  return 0;
}

// One product over all rows as K3 and K8 run it, alone (tests and
// measurements): 'N' C = A B and 'T' C = A B^T (B a weight, given (K, N)
// or (N, K) rows: its planes are laid out into ws, then the wgmma
// product), 'A' C = A^T B (A given (K, M) rows; gemm_tf32x3.cuh, ws
// holding its partials).  Entry z of the batch: A + z za, B + z zb, C (z,
// M, N) contiguous, bias + z zbias ('N' and 'T' only; null for none).
long long icee_scan_product_ws(char form, int M, int N, int K, int batch) {
  if (form == 'A') return tf32x3_part_floats(M, N, K, batch) + 4;
  return (long long)batch * sp_planes_floats(K, N);
}

int icee_scan_product(char form, const float* A, long long lda,
                      long long za, const float* Bm, long long ldb,
                      long long zb, const float* bias, long long zbias,
                      float* C, int M, int N, int K, int batch, float* ws,
                      long long ws_floats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws_floats < icee_scan_product_ws(form, M, N, K, batch) ||
      !tc_aligned16(ws) || batch < 1 || batch > SP_MAX_BATCH)
    return cudaErrorInvalidValue;
  const long long mn = (long long)M * N;
  if (form == 'A')
    return (int)tf32x3_gemm('A', A, lda, Bm, ldb, C, N, bias, M, N, K, batch,
                            za, zb, mn, zbias, ws, st);
  if (form != 'N' && form != 'T') return cudaErrorInvalidValue;
  ICEE_TRY(form == 'N'
               ? sb_prepare_strided(Bm, K, N, ldb, 1, zb, batch, ws, st)
               : sb_prepare_strided(Bm, K, N, 1, ldb, zb, batch, ws, st));
  const float* bz[SP_MAX_BATCH];
  for (int z = 0; z < batch; ++z) bz[z] = bias ? bias + z * zbias : nullptr;
  return (int)sb_product(A, lda, za, ws, sp_planes_floats(K, N),
                         sp_round_up(K, SP_BK), bias ? bz : nullptr, C, N,
                         mn, 0, M, N, K, batch, 1, st);
}

}  // extern "C"
