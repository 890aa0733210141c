// K8: the teacher-forced SentiCap mRNN training scan, forward and backward.
//
// Replaces icee_tpu/ops/pallas_senticap_train.py::fused_senticap_scan (a
// custom_vjp around the Pallas kernels _fwd_kernel :61 and _bwd_kernel :79,
// calls :173 and :224): T steps of the SentiCap cell (mrnn.py:404-440) from
// zero state, z = [x; h] @ w_lstm with no bias, gate order [i, f, o, c],
// c = f c + i g, h = o c (no tanh); the backward returns dx and dW, and
// clamps the gradient flowing into h_{t-1} THROUGH THE CELL to +-gclip
// (the reference's GradClip on h), not the output cotangent.
//
// What bounds it on the H100: float32 operations.  At the training shape
// (N = B * T = 128 * 22 = 2816 rows, E = H = 512) the forward is
// 2 N (E + H) 4H = 11.8 GFLOP and the backward twice that, against ~8 MB of
// weights and ~20 MB of activations.  Half the forward's work (x W_x) and
// three quarters of the backward's (dW and dx) are products over all N
// rows; the rest is the recurrence.  The TPU kernel kept w_lstm resident
// in VMEM across a sequential grid and accumulated dW there.  What the
// design does about it (K3's, lstm_scan.cu's header):
//   forward: P = x W_x (W_x = w_lstm[:E]) for all N rows, 3xTF32 wgmma
//     from W_x's planes (planes_product.cuh), parked in the gates buffer;
//     then ONE cooperative launch for the recurrence (scan_grid.cuh),
//     z = P_t + h W_h and the gates (cell_gates.cuh SentiGates), each
//     block's slice of W_h resident in shared memory as TF32 planes (past
//     that plan's reach, H from ~736 or large B, streamed a pass from
//     device memory), its step products 3xTF32 wgmma;
//   backward: one cooperative launch for the (dh, dc) chain from the
//     saved gates, writing dZ (N, 4H), the recurrent dh = dZ_{t+1} W_h^T
//     summed over its k ranges in range order and THEN clamped; dW[:E] =
//     x^T dZ and dW[E:] = H_prev^T dZ (h shifted one step, zero at t = 0)
//     on gemm_tf32x3.cuh's 3xTF32 mma.sync (both operands as stored: the
//     wgmma route would first write x, h_prev and dZ (23 MB) transposed),
//     and dx = dZ W_x^T by wgmma from the planes of W_x^T (its own rows).
// What bounds it now (PERF.md's K8 findings): the recurrence, ~75% of the
// forward's device time and ~50% of the backward's (scan_grid.cuh's note),
// then the products at 44-51 TFLOP/s.  The input side is summed before the
// recurrent side (the TPU kernel sums one [x; h] dot in k order): a
// rounding-level difference.  No atomics in any sum: a call gives the same
// bits on every run.
#include "gemm_tf32x3.cuh"    // the 'A' products
#include "planes_product.cuh"
#include "scan_grid.cuh"

using namespace icee;

namespace {

inline long long r16(long long floats) { return (floats + 15) / 16 * 16; }

// The forward's workspace: W_x's planes, the recurrence's
// (scan_grid.cuh's sg_fwd_ws_floats), the barrier's counter.
struct FwdSpace {
  long long pw, grid, count, total;
  FwdSpace(const ScanPlan& p, int E, int H) {
    pw = 0;
    grid = pw + r16(sp_planes_floats(E, 4 * H));
    count = grid + r16(sg_fwd_ws_floats(p));
    total = count + 16;
  }
};

// The backward's: W_x^T's planes, the recurrence's partial sums, the 'A'
// products' partials, the counter; the recurrence's sg_bwd_ws_floats
// after its partial sums.
struct BwdSpace {
  long long pwt, part, grid, tc, count, total;
  BwdSpace(const ScanPlan& p, int B, int T, int E, int H) {
    const int N = B * T;
    const long long a = tf32x3_part_floats(E, 4 * H, N, 1);
    const long long b = tf32x3_part_floats(H, 4 * H, N, 1);
    pwt = 0;
    part = pwt + r16(sp_planes_floats(4 * H, E));
    grid = part + r16((long long)p.b_splits * B * H);
    tc = grid + r16(sg_bwd_ws_floats(p));
    count = tc + r16(a > b ? a : b);
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
int icee_senticap_scan_workspace(const ScanPlan* plan, int B, int T, int E,
                                 int H, long long* out) {
  out[0] = FwdSpace(*plan, E, H).total;
  out[1] = BwdSpace(*plan, B, T, E, H).total;
  return 0;
}

// x (B, T, E); W (E + H, 4H).  Outputs h_seq, c_seq (B, T, H); saved for
// the backward: gates (N, 4H) = the [i, f, o, c] activations.  ws: the
// forward's workspace (icee_senticap_scan_workspace), 16-byte aligned.
int icee_senticap_scan_fwd(const ScanPlan* plan, const float* x,
                           const float* W, float* h_seq, float* c_seq,
                           float* gates, float* ws, long long ws_floats,
                           int B, int T, int E, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanPlan& p = *plan;
  ICEE_TRY((cudaError_t)sg_check_plan(p, B, H));
  const FwdSpace w(p, E, H);
  if (ws_floats < w.total || !tc_aligned16(ws)) return cudaErrorInvalidValue;
  const int N = B * T, H4 = 4 * H;
  float* pw = ws + w.pw;
  // P = x W_x, parked in gates until each step overwrites it
  ICEE_TRY(sb_prepare(W, E, H4, pw, st));
  ICEE_TRY(sb_product(x, E, 0, pw, 0, sp_round_up(E, SP_BK), nullptr,
                      gates, H4, 0, 0, N, H4, E, 1, 1, st));
  return (int)scan_fwd_grid<SentiGates>(
      p, W + (long long)E * H4, nullptr, gates, h_seq, c_seq,
      reinterpret_cast<unsigned*>(ws + w.count), ws + w.grid, B, T, H, st);
}

// From the forward's saved gates and dh_seq (B, T, H): dx (N, E) and dW
// (E + H, 4H).  h_prev (N, H) is h_seq shifted one step (zero at t = 0).
// Scratch: dZ (N, 4H) and ws, the backward's workspace.
int icee_senticap_scan_bwd(const ScanPlan* plan, const float* x,
                           const float* W, const float* h_prev,
                           const float* c_seq, const float* gates,
                           const float* dh_seq, float* dx, float* dW,
                           float* dZ, float* ws,
                           long long ws_floats, int B, int T, int E, int H,
                           float gclip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanPlan& p = *plan;
  ICEE_TRY((cudaError_t)sg_check_plan(p, B, H));
  const BwdSpace w(p, B, T, E, H);
  if (ws_floats < w.total || !tc_aligned16(ws)) return cudaErrorInvalidValue;
  const int N = B * T, H4 = 4 * H;
  float *pwt = ws + w.pwt, *tc = ws + w.tc;
  // the planes of W_x^T (4H, E): W_x's own rows
  ICEE_TRY(sb_prepare_strided(W, H4, E, 1, H4, 0, 1, pwt, st));
  ICEE_TRY(scan_bwd_grid<SentiGates>(
      p, W + (long long)E * H4, gates, c_seq, dh_seq, dZ, ws + w.part,
      reinterpret_cast<unsigned*>(ws + w.count), ws + w.grid, B, T, H,
      gclip, st));
  // dW[:E] = x^T dZ, dW[E:] = h_prev^T dZ, dx = dZ W_x^T
  ICEE_TRY(tf32x3_gemm('A', x, E, dZ, H4, dW, H4, nullptr, E, H4, N, 1, 0, 0,
                       0, 0, tc, st));
  ICEE_TRY(tf32x3_gemm('A', h_prev, H, dZ, H4, dW + (long long)E * H4, H4,
                       nullptr, H, H4, N, 1, 0, 0, 0, 0, tc, st));
  ICEE_TRY(sb_product(dZ, H4, 0, pwt, 0, sp_round_up(H4, SP_BK), nullptr,
                      dx, E, 0, 0, N, E, H4, 1, 1, st));
  return 0;
}

}  // extern "C"
