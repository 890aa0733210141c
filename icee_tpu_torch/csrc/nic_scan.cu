// K4: the teacher-forced NIC (torch-order LSTM) training scan, forward and
// backward.
//
// Replaces icee_tpu/ops/pallas_nic_train.py::fused_nic_scan (a custom_vjp
// around the Pallas kernels _fwd_kernel :63 and _bwd_kernel :83, calls :173
// and :227): T steps of torch's nn.LSTMCell from zero state, gate order
// [i, f, g, o], z = ((x W_ih + b_ih) + h W_hh) + b_hh (the XLA cell's float
// order), c = f c + i g, h = o tanh(c); the backward returns dx, dW_ih,
// dW_hh and one db that b_ih and b_hh share.
//
// What bounds it on the H100: float32 operations.  At the flagship shapes
// (N = B * T = 64 * 25 = 1600 rows, E = 300, H = 512) the forward is
// 2 N (E + H) 4H = 5.3 GFLOP and the backward about twice that, against
// ~5 MB of weights and ~20 MB of activations: far above the card's
// operations-per-byte line.  37% of the forward's work (x W_ih) and 69% of
// the backward's (dW_ih, dW_hh, dx) are products over all N rows; the rest
// is the recurrence, T steps that each depend on the last.  The TPU kernel
// kept W_ih and W_hh resident in VMEM for all T steps and accumulated dW in
// VMEM across a sequential grid.  What the design does about it (K3's and
// K8's, lstm_scan.cu's header):
//   forward: P = x W_ih + b_ih for all N rows, 3xTF32 wgmma from W_ih's
//     TF32 planes (planes_product.cuh), parked in the gates buffer; then
//     ONE cooperative launch for the recurrence (scan_grid.cuh), z = (P_t +
//     h W_hh) + b_hh and the gates (cell_gates.cuh NicGates), each block's
//     slice of W_hh resident in shared memory as TF32 planes (past that
//     plan's reach, H from ~736 or large B, streamed a pass from device
//     memory), its step products 3xTF32 wgmma;
//   backward: one cooperative launch for the (dh, dc) chain from the saved
//     gates, writing dZ (N, 4H), the recurrent dh = dZ_{t+1} W_hh^T summed
//     over its k ranges in range order; dW_ih = x^T dZ and dW_hh =
//     H_prev^T dZ (h shifted one step, zero at t = 0) on gemm_tf32x3.cuh's
//     3xTF32 mma.sync (both operands as stored); db a fixed-order column
//     sum of dZ (gemm_f32.cuh's colsum); dx = dZ W_ih^T by wgmma from the
//     planes of W_ih^T (W_ih's own rows).
// The forward saves the gate activations, so the backward recomputes
// nothing.  No atomics in any sum: a call gives the same bits on every run.
#include "gemm_f32.cuh"       // colsum
#include "gemm_tf32x3.cuh"    // the 'A' products
#include "planes_product.cuh"
#include "scan_grid.cuh"

using namespace icee;

namespace {

inline long long r16(long long floats) { return (floats + 15) / 16 * 16; }

// The forward's workspace: W_ih's planes, the recurrence's
// (scan_grid.cuh's sg_fwd_ws_floats), the barrier's counter.
struct NicFwdSpace {
  long long pw, grid, count, total;
  NicFwdSpace(const ScanPlan& p, int E, int H) {
    pw = 0;
    grid = pw + r16(sp_planes_floats(E, 4 * H));
    count = grid + r16(sg_fwd_ws_floats(p));
    total = count + 16;
  }
};

// The backward's: W_ih^T's planes, the recurrence's partial sums, the 'A'
// products' partials, the counter; the recurrence's sg_bwd_ws_floats
// after its partial sums.
struct NicBwdSpace {
  long long pwt, part, grid, tc, count, total;
  NicBwdSpace(const ScanPlan& p, int B, int T, int E, int H) {
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
int icee_nic_scan_workspace(const ScanPlan* plan, int B, int T, int E, int H,
                            long long* out) {
  out[0] = NicFwdSpace(*plan, E, H).total;
  out[1] = NicBwdSpace(*plan, B, T, E, H).total;
  return 0;
}

// x (B, T, E); W_ih (E, 4H), b_ih (4H), W_hh (H, 4H), b_hh (4H).  Outputs
// h_seq, c_seq (B, T, H); saved for the backward: gates (N, 4H) = the
// [i, f, g, o] activations.  ws: the forward's workspace
// (icee_nic_scan_workspace), 16-byte aligned.
int icee_nic_scan_fwd(const ScanPlan* plan, const float* x, const float* Wih,
                      const float* bih, const float* Whh, const float* bhh,
                      float* h_seq, float* c_seq, float* gates, float* ws,
                      long long ws_floats, int B, int T, int E, int H,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanPlan& p = *plan;
  ICEE_TRY((cudaError_t)sg_check_plan(p, B, H));
  const NicFwdSpace w(p, E, H);
  if (ws_floats < w.total || !tc_aligned16(ws)) return cudaErrorInvalidValue;
  const int N = B * T, H4 = 4 * H;
  float* pw = ws + w.pw;
  // P = x W_ih + b_ih, parked in gates until each step overwrites it
  ICEE_TRY(sb_prepare(Wih, E, H4, pw, st));
  const float* bias[1] = {bih};
  ICEE_TRY(sb_product(x, E, 0, pw, 0, sp_round_up(E, SP_BK), bias, gates,
                      H4, 0, 0, N, H4, E, 1, 1, st));
  return (int)scan_fwd_grid<NicGates>(
      p, Whh, bhh, gates, h_seq, c_seq,
      reinterpret_cast<unsigned*>(ws + w.count), ws + w.grid, B, T, H, st);
}

// From the forward's saved gates and dh_seq (B, T, H): dx (N, E), dWih
// (E, 4H), dWhh (H, 4H), db (4H).  h_prev (N, H) is h_seq shifted one step
// (zero at t = 0).  Scratch: dZ (N, 4H), 16-byte aligned, and ws, the
// backward's workspace.
int icee_nic_scan_bwd(const ScanPlan* plan, const float* x, const float* Wih,
                      const float* Whh, const float* h_prev,
                      const float* c_seq, const float* gates,
                      const float* dh_seq, float* dx, float* dWih,
                      float* dWhh, float* db, float* dZ, float* ws,
                      long long ws_floats, int B, int T, int E, int H,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanPlan& p = *plan;
  ICEE_TRY((cudaError_t)sg_check_plan(p, B, H));
  const NicBwdSpace w(p, B, T, E, H);
  if (ws_floats < w.total || !tc_aligned16(ws)) return cudaErrorInvalidValue;
  const int N = B * T, H4 = 4 * H;
  float *pwt = ws + w.pwt, *tc = ws + w.tc;
  // the planes of W_ih^T (4H, E): W_ih's own rows
  ICEE_TRY(sb_prepare_strided(Wih, H4, E, 1, H4, 0, 1, pwt, st));
  ICEE_TRY(scan_bwd_grid<NicGates>(
      p, Whh, gates, c_seq, dh_seq, dZ, ws + w.part,
      reinterpret_cast<unsigned*>(ws + w.count), ws + w.grid, B, T, H,
      0.f, st));
  // dW_ih = x^T dZ, dW_hh = h_prev^T dZ, db = sum dZ, dx = dZ W_ih^T
  ICEE_TRY(tf32x3_gemm('A', x, E, dZ, H4, dWih, H4, nullptr, E, H4, N, 1, 0,
                       0, 0, 0, tc, st));
  ICEE_TRY(tf32x3_gemm('A', h_prev, H, dZ, H4, dWhh, H4, nullptr, H, H4, N,
                       1, 0, 0, 0, 0, tc, st));
  ICEE_TRY(colsum(dZ, H4, N, H4, db, 0, st));
  ICEE_TRY(sb_product(dZ, H4, 0, pwt, 0, sp_round_up(H4, SP_BK), nullptr,
                      dx, E, 0, 0, N, E, H4, 1, 1, st));
  return 0;
}

}  // extern "C"
