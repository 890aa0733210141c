"""K8: the teacher-forced SentiCap mRNN training scan, forward and backward.

Port of ``icee_tpu/ops/pallas_senticap_train.py::fused_senticap_scan``.  The
CUDA kernels are ``csrc/senticap_scan.cu``: ``P = x W_x`` for all B*T rows,
then dW and dx, as products on the tensor cores at float32 accuracy
(3xTF32, ``csrc/planes_product.cuh`` and ``csrc/gemm_tf32x3.cuh``), and the
recurrence as one cooperative launch a direction (``csrc/scan_grid.cuh``,
launch plan ``ops/scan_grid.py::scan_plan``), the backward's recurrent dh
clamped to +-gclip after its whole sum (GradClip on h; the output
cotangent is not clamped).

:func:`fused_senticap_scan` is a ``torch.autograd.Function`` whose forward
is :func:`senticap_scan_fwd` and whose backward is :func:`senticap_scan_bwd`.

Plain versions, beside the kernels: :func:`fused_senticap_scan_plain` (the
scan of ``senticap/model.py::cell`` from zero state, GradClip included, as
``reference_senticap_scan``) and :func:`senticap_scan_bwd_plain` (the
explicit formulas of ``_bwd_kernel``).  Each wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib, scan_grid
from icee_tpu_torch.ops.lstm_scan import _shift

WHAT = "K8 (csrc/senticap_scan.cu)"


def check_scan_inputs(w_lstm: torch.Tensor, x: torch.Tensor
                      ) -> Tuple[int, int, int, int]:
    """Validate w_lstm (E + H, 4H) and x (B, T, E); -> (B, T, E, H)."""
    if x.dim() != 3:
        raise ValueError(f"x: expected (B, T, E), got {tuple(x.shape)}")
    b, t, e = x.shape
    if b < 1 or t < 1:
        raise ValueError(f"x: empty batch or sequence {tuple(x.shape)}")
    if w_lstm.dim() != 2 or w_lstm.shape[1] % 4:
        raise ValueError(f"w_lstm: expected (E + H, 4H), got "
                         f"{tuple(w_lstm.shape)}")
    h = w_lstm.shape[1] // 4
    cuda_lib.check_tensor("w_lstm", w_lstm, (e + h, 4 * h), torch.float32,
                          x.device)
    cuda_lib.check_tensor("x", x, (b, t, e), torch.float32, x.device)
    return b, t, e, h


# --- plain versions -----------------------------------------------------------

def fused_senticap_scan_plain(w_lstm: torch.Tensor, x: torch.Tensor,
                              gclip: float = 5.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan of ``senticap/model.py::cell`` from zero state -> (h_seq, c_seq),
    each (B, T, H); differentiable, with GradClip on h."""
    from icee_tpu_torch.senticap.model import cell

    b, t, _ = x.shape
    params = {"w_lstm": w_lstm}
    h = torch.zeros((b, w_lstm.shape[1] // 4), dtype=x.dtype,
                    device=x.device)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for step in range(t):
        h, c = cell(params, x[:, step], h, c, gclip)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def senticap_scan_bwd_plain(w_lstm: torch.Tensor, x: torch.Tensor,
                            h_seq: torch.Tensor, c_seq: torch.Tensor,
                            dh_seq: torch.Tensor, gclip: float = 5.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``_bwd_kernel`` (``pallas_senticap_train.py:79-137``)
    in tensor ops: recompute the gates from (x, h_prev), chain (dh, dc) in
    reverse time with the recurrent dh clamped to +-gclip, then the weight
    grad over all rows.  -> (dx (B, T, E), dw (E + H, 4H))."""
    b, t, e = x.shape
    hd = w_lstm.shape[1] // 4
    n = b * t
    xf = x.reshape(n, e)
    h_prev = _shift(h_seq).reshape(n, hd)
    c_prev = _shift(c_seq)
    z = (torch.cat([xf, h_prev], dim=1) @ w_lstm).reshape(b, t, 4, hd)
    i_t, f_t = torch.sigmoid(z[:, :, 0]), torch.sigmoid(z[:, :, 1])
    o_t, g_t = torch.sigmoid(z[:, :, 2]), torch.tanh(z[:, :, 3])
    w_h = w_lstm[e:]

    dz = torch.empty((b, t, 4, hd), dtype=x.dtype, device=x.device)
    dh_carry = torch.zeros((b, hd), dtype=x.dtype, device=x.device)
    dc_carry = torch.zeros_like(dh_carry)
    for step in reversed(range(t)):
        i_, f_, o_, g_ = (a[:, step] for a in (i_t, f_t, o_t, g_t))
        dh_total = dh_seq[:, step] + dh_carry
        d_o = dh_total * c_seq[:, step]
        dc = dh_total * o_ + dc_carry
        d_f = dc * c_prev[:, step]
        d_i = dc * g_
        d_g = dc * i_
        dc_carry = dc * f_
        dz[:, step] = torch.stack([d_i * i_ * (1.0 - i_), d_f * f_ * (1.0 - f_),
                                   d_o * o_ * (1.0 - o_), d_g * (1.0 - g_ * g_)],
                                  dim=1)
        # GradClip between h_{s-1} and its use in step s
        dh_carry = (dz[:, step].reshape(b, 4 * hd) @ w_h.T).clamp(-gclip,
                                                                  gclip)
    dzf = dz.reshape(n, 4 * hd)
    dw = torch.cat([xf.T @ dzf, h_prev.T @ dzf], dim=0)
    return (dzf @ w_lstm[:e].T).reshape(b, t, e), dw


# --- kernel wrappers ----------------------------------------------------------

def _workspace(lib, plan, b, t, e, h, direction: int, device):
    """The C side's workspace of one direction (0 forward, 1 backward)
    and its plan struct."""
    cplan = plan.c_struct()
    sizes = (ctypes.c_longlong * 2)()
    lib.icee_senticap_scan_workspace(ctypes.byref(cplan), b, t, e, h,
                                     ctypes.byref(sizes))
    return cplan, torch.empty((sizes[direction],), dtype=torch.float32,
                              device=device)


def senticap_scan_fwd(w_lstm: torch.Tensor, x: torch.Tensor, gclip=5.0
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """K8 forward -> (h_seq, c_seq, gates).  On CUDA, ``gates`` (N, 4H) are
    the [i, f, o, c] activations the kernel backward reads; on the CPU the
    plain scan runs and ``gates`` is None.  ``gclip`` only matters to the
    backward (GradClip is the identity forward)."""
    b, t, e, h = check_scan_inputs(w_lstm, x)
    device = x.device
    if device.type == "cpu":
        h_seq, c_seq = fused_senticap_scan_plain(w_lstm, x, gclip)
        return h_seq, c_seq, None
    if device.type != "cuda":
        raise ValueError(f"senticap_scan_fwd: unsupported device {device}")
    plan = scan_grid.plan_on(WHAT, b, h, device)
    f32 = dict(dtype=torch.float32, device=device)
    h_seq = torch.empty((b, t, h), **f32)
    c_seq = torch.empty((b, t, h), **f32)
    gates = torch.empty((b * t, 4 * h), **f32)
    p = cuda_lib.ptr
    lib = _library()
    cplan, ws = _workspace(lib, plan, b, t, e, h, 0, device)
    rc = lib.icee_senticap_scan_fwd(ctypes.byref(cplan), p(x), p(w_lstm),
                                    p(h_seq), p(c_seq), p(gates), p(ws),
                                    ws.numel(), b, t, e, h,
                                    cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "senticap_scan_fwd")
    senticap_scan_fwd.launches += 1
    return h_seq, c_seq, gates


senticap_scan_fwd.launches = 0  # kernel calls (1 product + 1 recurrence)


def senticap_scan_bwd(w_lstm: torch.Tensor, x: torch.Tensor,
                      h_seq: torch.Tensor, c_seq: torch.Tensor,
                      dh_seq: torch.Tensor, gclip: float = 5.0,
                      gates: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 backward -> (dx (B, T, E), dw (E + H, 4H)).  On CUDA it needs the
    forward's ``gates``; on the CPU the plain backward runs."""
    b, t, e, h = check_scan_inputs(w_lstm, x)
    device = x.device
    for name, ten in (("h_seq", h_seq), ("c_seq", c_seq), ("dh_seq", dh_seq)):
        cuda_lib.check_tensor(name, ten, (b, t, h), torch.float32, device)
    if device.type == "cpu":
        return senticap_scan_bwd_plain(w_lstm, x, h_seq, c_seq, dh_seq, gclip)
    if device.type != "cuda":
        raise ValueError(f"senticap_scan_bwd: unsupported device {device}")
    if gates is None:
        raise ValueError("senticap_scan_bwd: the kernel backward reads the "
                         "forward's saved gates")
    cuda_lib.check_tensor("gates", gates, (b * t, 4 * h), torch.float32,
                          device)
    if w_lstm.data_ptr() % 16:
        raise ValueError("senticap_scan_bwd: w_lstm must be 16-byte aligned")
    plan = scan_grid.plan_on(WHAT, b, h, device)
    f32 = dict(dtype=torch.float32, device=device)
    h_prev = _shift(h_seq)
    dx = torch.empty((b, t, e), **f32)
    dw = torch.empty((e + h, 4 * h), **f32)
    d_z = torch.empty((b * t, 4 * h), **f32)
    p = cuda_lib.ptr
    lib = _library()
    cplan, ws = _workspace(lib, plan, b, t, e, h, 1, device)
    rc = lib.icee_senticap_scan_bwd(
        ctypes.byref(cplan), p(x), p(w_lstm), p(h_prev), p(c_seq), p(gates),
        p(dh_seq), p(dx), p(dw), p(d_z), p(ws), ws.numel(), b, t, e,
        h, float(gclip), cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "senticap_scan_bwd")
    senticap_scan_bwd.launches += 1
    return dx, dw


senticap_scan_bwd.launches = 0  # kernel calls (1 recurrence + 3 products)


class _FusedSenticapScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_lstm, x, gclip):
        h_seq, c_seq, gates = senticap_scan_fwd(w_lstm, x, gclip)
        ctx.gclip = float(gclip)
        ctx.has_gates = gates is not None
        ctx.save_for_backward(w_lstm, x, h_seq, c_seq,
                              *((gates,) if ctx.has_gates else ()))
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        w_lstm, x, h_seq, c_seq, *rest = ctx.saved_tensors
        dx, dw = senticap_scan_bwd(w_lstm, x, h_seq, c_seq,
                                   dh_seq.contiguous(), ctx.gclip,
                                   rest[0] if ctx.has_gates else None)
        return dw, dx, None


def fused_senticap_scan(w_lstm: torch.Tensor, x_seq: torch.Tensor,
                        gclip: float = 5.0) -> torch.Tensor:
    """Teacher-forced SentiCap chain from zero state -> h_seq (B, T, H),
    differentiable in ``w_lstm`` (E + H, 4H, no bias) and ``x_seq`` (B, T, E:
    the step inputs with the visual pseudo-word and any input dropout
    applied).  Matches scanning ``senticap/model.py::cell``, GradClip on h
    included."""
    return _FusedSenticapScan.apply(w_lstm, x_seq, gclip)


def _library() -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    return cuda_lib.library("senticap_scan", {
        "icee_senticap_scan_workspace": ([vp] + [i] * 4 + [vp], i),
        "icee_senticap_scan_fwd": ([vp] * 7 + [ll] + [i] * 4 + [vp], i),
        "icee_senticap_scan_bwd": ([vp] * 11 + [ll] + [i] * 4 + [f, vp], i)})
