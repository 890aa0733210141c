"""K3: the teacher-forced FactoredLSTM training scan, forward and backward.

Port of ``icee_tpu/ops/pallas_lstm.py::fused_factored_scan``.  The CUDA
kernels are ``csrc/lstm_scan.cu``: the input side (V -> S -> U for all B*T
rows), the backward's dx chain and the weight grads as products over all
rows on the tensor cores at float32 accuracy (3xTF32: ``wgmma`` from the
weights' TF32 planes, ``csrc/planes_product.cuh``; ``mma.sync`` for the
weight grads, ``csrc/gemm_tf32x3.cuh``), and the recurrence as one
cooperative launch a direction (``csrc/scan_grid.cuh``) whose launch plan
is ``ops/scan_grid.py::scan_plan``.

:func:`fused_factored_scan` is a ``torch.autograd.Function`` whose forward
is :func:`factored_scan_fwd` and whose backward is :func:`factored_scan_bwd`.
The style slice of S is cut by the caller (``params["S_w"][style]``), so
autograd scatters its grad into the stacked (styles, 4, F, F) tensor, as
the JAX package does outside its ``custom_vjp``.

Plain versions, beside the kernels: :func:`fused_factored_scan_plain` (the
scan of ``ops/cells.py::factored_lstm_cell``, as ``reference_scan``) and
:func:`factored_scan_bwd_plain` (the explicit formulas of ``_bwd_kernel``).
Each wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib, scan_grid
from icee_tpu_torch.ops.cells import factored_lstm_cell

CELL_KEYS = ("V_w", "V_b", "S_w", "S_b", "U_w", "U_b", "W_w", "W_b")


def check_scan_inputs(params: dict, x: torch.Tensor) -> Tuple[int, ...]:
    """Validate the cell tensors (S already the style slice) and x
    (B, T, E); -> (B, T, E, F, H)."""
    device = x.device
    if x.dim() != 3:
        raise ValueError(f"x: expected (B, T, E), got {tuple(x.shape)}")
    b, t, e = x.shape
    if b < 1 or t < 1:
        raise ValueError(f"x: empty batch or sequence {tuple(x.shape)}")
    f4 = params["V_w"].shape[1]
    f, h = f4 // 4, params["W_w"].shape[0]
    shapes = {"V_w": (e, 4 * f), "V_b": (4, f), "S_w": (4, f, f),
              "S_b": (4, f), "U_w": (4, f, h), "U_b": (4, h),
              "W_w": (h, 4 * h), "W_b": (4, h)}
    for name, shape in shapes.items():
        cuda_lib.check_tensor(name, params[name], shape, torch.float32,
                              device)
    cuda_lib.check_tensor("x", x, (b, t, e), torch.float32, device)
    return b, t, e, f, h


# --- plain versions -----------------------------------------------------------

def fused_factored_scan_plain(params: dict, x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan of the factored cell from zero state -> (h_seq, c_seq), each
    (B, T, H); ``params`` carry the S style slice."""
    b, t, _ = x.shape
    h_dim = params["W_w"].shape[0]
    full = dict(params, S_w=params["S_w"][None], S_b=params["S_b"][None])
    h = torch.zeros((b, h_dim), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for step in range(t):
        h, c = factored_lstm_cell(full, x[:, step], h, c, 0)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def _shift(seq: torch.Tensor) -> torch.Tensor:
    """(B, T, H) -> the previous step's values, zero at t = 0."""
    return torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], dim=1)


def factored_scan_bwd_plain(params: dict, x: torch.Tensor,
                            h_seq: torch.Tensor, c_seq: torch.Tensor,
                            dh_seq: torch.Tensor
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The backward of ``_bwd_kernel`` (``pallas_lstm.py:91-178``) in tensor
    ops: recompute the gates from (x, h_prev), chain (dh, dc) in reverse
    time, then every weight grad over all rows.  -> (dx, grads by name)."""
    b, t, e = x.shape
    f = params["U_w"].shape[1]
    hd = params["W_w"].shape[0]
    n = b * t
    xf = x.reshape(n, e)
    v = (xf @ params["V_w"]).reshape(n, 4, f) + params["V_b"]
    s = torch.einsum("ngf,gfk->ngk", v, params["S_w"]) + params["S_b"]
    u = torch.einsum("ngf,gfh->ngh", s, params["U_w"]) + params["U_b"]
    h_prev = _shift(h_seq).reshape(n, hd)
    c_prev = _shift(c_seq)
    z = u + ((h_prev @ params["W_w"]).reshape(n, 4, hd) + params["W_b"])
    z = z.reshape(b, t, 4, hd)
    i_t, f_t, o_t = (torch.sigmoid(z[:, :, q]) for q in range(3))
    g_t = torch.tanh(z[:, :, 3])

    dz = torch.empty((b, t, 4, hd), dtype=x.dtype, device=x.device)
    dh_carry = torch.zeros((b, hd), dtype=x.dtype, device=x.device)
    dc_carry = torch.zeros_like(dh_carry)
    for step in reversed(range(t)):
        dh_total = dh_seq[:, step] + dh_carry
        d_o = dh_total * c_seq[:, step]
        dc = dh_total * o_t[:, step] + dc_carry
        d_f = dc * c_prev[:, step]
        d_i = dc * g_t[:, step]
        d_g = dc * i_t[:, step]
        dc_carry = dc * f_t[:, step]
        i_, f_, o_, g_ = (a[:, step] for a in (i_t, f_t, o_t, g_t))
        dz[:, step] = torch.stack([d_i * i_ * (1.0 - i_), d_f * f_ * (1.0 - f_),
                                   d_o * o_ * (1.0 - o_), d_g * (1.0 - g_ * g_)],
                                  dim=1)
        dh_carry = dz[:, step].reshape(b, 4 * hd) @ params["W_w"].T
    dzf = dz.reshape(n, 4, hd)
    ds = torch.einsum("ngh,gfh->ngf", dzf, params["U_w"])
    dv = torch.einsum("ngk,gfk->ngf", ds, params["S_w"])
    grads = {
        "W_w": h_prev.T @ dzf.reshape(n, 4 * hd),
        "W_b": dzf.sum(0),
        "U_w": torch.einsum("ngf,ngh->gfh", s, dzf),
        "U_b": dzf.sum(0),
        "S_w": torch.einsum("ngf,ngk->gfk", v, ds),
        "S_b": ds.sum(0),
        "V_w": xf.T @ dv.reshape(n, 4 * f),
        "V_b": dv.sum(0),
    }
    dx = (dv.reshape(n, 4 * f) @ params["V_w"].T).reshape(b, t, e)
    return dx, grads


# --- kernel wrappers ----------------------------------------------------------

Saved = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # v, s, gates
WHAT = "K3 (csrc/lstm_scan.cu)"


def _workspace(lib, plan, b, t, e, f, h, direction: int, device):
    """The C side's workspace of one direction (0 forward, 1 backward)
    and its plan struct (``scan_grid.workspace``: asked once a shape)."""
    return scan_grid.workspace(lib.icee_lstm_scan_workspace, plan,
                               (b, t, e, f, h), direction, device)


def factored_scan_fwd(params: dict, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Saved]]:
    """K3 forward -> (h_seq, c_seq, saved).  On CUDA, ``saved`` holds what
    the kernel backward reads (v, s (N, 4F); gate activations (N, 4H));
    on the CPU the plain scan runs and ``saved`` is None."""
    b, t, e, f, h = check_scan_inputs(params, x)
    device = x.device
    if device.type == "cpu":
        h_seq, c_seq = fused_factored_scan_plain(params, x)
        return h_seq, c_seq, None
    if device.type != "cuda":
        raise ValueError(f"factored_scan_fwd: unsupported device {device}")
    plan = scan_grid.plan_on(WHAT, b, h, device)
    n = b * t
    f32 = dict(dtype=torch.float32, device=device)
    h_seq = torch.empty((b, t, h), **f32)
    c_seq = torch.empty((b, t, h), **f32)
    v = torch.empty((n, 4 * f), **f32)
    s = torch.empty((n, 4 * f), **f32)
    gates = torch.empty((n, 4 * h), **f32)
    p = cuda_lib.ptr
    lib = _library()
    cplan, ws = _workspace(lib, plan, b, t, e, f, h, 0, device)
    rc = lib.icee_lstm_scan_fwd(
        ctypes.byref(cplan), p(x), *(p(params[k]) for k in CELL_KEYS),
        p(h_seq), p(c_seq), p(v), p(s), p(gates), p(ws), ws.numel(), b, t, e,
        f, h, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "factored_scan_fwd")
    factored_scan_fwd.launches += 1
    return h_seq, c_seq, (v, s, gates)


factored_scan_fwd.launches = 0  # kernel calls (3 products + 1 recurrence)


def factored_scan_bwd(params: dict, x: torch.Tensor, h_seq: torch.Tensor,
                      c_seq: torch.Tensor, dh_seq: torch.Tensor,
                      saved: Optional[Saved] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K3 backward -> (dx (B, T, E), grads by name).  On CUDA it needs the
    forward's ``saved`` tensors; on the CPU the plain backward runs."""
    b, t, e, f, h = check_scan_inputs(params, x)
    device = x.device
    for name, ten in (("h_seq", h_seq), ("c_seq", c_seq), ("dh_seq", dh_seq)):
        cuda_lib.check_tensor(name, ten, (b, t, h), torch.float32, device)
    if device.type == "cpu":
        return factored_scan_bwd_plain(params, x, h_seq, c_seq, dh_seq)
    if device.type != "cuda":
        raise ValueError(f"factored_scan_bwd: unsupported device {device}")
    if saved is None:
        raise ValueError("factored_scan_bwd: the kernel backward reads the "
                         "forward's saved (v, s, gates)")
    if params["W_w"].data_ptr() % 16:
        raise ValueError("factored_scan_bwd: W_w must be 16-byte aligned")
    plan = scan_grid.plan_on(WHAT, b, h, device)
    n = b * t
    v, s, gates = saved
    cuda_lib.check_tensor("v", v, (n, 4 * f), torch.float32, device)
    cuda_lib.check_tensor("s", s, (n, 4 * f), torch.float32, device)
    cuda_lib.check_tensor("gates", gates, (n, 4 * h), torch.float32, device)
    f32 = dict(dtype=torch.float32, device=device)
    h_prev = _shift(h_seq)
    dx = torch.empty((b, t, e), **f32)
    grads = {k: torch.empty(tuple(params[k].shape), **f32) for k in CELL_KEYS}
    d_z = torch.empty((n, 4 * h), **f32)
    d_s = torch.empty((n, 4 * f), **f32)
    d_v = torch.empty((n, 4 * f), **f32)
    p = cuda_lib.ptr
    lib = _library()
    cplan, ws = _workspace(lib, plan, b, t, e, f, h, 1, device)
    rc = lib.icee_lstm_scan_bwd(
        ctypes.byref(cplan), p(x), p(params["V_w"]), p(params["S_w"]),
        p(params["U_w"]), p(params["W_w"]), p(h_prev), p(c_seq), p(v), p(s),
        p(gates), p(dh_seq), p(dx), *(p(grads[k]) for k in CELL_KEYS),
        p(d_z), p(d_s), p(d_v), p(ws), ws.numel(), b, t, e, f, h,
        cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "factored_scan_bwd")
    factored_scan_bwd.launches += 1
    return dx, grads


factored_scan_bwd.launches = 0  # kernel calls (1 recurrence, 7 products, sums)


class _FusedScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *weights):
        params = dict(zip(CELL_KEYS, weights))
        h_seq, c_seq, saved = factored_scan_fwd(params, x)
        ctx.n_saved = 0 if saved is None else len(saved)
        ctx.save_for_backward(x, h_seq, c_seq, *weights, *(saved or ()))
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        x, h_seq, c_seq, *rest = ctx.saved_tensors
        weights, saved = rest[:len(CELL_KEYS)], rest[len(CELL_KEYS):]
        params = dict(zip(CELL_KEYS, weights))
        dx, grads = factored_scan_bwd(params, x, h_seq, c_seq,
                                      dh_seq.contiguous(),
                                      tuple(saved) if ctx.n_saved else None)
        return (dx, *(grads[k] for k in CELL_KEYS))


def fused_factored_scan(params: dict, x_seq: torch.Tensor) -> torch.Tensor:
    """Teacher-forced FactoredLSTM chain -> h_seq (B, T, H), differentiable
    in x_seq and every cell tensor.  ``params``: V/S/U/W weights with S the
    selected style slice (4, F, F) / (4, F).  Matches scanning
    ``factored_lstm_cell`` from zero state."""
    return _FusedScan.apply(x_seq, *(params[k] for k in CELL_KEYS))


def _library() -> ctypes.CDLL:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_lib.library("lstm_scan", {
        "icee_lstm_scan_workspace": ([vp] + [i] * 5 + [vp], i),
        "icee_lstm_scan_fwd": ([vp] * 16 + [ll] + [i] * 5 + [vp], i),
        "icee_lstm_scan_bwd": ([vp] * 25 + [ll] + [i] * 5 + [vp], i),
        "icee_scan_product_ws": ([i] * 5, ll),
        "icee_scan_product": ([i, vp, ll, ll, vp, ll, ll, vp, ll, vp]
                              + [i] * 4 + [vp, ll, vp], i),
        "icee_scan_recurrence_launches": ([], ctypes.c_ulonglong)})
