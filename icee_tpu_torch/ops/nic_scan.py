"""K4: the teacher-forced NIC (torch-order LSTM) training scan, forward and
backward.

Port of ``icee_tpu/ops/pallas_nic_train.py::fused_nic_scan``.  The CUDA
kernels are ``csrc/nic_scan.cu``, on K3's and K8's design: ``P = x W_ih +
b_ih`` for all B*T rows, then dW_ih, dW_hh and dx, as products on the
tensor cores at float32 accuracy (3xTF32: ``wgmma`` from the weight's TF32
planes, ``csrc/planes_product.cuh``; ``mma.sync`` for the weight grads,
``csrc/gemm_tf32x3.cuh``), db as a fixed-order column sum, and the
recurrence as one cooperative launch a direction (``csrc/scan_grid.cuh``
with the ``NicGates`` policy of ``csrc/cell_gates.cuh``) whose launch plan
is ``ops/scan_grid.py::scan_plan``: W_hh's slices resident in shared
memory up to H ~ 704, streamed from device memory past it, every B and
every H up to 2048.  A shape with no plan (H past 2048 where no resident
partition fits) raises, naming K4.

:func:`fused_nic_scan` is a ``torch.autograd.Function`` whose forward is
:func:`nic_scan_fwd` and whose backward is :func:`nic_scan_bwd`; ``b_ih``
and ``b_hh`` receive the same gradient, as in the JAX ``custom_vjp``.

Plain versions, beside the kernels: :func:`fused_nic_scan_plain` (the scan
of ``ops/cells.py::lstm_cell`` from zero state, as ``reference_nic_scan``)
and :func:`nic_scan_bwd_plain` (the explicit formulas of ``_bwd_kernel``);
the kernels' own arithmetic is ``scan_grid.nic_scan_tc_plain`` and
``nic_scan_bwd_tc_plain``.  Each wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib, scan_grid
from icee_tpu_torch.ops.cells import lstm_cell
from icee_tpu_torch.ops.lstm_scan import _shift

CELL_KEYS = ("W_ih", "W_hh", "b_ih", "b_hh")
WHAT = "K4 (csrc/nic_scan.cu)"


def check_scan_inputs(cell: dict, x: torch.Tensor) -> Tuple[int, int, int,
                                                             int]:
    """Validate the cell tensors and x (B, T, E); -> (B, T, E, H)."""
    if x.dim() != 3:
        raise ValueError(f"x: expected (B, T, E), got {tuple(x.shape)}")
    b, t, e = x.shape
    if b < 1 or t < 1:
        raise ValueError(f"x: empty batch or sequence {tuple(x.shape)}")
    h = cell["W_hh"].shape[0]
    shapes = {"W_ih": (e, 4 * h), "W_hh": (h, 4 * h), "b_ih": (4 * h,),
              "b_hh": (4 * h,)}
    for name, shape in shapes.items():
        cuda_lib.check_tensor(name, cell[name], shape, torch.float32,
                              x.device)
    cuda_lib.check_tensor("x", x, (b, t, e), torch.float32, x.device)
    return b, t, e, h


# --- plain versions -----------------------------------------------------------

def fused_nic_scan_plain(cell: dict, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan of ``lstm_cell`` from zero state -> (h_seq, c_seq), each
    (B, T, H)."""
    b, t, _ = x.shape
    h = torch.zeros((b, cell["W_hh"].shape[0]), dtype=x.dtype,
                    device=x.device)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for step in range(t):
        h, c = lstm_cell(cell, x[:, step], h, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def nic_scan_bwd_plain(cell: dict, x: torch.Tensor, h_seq: torch.Tensor,
                       c_seq: torch.Tensor, dh_seq: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The backward of ``_bwd_kernel`` (``pallas_nic_train.py:83-135``) in
    tensor ops: recompute the gates from (x, h_prev), chain (dh, dc) in
    reverse time, then the weight grads over all rows.  -> (dx, grads by
    name; ``b_ih`` and ``b_hh`` get the same db)."""
    b, t, e = x.shape
    hd = cell["W_hh"].shape[0]
    n = b * t
    xf = x.reshape(n, e)
    h_prev = _shift(h_seq).reshape(n, hd)
    c_prev = _shift(c_seq)
    z = xf @ cell["W_ih"] + cell["b_ih"] + h_prev @ cell["W_hh"] \
        + cell["b_hh"]
    z = z.reshape(b, t, 4, hd)
    i_t, f_t = torch.sigmoid(z[:, :, 0]), torch.sigmoid(z[:, :, 1])
    g_t, o_t = torch.tanh(z[:, :, 2]), torch.sigmoid(z[:, :, 3])

    dz = torch.empty((b, t, 4, hd), dtype=x.dtype, device=x.device)
    dh_carry = torch.zeros((b, hd), dtype=x.dtype, device=x.device)
    dc_carry = torch.zeros_like(dh_carry)
    for step in reversed(range(t)):
        i_, f_, g_, o_ = (a[:, step] for a in (i_t, f_t, g_t, o_t))
        tanh_c = torch.tanh(c_seq[:, step])
        dh_total = dh_seq[:, step] + dh_carry
        d_o = dh_total * tanh_c
        dc = dh_total * o_ * (1.0 - tanh_c * tanh_c) + dc_carry
        d_i = dc * g_
        d_f = dc * c_prev[:, step]
        d_g = dc * i_
        dc_carry = dc * f_
        dz[:, step] = torch.stack([d_i * i_ * (1.0 - i_), d_f * f_ * (1.0 - f_),
                                   d_g * (1.0 - g_ * g_), d_o * o_ * (1.0 - o_)],
                                  dim=1)
        dh_carry = dz[:, step].reshape(b, 4 * hd) @ cell["W_hh"].T
    dzf = dz.reshape(n, 4 * hd)
    db = dzf.sum(0)
    grads = {"W_ih": xf.T @ dzf, "W_hh": h_prev.T @ dzf, "b_ih": db,
             "b_hh": db.clone()}
    return (dzf @ cell["W_ih"].T).reshape(b, t, e), grads


# --- kernel wrappers ----------------------------------------------------------

def _workspace(lib, plan, b, t, e, h, direction: int, device):
    """The C side's workspace of one direction (0 forward, 1 backward)
    and its plan struct (``scan_grid.workspace``: asked once a shape)."""
    return scan_grid.workspace(lib.icee_nic_scan_workspace, plan,
                               (b, t, e, h), direction, device)


def nic_scan_fwd(cell: dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K4 forward -> (h_seq, c_seq, gates).  On CUDA, ``gates`` (N, 4H) are
    the [i, f, g, o] activations the kernel backward reads; on the CPU the
    plain scan runs and ``gates`` is None."""
    b, t, e, h = check_scan_inputs(cell, x)
    device = x.device
    if device.type == "cpu":
        h_seq, c_seq = fused_nic_scan_plain(cell, x)
        return h_seq, c_seq, None
    if device.type != "cuda":
        raise ValueError(f"nic_scan_fwd: unsupported device {device}")
    plan = scan_grid.plan_on(WHAT, b, h, device)
    f32 = dict(dtype=torch.float32, device=device)
    h_seq = torch.empty((b, t, h), **f32)
    c_seq = torch.empty((b, t, h), **f32)
    gates = torch.empty((b * t, 4 * h), **f32)
    p = cuda_lib.ptr
    lib = _library()
    cplan, ws = _workspace(lib, plan, b, t, e, h, 0, device)
    rc = lib.icee_nic_scan_fwd(
        ctypes.byref(cplan), p(x), p(cell["W_ih"]), p(cell["b_ih"]),
        p(cell["W_hh"]), p(cell["b_hh"]), p(h_seq), p(c_seq), p(gates),
        p(ws), ws.numel(), b, t, e, h, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "nic_scan_fwd")
    nic_scan_fwd.launches += 1
    return h_seq, c_seq, gates


nic_scan_fwd.launches = 0  # kernel calls (1 product + 1 recurrence)


def nic_scan_bwd(cell: dict, x: torch.Tensor, h_seq: torch.Tensor,
                 c_seq: torch.Tensor, dh_seq: torch.Tensor,
                 gates: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """K4 backward -> (dx (B, T, E), grads by name; ``b_ih`` and ``b_hh``
    equal).  On CUDA it needs the forward's ``gates``; on the CPU the plain
    backward runs."""
    b, t, e, h = check_scan_inputs(cell, x)
    device = x.device
    for name, ten in (("h_seq", h_seq), ("c_seq", c_seq), ("dh_seq", dh_seq)):
        cuda_lib.check_tensor(name, ten, (b, t, h), torch.float32, device)
    if device.type == "cpu":
        return nic_scan_bwd_plain(cell, x, h_seq, c_seq, dh_seq)
    if device.type != "cuda":
        raise ValueError(f"nic_scan_bwd: unsupported device {device}")
    if gates is None:
        raise ValueError("nic_scan_bwd: the kernel backward reads the "
                         "forward's saved gates")
    cuda_lib.check_tensor("gates", gates, (b * t, 4 * h), torch.float32,
                          device)
    if cell["W_hh"].data_ptr() % 16:
        raise ValueError("nic_scan_bwd: W_hh must be 16-byte aligned")
    plan = scan_grid.plan_on(WHAT, b, h, device)
    f32 = dict(dtype=torch.float32, device=device)
    h_prev = _shift(h_seq)
    dx = torch.empty((b, t, e), **f32)
    d_wih = torch.empty((e, 4 * h), **f32)
    d_whh = torch.empty((h, 4 * h), **f32)
    db = torch.empty((4 * h,), **f32)
    d_z = torch.empty((b * t, 4 * h), **f32)
    p = cuda_lib.ptr
    lib = _library()
    cplan, ws = _workspace(lib, plan, b, t, e, h, 1, device)
    rc = lib.icee_nic_scan_bwd(
        ctypes.byref(cplan), p(x), p(cell["W_ih"]), p(cell["W_hh"]),
        p(h_prev), p(c_seq), p(gates), p(dh_seq), p(dx), p(d_wih), p(d_whh),
        p(db), p(d_z), p(ws), ws.numel(), b, t, e, h,
        cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "nic_scan_bwd")
    nic_scan_bwd.launches += 1
    return dx, {"W_ih": d_wih, "W_hh": d_whh, "b_ih": db, "b_hh": db.clone()}


nic_scan_bwd.launches = 0  # kernel calls (1 recurrence, 3 products, a sum)


class _FusedNicScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *weights):
        cell = dict(zip(CELL_KEYS, weights))
        h_seq, c_seq, gates = nic_scan_fwd(cell, x)
        ctx.has_gates = gates is not None
        ctx.save_for_backward(x, h_seq, c_seq, *weights,
                              *((gates,) if ctx.has_gates else ()))
        return h_seq

    @staticmethod
    def backward(ctx, dh_seq):
        x, h_seq, c_seq, *rest = ctx.saved_tensors
        cell = dict(zip(CELL_KEYS, rest[:len(CELL_KEYS)]))
        gates = rest[len(CELL_KEYS)] if ctx.has_gates else None
        dx, grads = nic_scan_bwd(cell, x, h_seq, c_seq, dh_seq.contiguous(),
                                 gates)
        return (dx, *(grads[k] for k in CELL_KEYS))


def fused_nic_scan(cell: dict, x_seq: torch.Tensor) -> torch.Tensor:
    """Teacher-forced torch-order LSTM chain from zero state -> h_seq
    (B, T, H), differentiable in x_seq and every cell tensor.  ``cell``:
    ``W_ih`` (E, 4H), ``W_hh`` (H, 4H), ``b_ih``/``b_hh`` (4H,), the
    ``models/lstm.py::init_cell_params`` layout.  Matches scanning
    ``lstm_cell`` from zero state."""
    return _FusedNicScan.apply(x_seq, *(cell[k] for k in CELL_KEYS))


def _library() -> ctypes.CDLL:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_lib.library("nic_scan", {
        "icee_nic_scan_workspace": ([vp] + [i] * 4 + [vp], i),
        "icee_nic_scan_fwd": ([vp] * 10 + [ll] + [i] * 4 + [vp], i),
        "icee_nic_scan_bwd": ([vp] * 14 + [ll] + [i] * 4 + [vp], i),
        "icee_scan_recurrence_launches": ([], ctypes.c_ulonglong)})
