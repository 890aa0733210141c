"""The host side and the arithmetic of K3's, K4's and K8's kernels (the
StyleNet, NIC and SentiCap training scans) that the CPU can check.

Since K3, K4 and K8 were redesigned for the H100, each direction of a
scan is the products over all B * T rows on the tensor cores at float32
accuracy
(``csrc/planes_product.cuh``'s 3xTF32 ``wgmma`` where one operand is a
weight, ``csrc/gemm_tf32x3.cuh``'s ``mma.sync`` for the weight grads), and
the recurrence as ONE cooperative launch (``csrc/scan_grid.cuh``) whose
blocks keep their slice of W_h in shared memory for all T steps.  Here:

- :func:`scan_plan`: the recurrence's launch plan, a pure function of
  (B, H) and the card's SM count, the source's ``sg_plan`` line for line
  (the C entry points re-derive it and refuse a plan that differs);
  :class:`_CPlan` is the ctypes mirror of its ``ScanPlan``;
- :func:`factored_scan_tc_plain`, :func:`factored_scan_bwd_tc_plain`,
  :func:`nic_scan_tc_plain`, :func:`nic_scan_bwd_tc_plain`,
  :func:`senticap_scan_tc_plain` and :func:`senticap_scan_bwd_tc_plain`:
  the kernels' arithmetic in tensor ops (each product
  ``att_scan.tf32x3_product_plain``'s 3xTF32, the backward's recurrent dh
  as the plan's k ranges added in range order, then clamped), so that
  error growing through the recurrence shows on the CPU;
- :func:`scan_product`: one of the scans' products alone (the plain
  version on the CPU, the kernels' own code on the card).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.att_scan import _product_dims, tf32x3_product_plain
from icee_tpu_torch.ops.senticap_decode import sm_count

# csrc/scan_grid.cuh's geometry
SG_THREADS = 256
SG_ROWS = 64          # batch rows of one pass
SG_BK = 32            # k tile
SG_LDA = SG_BK + 4    # A tile rows in shared memory (floats)
SG_MAX_STAGES = 9     # the A ring: at most 8 tiles in flight
SG_SMEM_LIMIT = 232448
SG_TILE_BYTES = 4 * SG_ROWS * SG_LDA   # one ring stage
H100_SMS = 132
FWD_UNITS = (4, 8, 16)
BWD_UNITS = (16, 32, 64)


def _round_up(x: int, to: int) -> int:
    return (x + to - 1) // to * to


def slice_bytes(nc: int, kd: int) -> int:
    """Bytes of a resident W_h slice of ``nc`` columns ``kd`` deep: its
    TF32 hi and lo planes in wgmma's swizzled layout, and 1024 bytes to
    align them."""
    return 2 * 4 * nc * _round_up(kd, SG_BK) + 1024


def fwd_tiles(nc: int, rows: int) -> int:
    """Bytes of the forward's tiles besides the slice and the ring: the
    out tile of a pass (64 x nc + 1) and c of the block's rows (rows x
    units)."""
    return 4 * (SG_ROWS * (nc + 1) + rows * (nc // 4))


def bwd_tiles(units: int, per: int) -> int:
    """Bytes of the backward's tiles besides the slice and the ring: the
    out tile of a pass (64 x units + 1), and the gate pass's: the
    activations (in) and dz (out) 4 an element, c_t, c_{t-1}, dh, the
    carried dc."""
    return 4 * (SG_ROWS * (units + 1) + 8 * per)


def stages(nk: int, rest: int) -> int:
    """Ring stages for nk k tiles a pass beside ``rest`` bytes: every
    tile of a pass in flight where shared memory allows; 0 where not even
    two stages fit."""
    s = min(nk + 1, SG_MAX_STAGES, (SG_SMEM_LIMIT - rest) // SG_TILE_BYTES)
    return s if s >= 2 else 0


class _CPlan(ctypes.Structure):
    """ctypes mirror of ``csrc/scan_grid.cuh``'s ``ScanPlan``."""
    _fields_ = [("B", ctypes.c_int), ("H", ctypes.c_int),
                ("sms", ctypes.c_int), ("f_rows", ctypes.c_int),
                ("f_units", ctypes.c_int), ("f_blocks", ctypes.c_int),
                ("f_stages", ctypes.c_int), ("b_units", ctypes.c_int),
                ("b_kc", ctypes.c_int), ("b_splits", ctypes.c_int),
                ("b_blocks", ctypes.c_int), ("b_stages", ctypes.c_int),
                ("b_per", ctypes.c_int), ("f_smem", ctypes.c_longlong),
                ("b_smem", ctypes.c_longlong)]


@dataclass(frozen=True)
class ScanPlan:
    """The recurrence's partition for (B, H) on a card of ``sms`` SMs."""
    B: int
    H: int
    sms: int
    f_rows: int     # forward: batch rows a block (a multiple of 64)
    f_units: int    # forward: hidden units a block (4 f_units columns)
    f_blocks: int   # forward: ceil(B / f_rows) x ceil(H / f_units)
    f_stages: int   # forward: A ring stages
    b_units: int    # backward: hidden units a block (dh columns)
    b_kc: int       # backward: depth of a block's range of 4H
    b_splits: int   # backward: k ranges, ceil(4H / b_kc)
    b_blocks: int   # backward: ceil(H / b_units) x b_splits
    b_stages: int   # backward: A ring stages
    b_per: int      # backward: (b, j) elements a block's gate pass owns
    f_smem: int     # bytes of shared memory a forward block
    b_smem: int     # ... a backward block

    def c_struct(self) -> _CPlan:
        return _CPlan(*(getattr(self, f) for f, _ in _CPlan._fields_))

    def fwd_block(self, q: int) -> Tuple[range, range]:
        """(batch rows, hidden units) forward block ``q`` owns."""
        groups = math.ceil(self.H / self.f_units)
        rg, ug = divmod(q, groups)
        return (range(rg * self.f_rows, min(self.B, (rg + 1) * self.f_rows)),
                range(ug * self.f_units,
                      min(self.H, (ug + 1) * self.f_units)))

    def bwd_block(self, q: int) -> Tuple[range, range]:
        """(hidden units, k range of 4H) backward block ``q`` owns (all B
        rows)."""
        ug, kr = divmod(q, self.b_splits)
        return (range(ug * self.b_units,
                      min(self.H, (ug + 1) * self.b_units)),
                range(kr * self.b_kc, min(4 * self.H, (kr + 1) * self.b_kc)))

    def gate_block(self, q: int) -> range:
        """The flat (b, j) elements b H + j backward block ``q``'s gate
        pass owns."""
        return range(min(q * self.b_per, self.B * self.H),
                     min((q + 1) * self.b_per, self.B * self.H))


def scan_plan(what: str, b: int, h: int, sms: int = H100_SMS) -> ScanPlan:
    """``sg_plan``: among the partitions whose blocks fit one an SM and
    whose shared memory fits a block, the least work a block a step, then
    the fewest words through L2 a step, then more units.  Raises, naming
    ``what`` (the kernel: K3, K4 or K8), where none fits."""
    if b < 1 or h < 1:
        raise ValueError(f"{what}: B = {b}, H = {h}")
    fwd, best = None, None
    nkf = math.ceil(h / SG_BK)
    for u in FWD_UNITS:
        nc = 4 * u
        for r in range(1, math.ceil(b / SG_ROWS) + 1):
            rows = SG_ROWS * r
            blocks = math.ceil(b / rows) * math.ceil(h / u)
            rest = slice_bytes(nc, h) + fwd_tiles(nc, rows)
            st = stages(nkf, rest)
            if blocks > sms or st == 0:
                continue
            key = (r * nc, blocks * rows, -u)
            if best is None or key < best:
                best = key
                fwd = (rows, u, blocks, st, rest + st * SG_TILE_BYTES)
    h4, h4p = 4 * h, _round_up(4 * h, SG_BK)
    bwd, best = None, None
    for u in BWD_UNITS:
        kc = SG_BK
        while True:
            kd = min(kc, h4p)
            splits = math.ceil(h4 / kc)
            blocks = math.ceil(h / u) * splits
            per = _round_up(math.ceil(b * h / blocks), 4)
            rest = slice_bytes(u, kd) + bwd_tiles(u, per)
            st = stages(kd // SG_BK, rest)
            if blocks <= sms and st > 0:
                key = (u * kd, blocks * b * kd + 2 * splits * b * h, -u)
                if best is None or key < best:
                    best = key
                    bwd = (u, kc, splits, blocks, st, per,
                           rest + st * SG_TILE_BYTES)
            if kc >= h4:
                break
            kc *= 2
    if fwd is None or bwd is None:
        raise ValueError(
            f"{what}: no launch plan of the recurrence fits B = {b}, H = {h} "
            f"on {sms} SMs (a block's slice of W_h must fit "
            f"{SG_SMEM_LIMIT} bytes of shared memory, one block an SM)")
    return ScanPlan(B=b, H=h, sms=sms, f_rows=fwd[0], f_units=fwd[1],
                    f_blocks=fwd[2], f_stages=fwd[3], b_units=bwd[0],
                    b_kc=bwd[1], b_splits=bwd[2], b_blocks=bwd[3],
                    b_stages=bwd[4], b_per=bwd[5], f_smem=fwd[4],
                    b_smem=bwd[6])


def plan_on(what: str, b: int, h: int, device: torch.device) -> ScanPlan:
    """:func:`scan_plan` for the card ``device`` (its SM count)."""
    return scan_plan(what, b, h, sm_count(device))


# --- the kernels' arithmetic --------------------------------------------------

def _gates_ifoc(z: torch.Tensor, c_prev: torch.Tensor):
    """The factored cell's [i, f, o, c] gates of pre-activations z (B, 4,
    H) -> (acts (B, 4, H), c, h = o c)."""
    i_t, f_t = torch.sigmoid(z[:, 0]), torch.sigmoid(z[:, 1])
    o_t, g_t = torch.sigmoid(z[:, 2]), torch.tanh(z[:, 3])
    c = f_t * c_prev + i_t * g_t
    return torch.stack([i_t, f_t, o_t, g_t], 1), c, o_t * c


def _dgates_ifoc(acts, c, c_prev, dh_total, dc_carry):
    """``FactoredGates::backward`` on (B, 4, H) activations -> (dz (B, 4,
    H), the dc carried to the step before)."""
    i_, f_, o_, g_ = (acts[:, q] for q in range(4))
    d_o = dh_total * c
    dc = dh_total * o_ + dc_carry
    d_f = dc * c_prev
    d_i = dc * g_
    d_g = dc * i_
    return torch.stack([d_i * i_ * (1.0 - i_), d_f * f_ * (1.0 - f_),
                        d_o * o_ * (1.0 - o_), d_g * (1.0 - g_ * g_)],
                       1), dc * f_


def _gates_ifgo(z: torch.Tensor, c_prev: torch.Tensor):
    """torch's LSTMCell [i, f, g, o] gates of pre-activations z (B, 4, H)
    -> (acts (B, 4, H), c, h = o tanh(c)) (``NicGates::forward``)."""
    i_t, f_t = torch.sigmoid(z[:, 0]), torch.sigmoid(z[:, 1])
    g_t, o_t = torch.tanh(z[:, 2]), torch.sigmoid(z[:, 3])
    c = f_t * c_prev + i_t * g_t
    return torch.stack([i_t, f_t, g_t, o_t], 1), c, o_t * torch.tanh(c)


def _dgates_ifgo(acts, c, c_prev, dh_total, dc_carry):
    """``NicGates::backward`` on (B, 4, H) activations -> (dz (B, 4, H),
    the dc carried to the step before)."""
    i_, f_, g_, o_ = (acts[:, q] for q in range(4))
    tanh_c = torch.tanh(c)
    d_o = dh_total * tanh_c
    dc = dh_total * o_ * (1.0 - tanh_c * tanh_c) + dc_carry
    d_i = dc * g_
    d_f = dc * c_prev
    d_g = dc * i_
    return torch.stack([d_i * i_ * (1.0 - i_), d_f * f_ * (1.0 - f_),
                        d_g * (1.0 - g_ * g_), d_o * o_ * (1.0 - o_)],
                       1), dc * f_


def _scan_tc_plain(u: torch.Tensor, w_h: torch.Tensor, pre, gates):
    """The forward recurrence over the input side u (B, T, 4, H): z_t =
    ``pre(u_t, acc)`` with acc = h_{t-1} W_h (B, 4, H) a 3xTF32 product
    (zero at t = 0), then ``gates(z, c_prev)`` -> (h_seq, c_seq, gate
    activations (B, T, 4, H))."""
    b, t, _, hd = u.shape
    h = u.new_zeros((b, hd))
    c = u.new_zeros((b, hd))
    hs, cs, acts = [], [], []
    for step in range(t):
        acc = (tf32x3_product_plain(h, w_h) if step else
               u.new_zeros((b, 4 * hd)))
        a, c, h = gates(pre(u[:, step], acc.reshape(b, 4, hd)), c)
        hs.append(h)
        cs.append(c)
        acts.append(a)
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(acts, 1)


def _chain_tc_plain(acts, c_seq, dh_seq, w_h, plan: ScanPlan, gclip,
                    dgates):
    """The backward recurrence from the saved gate activations: the gate
    derivatives ``dgates``, and dh_carry = dZ_{s+1} W_h^T as the plan's k
    ranges, each 3xTF32, added in range order, then clamped to +-gclip
    (None: no clamp) -> dZ (B, T, 4, H)."""
    b, t, _, hd = acts.shape
    dz = acts.new_empty((b, t, 4, hd))
    carry = acts.new_zeros((b, hd))
    dc_carry = acts.new_zeros((b, hd))
    c_prev = torch.cat([torch.zeros_like(c_seq[:, :1]), c_seq[:, :-1]], 1)
    for s in reversed(range(t)):
        dz[:, s], dc_carry = dgates(acts[:, s], c_seq[:, s], c_prev[:, s],
                                    dh_seq[:, s] + carry, dc_carry)
        flat = dz[:, s].reshape(b, 4 * hd)
        carry = None
        for k0 in range(0, 4 * hd, plan.b_kc):
            k1 = min(4 * hd, k0 + plan.b_kc)
            part = tf32x3_product_plain(flat[:, k0:k1], w_h[:, k0:k1], "T")
            carry = part if carry is None else carry + part
        if gclip is not None:
            carry = carry.clamp(-gclip, gclip)
    return dz


def _h_prev(h_seq: torch.Tensor) -> torch.Tensor:
    """(B, T, H) -> h shifted one step (zero at t = 0), (B T, H)."""
    return torch.cat([torch.zeros_like(h_seq[:, :1]), h_seq[:, :-1]],
                     1).reshape(-1, h_seq.shape[-1])


def factored_scan_tc_plain(params: dict, x: torch.Tensor):
    """K3's forward arithmetic -> (h_seq, c_seq, saved (v, s, gate
    activations (B, T, 4, H)))."""
    b, t, e = x.shape
    f, hd = params["U_w"].shape[1], params["W_w"].shape[0]
    n = b * t
    v = tf32x3_product_plain(x.reshape(n, e), params["V_w"], "N",
                             params["V_b"].reshape(-1))
    s = tf32x3_product_plain(v.reshape(n, 4, f).transpose(0, 1),
                             params["S_w"], "N", params["S_b"])
    u = tf32x3_product_plain(s, params["U_w"], "N", params["U_b"])
    u = u.transpose(0, 1).reshape(b, t, 4, hd)
    w_b = params["W_b"]
    h_seq, c_seq, acts = _scan_tc_plain(
        u, params["W_w"], lambda u_t, acc: u_t + (acc + w_b), _gates_ifoc)
    return h_seq, c_seq, (v, s.transpose(0, 1).reshape(n, 4 * f), acts)


def factored_scan_bwd_tc_plain(params: dict, x: torch.Tensor,
                               h_seq: torch.Tensor, c_seq: torch.Tensor,
                               dh_seq: torch.Tensor, saved, plan: ScanPlan):
    """K3's backward arithmetic from the forward's ``saved`` -> (dx, grads
    by name)."""
    b, t, e = x.shape
    f, hd = params["U_w"].shape[1], params["W_w"].shape[0]
    n = b * t
    v, s, acts = saved
    dz = _chain_tc_plain(acts, c_seq, dh_seq, params["W_w"], plan, None,
                         _dgates_ifoc)
    dzf = dz.reshape(n, 4 * hd)
    dzg = dz.reshape(n, 4, hd).transpose(0, 1)          # (4, n, H)
    h_prev = _h_prev(h_seq)
    sg = s.reshape(n, 4, f).transpose(0, 1)
    vg = v.reshape(n, 4, f).transpose(0, 1)
    ds = tf32x3_product_plain(dzg, params["U_w"], "T")   # (4, n, F)
    dv = tf32x3_product_plain(ds, params["S_w"], "T")
    dvf = dv.transpose(0, 1).reshape(n, 4 * f)
    grads = {"W_w": tf32x3_product_plain(h_prev, dzf, "A"),
             "W_b": dzf.sum(0).reshape(4, hd),
             "U_w": tf32x3_product_plain(sg, dzg, "A"),
             "U_b": dzf.sum(0).reshape(4, hd),
             "S_w": tf32x3_product_plain(vg, ds, "A"),
             "S_b": ds.sum(1),
             "V_w": tf32x3_product_plain(x.reshape(n, e), dvf, "A"),
             "V_b": dvf.sum(0).reshape(4, f)}
    dx = tf32x3_product_plain(dvf, params["V_w"], "T").reshape(b, t, e)
    return dx, grads


def senticap_scan_tc_plain(w_lstm: torch.Tensor, x: torch.Tensor):
    """K8's forward arithmetic -> (h_seq, c_seq, gate activations (B, T,
    4, H))."""
    b, t, e = x.shape
    hd = w_lstm.shape[1] // 4
    p = tf32x3_product_plain(x.reshape(b * t, e), w_lstm[:e])
    return _scan_tc_plain(p.reshape(b, t, 4, hd), w_lstm[e:],
                          lambda u_t, acc: u_t + acc, _gates_ifoc)


def senticap_scan_bwd_tc_plain(w_lstm: torch.Tensor, x: torch.Tensor,
                               h_seq: torch.Tensor, c_seq: torch.Tensor,
                               dh_seq: torch.Tensor, gclip: float, acts,
                               plan: ScanPlan):
    """K8's backward arithmetic from the forward's gate activations ->
    (dx (B, T, E), dw (E + H, 4H))."""
    b, t, e = x.shape
    hd = w_lstm.shape[1] // 4
    n = b * t
    dz = _chain_tc_plain(acts, c_seq, dh_seq, w_lstm[e:], plan, gclip,
                         _dgates_ifoc)
    dzf = dz.reshape(n, 4 * hd)
    dw = torch.cat([tf32x3_product_plain(x.reshape(n, e), dzf, "A"),
                    tf32x3_product_plain(_h_prev(h_seq), dzf, "A")], 0)
    dx = tf32x3_product_plain(dzf, w_lstm[:e], "T").reshape(b, t, e)
    return dx, dw


def nic_scan_tc_plain(cell: dict, x: torch.Tensor):
    """K4's forward arithmetic -> (h_seq, c_seq, gate activations (B, T,
    4, H)): P = x W_ih + b_ih 3xTF32, then z = (P_t + h W_hh) + b_hh."""
    b, t, e = x.shape
    hd = cell["W_hh"].shape[0]
    p = tf32x3_product_plain(x.reshape(b * t, e), cell["W_ih"], "N",
                             cell["b_ih"])
    b_hh = cell["b_hh"].reshape(4, hd)
    return _scan_tc_plain(p.reshape(b, t, 4, hd), cell["W_hh"],
                          lambda u_t, acc: (u_t + acc) + b_hh, _gates_ifgo)


def nic_scan_bwd_tc_plain(cell: dict, x: torch.Tensor, h_seq: torch.Tensor,
                          c_seq: torch.Tensor, dh_seq: torch.Tensor, acts,
                          plan: ScanPlan):
    """K4's backward arithmetic from the forward's gate activations ->
    (dx (B, T, E), grads by name; ``b_ih`` and ``b_hh`` the same column
    sum of dZ)."""
    b, t, e = x.shape
    hd = cell["W_hh"].shape[0]
    n = b * t
    dz = _chain_tc_plain(acts, c_seq, dh_seq, cell["W_hh"], plan, None,
                         _dgates_ifgo)
    dzf = dz.reshape(n, 4 * hd)
    db = dzf.sum(0)
    grads = {"W_ih": tf32x3_product_plain(x.reshape(n, e), dzf, "A"),
             "W_hh": tf32x3_product_plain(_h_prev(h_seq), dzf, "A"),
             "b_ih": db, "b_hh": db.clone()}
    dx = tf32x3_product_plain(dzf, cell["W_ih"], "T").reshape(b, t, e)
    return dx, grads


# --- one product alone ---------------------------------------------------------

def scan_product(a, b, form: str = "N", bias=None) -> torch.Tensor:
    """C = op(a) op(b) [+ bias] as K3, K4 and K8 compute their products over
    all rows (forms as ``att_scan._product_dims``; ``b`` the weight in
    'N' and 'T', whose bias is (N,) or (batch, N); no bias in 'A').  On
    the CPU ``att_scan.tf32x3_product_plain``; on the card the scans'
    library (``icee_scan_product``: the weight's planes and the wgmma
    product, or ``gemm_tf32x3.cuh`` for 'A'), counted in
    ``scan_product.launches``."""
    batch, m, n, k = _product_dims(a, b, form)
    if bias is not None and form == "A":
        raise ValueError("scan_product: no bias in form 'A'")
    if a.device.type == "cpu":
        return tf32x3_product_plain(a, b, form, bias)
    from icee_tpu_torch.ops import lstm_scan

    device = a.device
    for name, t in (("a", a), ("b", b), ("bias", bias)):
        if t is None:
            continue
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 on {device} expected")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be contiguous")
    if batch > 4:
        raise ValueError(f"scan_product: batch {batch} > 4")
    lib = lstm_scan._library()
    ws = torch.empty((lib.icee_scan_product_ws(ord(form), m, n, k, batch),),
                     dtype=torch.float32, device=device)
    out = torch.empty(((batch,) if a.dim() == 3 or b.dim() == 3 else ())
                      + (m, n), dtype=torch.float32, device=device)
    offs = [t.stride(0) if t.dim() == 3 else 0 for t in (a, b)]
    zbias = bias.stride(0) if bias is not None and bias.dim() == 2 else 0
    p = cuda_lib.ptr
    rc = lib.icee_scan_product(
        ord(form), p(a), a.stride(-2), offs[0], p(b), b.stride(-2), offs[1],
        ctypes.c_void_p(0) if bias is None else p(bias), zbias, p(out), m, n,
        k, batch, p(ws), ws.numel(), cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, f"scan_product (form {form})")
    scan_product.launches += 1
    return out


scan_product.launches = 0
