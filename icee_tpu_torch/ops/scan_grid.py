"""The host side and the arithmetic of K3's, K4's and K8's kernels (the
StyleNet, NIC and SentiCap training scans) that the CPU can check.

Since K3, K4 and K8 were redesigned for the H100, each direction of a
scan is the products over all B * T rows on the tensor cores at float32
accuracy
(``csrc/planes_product.cuh``'s 3xTF32 ``wgmma`` where one operand is a
weight, ``csrc/gemm_tf32x3.cuh``'s ``mma.sync`` for the weight grads), and
the recurrence as ONE cooperative launch (``csrc/scan_grid.cuh``) whose
blocks keep their slice of W_h in shared memory for all T steps (a plan
of kind ``RESIDENT``), or, for a direction where no such partition fits
(H past ~704, or a large B) or whose resident ring would hold one tile in
flight, stream W_h's TF32 planes from device memory through their ring a
pass (kind ``STREAMED``, every B, and every H up to ``STREAM_MAX``), in
items of 1 or 2 M tiles of 64 rows that share each tile of the planes,
the ring fed by TMA where the operands allow it.  Here:

- :func:`scan_plan`: the recurrence's launch plan, a pure function of
  (B, H) and the card's SM count, the source's ``sg_plan`` line for line
  (the C entry points re-derive it once a plan and refuse a plan that
  differs), derived once a shape; :class:`_CPlan` is the ctypes mirror of
  its ``ScanPlan``, and :func:`workspace` asks a scan's workspace size
  once a shape;
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
from typing import List, Tuple

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
SG_ITEM_TILES = 2     # a streamed item's fixed cost, in k tiles
SG_MAX_MT = 2         # 64-row M tiles of a streamed item
SG_FLIGHT_BYTES = 49152   # bytes a block keeps in flight (the plan key)
H100_SMS = 132
FWD_UNITS = (4, 8, 16)
BWD_UNITS = (16, 32, 64)
STREAM_FWD_UNITS = (8, 16)    # a streamed item's units: 32 or 64 columns
STREAM_BWD_UNITS = (32, 64)
RESIDENT, STREAMED = 0, 1   # a plan's kind, a direction
STREAM_MAX = 2048           # H a streamed plan takes (any B)


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


def stream_stage_bytes(nc: int, mt: int = 1) -> int:
    """One stage of a streamed ring: B's hi and lo tiles (nc rows of 128
    bytes each), then the item's mt A tiles."""
    return 2 * nc * SG_BK * 4 + mt * SG_TILE_BYTES


def stream_rest(nc: int, mt: int = 1) -> int:
    """Bytes of a streamed block besides its ring: 1024 to align the
    ring, the out tile of an item (64 mt x nc + 1)."""
    return 1024 + 4 * SG_ROWS * mt * (nc + 1)


def stream_stages(nk: int, nc: int, mt: int = 1) -> int:
    """Stages of a streamed ring for nk k tiles a pass (``stages``'
    rule)."""
    s = min(nk + 1, SG_MAX_STAGES, (SG_SMEM_LIMIT - stream_rest(nc, mt))
            // stream_stage_bytes(nc, mt))
    return s if s >= 2 else 0


def tile_cost(mt: int, nc_streamed: int, st: int) -> int:
    """What a ring's k tile costs a block, in bytes (``sg_tile_cost``):
    the bytes it copies (mt A tiles of 64 x 32, and B's planes, nc columns
    x 32, hi and lo: 0 for a resident slice), and no less than
    ``SG_FLIGHT_BYTES`` over the tiles in flight (st - 1): a ring too
    shallow to cover L2's latency waits for it whatever it copies."""
    return max(mt * 4 * SG_ROWS * SG_BK + 8 * nc_streamed * SG_BK,
               SG_FLIGHT_BYTES // (st - 1))


def stream_item_bytes(nk: int, nc: int, mt: int = 1,
                      st: int = SG_MAX_STAGES) -> int:
    """What one item of a streamed pass costs: its nk k tiles and
    ``SG_ITEM_TILES`` tiles more for the ring's fill and the item's
    epilogue, each at :func:`tile_cost`."""
    return (nk + SG_ITEM_TILES) * tile_cost(mt, nc, st)


class _CPlan(ctypes.Structure):
    """ctypes mirror of ``csrc/scan_grid.cuh``'s ``ScanPlan``."""
    _fields_ = [("B", ctypes.c_int), ("H", ctypes.c_int),
                ("sms", ctypes.c_int), ("f_rows", ctypes.c_int),
                ("f_units", ctypes.c_int), ("f_blocks", ctypes.c_int),
                ("f_stages", ctypes.c_int), ("b_units", ctypes.c_int),
                ("b_kc", ctypes.c_int), ("b_splits", ctypes.c_int),
                ("b_blocks", ctypes.c_int), ("b_stages", ctypes.c_int),
                ("b_per", ctypes.c_int), ("f_kind", ctypes.c_int),
                ("b_kind", ctypes.c_int), ("f_smem", ctypes.c_longlong),
                ("b_smem", ctypes.c_longlong), ("b_rows", ctypes.c_int)]


@dataclass(frozen=True)
class ScanPlan:
    """The recurrence's partition for (B, H) on a card of ``sms`` SMs.  A
    streamed direction cuts its work into items of 64 or 128 rows
    (``f_rows``, ``b_rows``: 1 or 2 M tiles sharing each tile of W_h's
    planes; the backward's also by k range), dealt to its blocks round
    robin."""
    B: int
    H: int
    sms: int
    f_rows: int     # forward: batch rows a block (a multiple of 64;
    #                 streamed: an item's)
    f_units: int    # forward: hidden units a block (4 f_units columns)
    f_blocks: int   # forward: ceil(B / f_rows) x ceil(H / f_units)
    #                 (streamed: at most sms, the items dealt round robin)
    f_stages: int   # forward: A ring stages
    b_units: int    # backward: hidden units a block (dh columns)
    b_kc: int       # backward: depth of a block's range of 4H
    b_splits: int   # backward: k ranges, ceil(4H / b_kc)
    b_blocks: int   # backward: ceil(H / b_units) x b_splits (streamed:
    #                 at most sms, as the forward's)
    b_stages: int   # backward: A ring stages
    b_per: int      # backward: (b, j) elements a block's gate pass owns
    f_kind: int     # forward: RESIDENT or STREAMED
    b_kind: int     # backward: RESIDENT or STREAMED
    f_smem: int     # bytes of shared memory a forward block
    b_smem: int     # ... a backward block
    b_rows: int     # backward: rows of a pass (streamed: an item's)

    def c_struct(self) -> _CPlan:
        return _CPlan(*(getattr(self, f) for f, _ in _CPlan._fields_))

    def fwd_items(self, q: int) -> List[Tuple[range, range]]:
        """The (batch rows, hidden units) forward block ``q`` owns each
        step: items q, q + f_blocks, ... of f_rows rows x f_units units,
        item i the rows' group i // groups and the units' i % groups (a
        resident plan has one item a block; a streamed one's rows are a
        64-row pass)."""
        groups = math.ceil(self.H / self.f_units)
        items = math.ceil(self.B / self.f_rows) * groups
        r, u = self.f_rows, self.f_units
        return [(range(i // groups * r, min(self.B, (i // groups + 1) * r)),
                 range(i % groups * u, min(self.H, (i % groups + 1) * u)))
                for i in range(q, items, self.f_blocks)]

    def bwd_items(self, q: int) -> List[Tuple[range, range, range]]:
        """The (batch rows, hidden units, k range of 4H) backward block
        ``q``'s product owns each step: items q, q + b_blocks, ..., item i
        the k range i % b_splits, then the units, then the rows (a resident
        plan has one item a block over all B rows; a streamed one's rows
        are an item's ``b_rows``)."""
        r = self.B if self.b_kind == RESIDENT else self.b_rows
        groups = math.ceil(self.H / self.b_units)
        items = math.ceil(self.B / r) * groups * self.b_splits
        u, kc = self.b_units, self.b_kc
        out = []
        for i in range(q, items, self.b_blocks):
            rest, kr = divmod(i, self.b_splits)
            rp, ug = divmod(rest, groups)
            out.append((range(rp * r, min(self.B, (rp + 1) * r)),
                        range(ug * u, min(self.H, (ug + 1) * u)),
                        range(kr * kc, min(4 * self.H, (kr + 1) * kc))))
        return out

    def gate_block(self, q: int) -> range:
        """The flat (b, j) elements b H + j backward block ``q``'s gate
        pass owns."""
        return range(min(q * self.b_per, self.B * self.H),
                     min((q + 1) * self.b_per, self.B * self.H))


_PLANS: dict = {}


def scan_plan(what: str, b: int, h: int, sms: int = H100_SMS) -> ScanPlan:
    """``sg_plan``: among the resident partitions whose blocks fit one an
    SM and whose shared memory fits a block, the least work a block a step,
    then the fewest words through L2 a step, then more units.  At H <=
    ``STREAM_MAX`` (and B H < 2^31) each direction also has a streamed
    plan, items of 1 or 2 M tiles of 64 rows sharing each tile of W_h's
    planes: the least cost on the busiest block a step (the A rows re-read
    once a unit group, the plane tiles once a row group, each k tile no
    cheaper than the L2 latency its ring covers: :func:`tile_cost`), then
    the least over all items, then more units (the backward's k ranges any
    multiple of 32).  A direction streams where no resident partition
    fits, or where the resident ring has 2 stages for passes of more than
    one k tile (one tile in flight) and the streamed plan's busiest block
    costs less than the resident one's (B = 4096's forward: 2,048 rows a
    block).  Raises, naming ``what`` (the kernel: K3, K4 or K8),
    where neither fits.  A plan is derived once a (B, H, sms): a second
    call returns the same plan without a search."""
    plan = _PLANS.get((b, h, sms))
    if plan is None:
        plan = _search(what, b, h, sms)
        _PLANS[(b, h, sms)] = plan
    return plan


def _search(what: str, b: int, h: int, sms: int) -> ScanPlan:
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
                fwd = (rows, u, blocks, st, RESIDENT,
                       rest + st * SG_TILE_BYTES)
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
                    bwd = (u, kc, splits, blocks, st, per, RESIDENT,
                           rest + st * SG_TILE_BYTES, SG_ROWS)
            if kc >= h4:
                break
            kc *= 2
    if h <= STREAM_MAX and b * h < 2 ** 31:
        # the resident plans' busiest block a step: its passes' A tiles
        f_res = None if fwd is None else (
            math.ceil(min(fwd[0], b) / SG_ROWS) * nkf
            * tile_cost(1, 0, fwd[3]))
        b_res = None if bwd is None else (
            math.ceil(b / SG_ROWS) * (_round_up(min(bwd[1], h4p), SG_BK)
                                      // SG_BK) * tile_cost(1, 0, bwd[4]))
        sfwd, best = None, None
        for u in STREAM_FWD_UNITS:
            nc = 4 * u
            # two M tiles an item where TMA feeds the ring (H % 4 == 0)
            for mt in range(1, (1 if h % 4 else SG_MAX_MT) + 1):
                items = math.ceil(b / (SG_ROWS * mt)) * math.ceil(h / u)
                blocks = min(items, sms)
                st = stream_stages(nkf, nc, mt)
                if st:
                    item = stream_item_bytes(nkf, nc, mt, st)
                    key = (math.ceil(items / blocks) * item, items * item,
                           -u)
                    if best is None or key < best:
                        best = key
                        sfwd = (SG_ROWS * mt, u, blocks, st, STREAMED,
                                stream_rest(nc, mt)
                                + st * stream_stage_bytes(nc, mt))
        if sfwd is not None and (fwd is None or (
                fwd[3] == 2 < nkf + 1 and best[0] < f_res)):
            fwd = sfwd
        sbwd, best = None, None
        nkt = h4p // SG_BK
        for u in STREAM_BWD_UNITS:
            for mt in range(1, SG_MAX_MT + 1):
                for splits in range(1, nkt + 1):
                    nk = math.ceil(nkt / splits)
                    kc = SG_BK * nk
                    if math.ceil(h4 / kc) != splits:
                        continue        # s ranges of this depth
                    items = (math.ceil(b / (SG_ROWS * mt)) * math.ceil(h / u)
                             * splits)
                    blocks = min(items, sms)
                    st = stream_stages(nk, u, mt)
                    if st == 0:
                        continue
                    item = stream_item_bytes(nk, u, mt, st)
                    key = (math.ceil(items / blocks) * item,
                           items * item + 8 * splits * b * h, -u)
                    if best is None or key < best:
                        best = key
                        sbwd = (u, kc, splits, blocks, st,
                                _round_up(math.ceil(b * h / blocks), 4),
                                STREAMED,
                                stream_rest(u, mt)
                                + st * stream_stage_bytes(u, mt),
                                SG_ROWS * mt)
        if sbwd is not None and (bwd is None or (
                bwd[4] == 2 < min(bwd[1], h4p) // SG_BK + 1
                and best[0] < b_res)):
            bwd = sbwd
    if fwd is None or bwd is None:
        raise ValueError(
            f"{what}: no launch plan of the recurrence fits B = {b}, H = {h} "
            f"on {sms} SMs (no resident partition fits {SG_SMEM_LIMIT} bytes "
            f"of shared memory a block, one block an SM, and a streamed "
            f"plan takes H up to {STREAM_MAX} and B H below 2^31)")
    return ScanPlan(B=b, H=h, sms=sms, f_rows=fwd[0], f_units=fwd[1],
                    f_blocks=fwd[2], f_stages=fwd[3], b_units=bwd[0],
                    b_kc=bwd[1], b_splits=bwd[2], b_blocks=bwd[3],
                    b_stages=bwd[4], b_per=bwd[5], f_kind=fwd[4],
                    b_kind=bwd[6], f_smem=fwd[5], b_smem=bwd[7],
                    b_rows=bwd[8])


def plan_on(what: str, b: int, h: int, device: torch.device) -> ScanPlan:
    """:func:`scan_plan` for the card ``device`` (its SM count)."""
    return scan_plan(what, b, h, sm_count(device))


_SPACES: dict = {}


def workspace(query, plan: ScanPlan, dims: Tuple[int, ...], direction: int,
              device: torch.device):
    """A scan's C workspace for one direction (0 forward, 1 backward) ->
    (the plan's ctypes struct, a float32 tensor of its size).  ``query``
    is the library's ``icee_*_scan_workspace`` (plan, *dims, out[2]); its
    answer and the struct are kept a (query, plan, dims), so that a second
    call asks the library nothing."""
    key = (query.__name__, plan, dims)
    hit = _SPACES.get(key)
    if hit is None:
        cplan = plan.c_struct()
        sizes = (ctypes.c_longlong * 2)()
        query(ctypes.byref(cplan), *dims, ctypes.byref(sizes))
        hit = _SPACES[key] = (cplan, (sizes[0], sizes[1]))
    return hit[0], torch.empty((hit[1][direction],), dtype=torch.float32,
                               device=device)


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
