"""Chunked cross-entropy from hidden states: the (B, T, V) logits never
exist whole (port of ``icee_tpu/ops/chunked_loss.py``'s ``_weighted_ce``,
``masked_ce_from_hiddens`` and ``masked_sum_ce_from_hiddens``).

The loss runs over TIME chunks of ``t_chunk`` steps (zero-padded):

- forward: per chunk, the logits ``x @ C_w + C_b`` (a plain product, as the
  JAX package leaves it to XLA), then the row pass :func:`ce_rows` -> the
  per-row logsumexp (kept for the backward) and ``w * nll``;
- backward: per chunk, the logits again, then :func:`ce_grad_rows` turns
  them in place into ``dl = (softmax - onehot) * w * g`` (zero where the
  clamp bit) and adds the chunk's bias grad; ``dx = dl C_w^T`` and
  ``dC_w += x^T dl`` are plain products.

:func:`masked_neglog2_sum_from_hiddens`, the SentiCap perplexity numerator,
is value only: the forward row pass without a clamp, then one elementwise
pass.

The SentiCap switched model's two-head mixture CE
(:func:`mixture_ce_from_hiddens`, port of ``_mixture_ce``) runs over two
heads in time chunks of equal length: the forward row pass
:func:`mixture_ce_rows` gives both heads' lse and target probabilities and
``w * -log(max(co p_o + cn p_n, 1e-37))`` in one launch.  Unlike the
single-head CE it keeps the logits of every head that needs a gradient, so
the backward recomputes none: :func:`ce_grad_rows` with per-row weights
``-fac`` and g = 1 turns them in place into ``fac * (onehot - p)``.  A head
that needs no gradient (the frozen background head of switch training)
keeps nothing.  :func:`mixture_ce_plain` is the whole loss with each chunk's
softmaxes materialized, differentiated by autograd.

The row passes are hand-written CUDA kernels (``csrc/chunked_ce.cu``); their
plain versions :func:`ce_rows_plain`, :func:`ce_grad_rows_plain` and
:func:`mixture_ce_rows_plain` sit beside them.  Each wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises.  The kernels read a row once: the forward (the CE's and the
mixture's, one template over the heads) one warp a row, each lane an online
(max, rescaled sum) over its columns, merged by a fixed butterfly; the
backward in (column slab, row group) blocks whose column sums are added in
group order by a second launch.  :func:`ce_rows_partition_plain`,
:func:`mixture_rows_partition_plain` and
:func:`ce_grad_rows_partition_plain` emulate that partition and its order
of sums in tensor ops.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib


def auto_t_chunk(batch: int, t: int, target_rows: int = 2048) -> int:
    """Timesteps per chunk so that ``batch * t_chunk`` ~ ``target_rows``."""
    return max(1, min(t, -(-target_rows // max(batch, 1))))


def _to_chunks(x: torch.Tensor, t_chunk: int) -> torch.Tensor:
    """(B, T, ...) -> (n_chunks, B, t_chunk, ...), zero-padding T;
    contiguous."""
    b, t = x.shape[:2]
    pad = (-t) % t_chunk
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad) + tuple(x.shape[2:]))], dim=1)
    x = x.reshape((b, -1, t_chunk) + tuple(x.shape[2:]))
    return x.movedim(1, 0).contiguous()


# --- row passes: plain versions -------------------------------------------

def _target_logit(logits: torch.Tensor, targets: torch.Tensor):
    """logits[r, targets[r]], 0 where the target lies outside [0, V) (no
    one-hot entry, as ``jax.nn.one_hot``)."""
    v = logits.shape[-1]
    valid = (targets >= 0) & (targets < v)
    got = logits.gather(-1, targets.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(valid, got, 0.0), valid


def ce_rows_plain(logits: torch.Tensor, targets: torch.Tensor,
                  weights: torch.Tensor, clamp: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, V) logits -> (lse (R,), weights * nll (R,)), nll = lse - target
    logit, optionally ``min(nll, clamp)``."""
    m = logits.max(dim=-1).values
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    tgt, _ = _target_logit(logits, targets)
    nll = lse - tgt
    if clamp is not None:
        nll = torch.clamp(nll, max=float(clamp))
    return lse, weights * nll


def ce_grad_rows_plain(logits: torch.Tensor, targets: torch.Tensor,
                       weights: torch.Tensor, lse: torch.Tensor,
                       g: torch.Tensor, clamp: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dl (R, V) = (exp(l - lse) - onehot) * weights * g, zero on rows
    where the clamp bit; db (V,) = sum of dl over rows)."""
    tgt, valid = _target_logit(logits, targets)
    scale = weights * g
    if clamp is not None:
        scale = scale * (lse - tgt < float(clamp)).to(scale.dtype)
    v = logits.shape[-1]
    onehot = (torch.arange(v, device=logits.device)[None, :]
              == targets[:, None]) & valid[:, None]
    dl = (torch.exp(logits - lse[:, None]) - onehot.to(logits.dtype)) \
        * scale[:, None]
    return dl, dl.sum(dim=0)


# --- row passes: the kernels' partition, emulated -----------------------------

# csrc/chunked_ce.cu's geometry
CER_ROWS = 4         # forward: rows of a block, one warp each
CER_UNROLL = 8       # forward: groups a lane sums a chunk
CEG_THREADS = 256    # backward: threads of a block, VW columns each
CEG_ROWS = 64        # backward: rows of a group
CEG_UNROLL = 8       # backward: rows whose loads a thread keeps in flight


def _ce_ref(m: torch.Tensor) -> torch.Tensor:
    """The kernels' reference for exp: the max, 0 where it is -inf."""
    return torch.where(m == -torch.inf, torch.zeros_like(m), m)


def ce_rows_partition_plain(logits: torch.Tensor, targets: torch.Tensor,
                            weights: torch.Tensor,
                            clamp: Optional[float] = None, vw: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ce_rows_plain` in the forward kernel's partition and order
    (:func:`_lse_partition`).  -> (lse, w * nll), each (R,)."""
    lse = _lse_partition(logits, vw)
    tgt, _ = _target_logit(logits, targets)
    nll = lse - tgt
    if clamp is not None:
        nll = torch.clamp(nll, max=float(clamp))
    return lse, weights * nll


def mixture_rows_partition_plain(logits_o: torch.Tensor,
                                 logits_n: torch.Tensor,
                                 targets: torch.Tensor, co: torch.Tensor,
                                 cn: torch.Tensor, weights: torch.Tensor,
                                 vw: int = 0):
    """:func:`mixture_ce_rows_plain` in the forward kernel's partition and
    order: each head's row as the CE's (:func:`_lse_partition`), then p =
    exp(target logit - lse) per head, p_mix = co p_o + cn p_n and ``w *
    -log(max(p_mix, 1e-37))``.  -> (lse_o, lse_n, p_o, p_n, contrib)."""
    out = []
    for logits in (logits_o, logits_n):
        lse = _lse_partition(logits, vw)
        tgt, _ = _target_logit(logits, targets)
        out.append((lse, torch.exp(tgt - lse)))
    (lse_o, p_o), (lse_n, p_n) = out
    p_mix = co * p_o + cn * p_n
    contrib = weights * -torch.log(torch.clamp(p_mix, min=PROB_FLOOR))
    return lse_o, lse_n, p_o, p_n, contrib


def _lse_partition(logits: torch.Tensor, vw: int = 0) -> torch.Tensor:
    """Each row's logsumexp as a warp of the forward kernel forms it: lane
    l sums the ``vw``-float groups q = l mod 32 (``vw`` 4 where V % 4 ==
    0, else 1, as the kernel picks for an aligned row), CER_UNROLL groups
    a chunk; per chunk its max, the lane's sum rescaled once, then the
    chunk's terms in order; the 32 lanes' (max, sum) pairs merged by a
    butterfly (offsets 16 .. 1); lse = max + log(sum).  -> (R,)."""
    r, v = logits.shape
    vw = vw or (4 if v % 4 == 0 else 1)
    nq = v // vw
    span = 32 * CER_UNROLL
    groups = torch.cat([logits.reshape(r, nq, vw), logits.new_full(
        (r, -nq % span, vw), -torch.inf)], 1)
    # (R, chunks, CER_UNROLL, lane, vw): group q0 + 32 u + lane
    groups = groups.reshape(r, -1, CER_UNROLL, 32, vw)
    m = logits.new_full((r, 32), -torch.inf)
    s = logits.new_zeros((r, 32))
    for ch in range(groups.shape[1]):
        vals = groups[:, ch]                              # (R, U, 32, vw)
        cm = torch.maximum(m, vals.amax(dim=(1, 3)))
        ref = _ce_ref(cm)
        t = s * torch.exp(m - ref)
        for u in range(CER_UNROLL):
            e = torch.exp(vals[:, u, :, 0] - ref)
            for k in range(1, vw):
                e = e + torch.exp(vals[:, u, :, k] - ref)
            t = t + e
        m, s = cm, t
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        m2, s2 = m[:, lanes ^ off], s[:, lanes ^ off]
        mm = torch.maximum(m, m2)
        ref = _ce_ref(mm)
        s = s * torch.exp(m - ref) + s2 * torch.exp(m2 - ref)
        m = mm
    return m[:, 0] + torch.log(s[:, 0])


def ce_grad_rows_partition_plain(logits: torch.Tensor, targets: torch.Tensor,
                                 weights: torch.Tensor, lse: torch.Tensor,
                                 g: torch.Tensor, db: torch.Tensor,
                                 accumulate: bool = True,
                                 clamp: Optional[float] = None
                                 ) -> torch.Tensor:
    """:func:`ce_grad_rows_plain` in the backward kernels' order: dl per
    element as the plain version forms it; each group of CEG_ROWS rows'
    column sums row by row in row order, then the groups' sums in group
    order into ``db`` (added to it where ``accumulate``, in place).
    -> dl."""
    dl, _ = ce_grad_rows_plain(logits, targets, weights, lse, g, clamp)
    total = None
    for r0 in range(0, dl.shape[0], CEG_ROWS):
        part = dl[r0]
        for i in range(r0 + 1, min(r0 + CEG_ROWS, dl.shape[0])):
            part = part + dl[i]
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros_like(db)
    db.copy_(db + total if accumulate else total)
    return dl


# --- row passes: kernel wrappers ---------------------------------------------

def _check_rows(logits, targets, weights, device):
    if logits.dim() != 2:
        raise ValueError(f"logits: expected (R, V), got {tuple(logits.shape)}")
    r, v = logits.shape
    cuda_lib.check_tensor("logits", logits, (r, v), torch.float32, device)
    cuda_lib.check_tensor("targets", targets, (r,), torch.int64, device)
    cuda_lib.check_tensor("weights", weights, (r,), torch.float32, device)
    return r, v


def _clamp_args(clamp):
    return (0.0, 0) if clamp is None else (float(clamp), 1)


def ce_rows(logits: torch.Tensor, targets: torch.Tensor,
            weights: torch.Tensor, clamp: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE forward row pass -> (lse (R,), weights * nll (R,)); see
    :func:`ce_rows_plain`."""
    device = logits.device
    r, v = _check_rows(logits, targets, weights, device)
    if device.type == "cpu":
        return ce_rows_plain(logits, targets, weights, clamp)
    if device.type != "cuda":
        raise ValueError(f"ce_rows: unsupported device {device}")
    lse = torch.empty((r,), dtype=torch.float32, device=device)
    contrib = torch.empty((r,), dtype=torch.float32, device=device)
    p = cuda_lib.ptr
    lib = _library()
    rc = lib.icee_ce_rows(p(logits), p(targets), p(weights), p(lse),
                          p(contrib), r, v, *_clamp_args(clamp),
                          cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "ce_rows")
    ce_rows.launches += 1
    return lse, contrib


ce_rows.launches = 0


def ce_grad_rows(logits: torch.Tensor, targets: torch.Tensor,
                 weights: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                 db: torch.Tensor, clamp: Optional[float] = None
                 ) -> torch.Tensor:
    """CE backward row pass: turns ``logits`` into dl IN PLACE and adds its
    row sum to ``db`` (V,); returns dl.  ``g`` is the loss's upstream
    gradient, a one-element tensor.  See :func:`ce_grad_rows_plain`."""
    device = logits.device
    r, v = _check_rows(logits, targets, weights, device)
    cuda_lib.check_tensor("lse", lse, (r,), torch.float32, device)
    cuda_lib.check_tensor("g", g.reshape(1), (1,), torch.float32, device)
    cuda_lib.check_tensor("db", db, (v,), torch.float32, device)
    if device.type == "cpu":
        dl, db_rows = ce_grad_rows_plain(logits, targets, weights, lse,
                                         g.reshape(()), clamp)
        logits.copy_(dl)
        db.add_(db_rows)
        return logits
    if device.type != "cuda":
        raise ValueError(f"ce_grad_rows: unsupported device {device}")
    p = cuda_lib.ptr
    lib = _library()
    ws = torch.empty((lib.icee_ce_grad_ws(r, v),), dtype=torch.float32,
                     device=device)
    rc = lib.icee_ce_grad_rows(p(logits), p(targets), p(weights), p(lse),
                               p(g), p(db), 1, p(ws), ws.numel(), r, v,
                               *_clamp_args(clamp),
                               cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "ce_grad_rows")
    ce_grad_rows.launches += 1
    return logits


ce_grad_rows.launches = 0


# --- the chunked loss ---------------------------------------------------------

def _chunk_logits(x: torch.Tensor, head_w: torch.Tensor,
                  head_b: torch.Tensor) -> torch.Tensor:
    """One chunk (B, tc, H) -> its logits (B * tc, V), a plain product."""
    return torch.addmm(head_b, x.reshape(-1, x.shape[-1]), head_w)


class _WeightedCE(torch.autograd.Function):
    """sum(weights * nll) over (B, T), nll optionally clamped to
    ``min(nll, clamp)`` with zero gradient where the clamp bit."""

    @staticmethod
    def forward(ctx, hiddens, head_w, head_b, targets, weights, t_chunk,
                clamp):
        xc = _to_chunks(hiddens, t_chunk)
        tc = _to_chunks(targets.long(), t_chunk)
        wc = _to_chunks(weights, t_chunk)
        lses, contribs = [], []
        for k in range(xc.shape[0]):
            lse, contrib = ce_rows(_chunk_logits(xc[k], head_w, head_b),
                                   tc[k].reshape(-1), wc[k].reshape(-1),
                                   clamp)
            lses.append(lse)
            contribs.append(contrib)
        ctx.t_chunk, ctx.clamp = t_chunk, clamp
        ctx.save_for_backward(hiddens, head_w, head_b, targets, weights,
                              torch.stack(lses))
        return torch.cat(contribs).sum()

    @staticmethod
    def backward(ctx, g):
        hiddens, head_w, head_b, targets, weights, lses = ctx.saved_tensors
        b, t = targets.shape
        xc = _to_chunks(hiddens, ctx.t_chunk)
        tc = _to_chunks(targets.long(), ctx.t_chunk)
        wc = _to_chunks(weights, ctx.t_chunk)
        g = g.reshape(1).to(torch.float32).contiguous()
        d_w = torch.zeros_like(head_w)
        d_b = torch.zeros_like(head_b)
        dxs = []
        for k in range(xc.shape[0]):
            x = xc[k].reshape(-1, hiddens.shape[-1])
            dl = ce_grad_rows(_chunk_logits(xc[k], head_w, head_b),
                              tc[k].reshape(-1), wc[k].reshape(-1), lses[k],
                              g, d_b, ctx.clamp)
            dxs.append((dl @ head_w.T).reshape(b, ctx.t_chunk, -1))
            d_w.addmm_(x.T, dl)
        dx = torch.cat(dxs, dim=1)[:, :t]
        return dx, d_w, d_b, None, None, None, None


def _weighted_ce(hiddens, head_w, head_b, targets, weights, t_chunk,
                 clamp=None):
    return _WeightedCE.apply(hiddens, head_w, head_b, targets, weights,
                             t_chunk, clamp)


def masked_ce_from_hiddens(
    hiddens: torch.Tensor,            # (B, T, H)
    head_w: torch.Tensor,             # (H, V)
    head_b: torch.Tensor,             # (V,)
    targets: torch.Tensor,            # (B, T) int
    lengths: torch.Tensor,            # (B,)
    sample_mask: Optional[torch.Tensor] = None,  # (B,) bool
    t_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Token-mean masked CE, equal to ``masked_cross_entropy(hiddens @ head_w
    + head_b, ...)`` (``evaluation/metrics.py``) without the whole logits;
    weights ``mask / max(sum(mask), 1)`` over the whole batch."""
    b, t = targets.shape
    mask = (torch.arange(t, device=lengths.device)[None, :]
            < lengths[:, None])
    if sample_mask is not None:
        mask = mask & sample_mask[:, None].bool()
    weights = mask.to(torch.float32) / mask.sum().clamp(min=1)
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    return _weighted_ce(hiddens, head_w, head_b, targets, weights, t_chunk)


def masked_sum_ce_from_hiddens(
    hiddens: torch.Tensor,      # (B, T, H)
    head_w: torch.Tensor,       # (H, V)
    head_b: torch.Tensor,       # (V,)
    targets: torch.Tensor,      # (B, T) int
    mask: torch.Tensor,         # (B, T) float/bool weights
    clamp: Optional[float] = None,
    t_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Masked token-SUM CE (the SentiCap convention, ``mrnn.py:560-567``):
    ``sum(mask * min(nll, clamp))`` without the whole logits."""
    b, t = targets.shape
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    return _weighted_ce(hiddens, head_w, head_b, targets,
                        mask.to(torch.float32), t_chunk, clamp)


def masked_neglog2_sum_from_hiddens(
    hiddens: torch.Tensor,      # (B, T, H)
    head_w: torch.Tensor,       # (H, V)
    head_b: torch.Tensor,       # (V,)
    targets: torch.Tensor,      # (B, T) int
    mask: torch.Tensor,         # (B, T)
    t_chunk: Optional[int] = None,
) -> torch.Tensor:
    """``sum(mask * -log2(softmax(hh @ W + b)[y] + 1e-20))``, the SentiCap
    perplexity numerator (``mrnn.py:518-530``), without the whole (B, T, V)
    distributions (``icee_tpu/ops/chunked_loss.py:165``).  Value only.  Per
    chunk, :func:`ce_rows` gives nll = lse - target logit (no clamp), then
    p = exp(-nll) and the sum are one elementwise pass."""
    b, t = targets.shape
    if t_chunk is None:
        t_chunk = auto_t_chunk(b, t)
    with torch.no_grad():
        xc = _to_chunks(hiddens, t_chunk)
        tc = _to_chunks(targets.long(), t_chunk)
        wc = _to_chunks(mask.to(torch.float32), t_chunk)
        ones = torch.ones((b * t_chunk,), dtype=torch.float32,
                          device=hiddens.device)
        acc = torch.zeros((), dtype=torch.float32, device=hiddens.device)
        for k in range(xc.shape[0]):
            _, nll = ce_rows(_chunk_logits(xc[k], head_w, head_b),
                             tc[k].reshape(-1), ones)
            p = torch.exp(-nll)
            acc = acc + torch.sum(wc[k].reshape(-1) * -torch.log2(p + 1e-20))
    return acc


# --- the two-head mixture CE (the SentiCap switched loss) -------------------

PROB_FLOOR = 1e-37  # mrnn.py:563


def mixture_ce_rows_plain(logits_o: torch.Tensor, logits_n: torch.Tensor,
                          targets: torch.Tensor, co: torch.Tensor,
                          cn: torch.Tensor, weights: torch.Tensor):
    """Two heads' (R, V) logits -> (lse_o, lse_n, p_o, p_n, contrib), each
    (R,): ``p = exp(target logit - lse)`` per head and ``contrib = weights *
    -log(max(co p_o + cn p_n, 1e-37))``."""
    out = []
    for logits in (logits_o, logits_n):
        lse = torch.logsumexp(logits, dim=-1)
        tgt, _ = _target_logit(logits, targets)
        out.append((lse, torch.exp(tgt - lse)))
    (lse_o, p_o), (lse_n, p_n) = out
    p_mix = co * p_o + cn * p_n
    contrib = weights * -torch.log(torch.clamp(p_mix, min=PROB_FLOOR))
    return lse_o, lse_n, p_o, p_n, contrib


def mixture_ce_rows(logits_o: torch.Tensor, logits_n: torch.Tensor,
                    targets: torch.Tensor, co: torch.Tensor, cn: torch.Tensor,
                    weights: torch.Tensor):
    """The mixture CE's forward row pass over one chunk; see
    :func:`mixture_ce_rows_plain`."""
    device = logits_o.device
    r, v = _check_rows(logits_o, targets, weights, device)
    cuda_lib.check_tensor("logits_n", logits_n, (r, v), torch.float32,
                          device)
    for name, t in (("co", co), ("cn", cn)):
        cuda_lib.check_tensor(name, t, (r,), torch.float32, device)
    if device.type == "cpu":
        return mixture_ce_rows_plain(logits_o, logits_n, targets, co, cn,
                                     weights)
    if device.type != "cuda":
        raise ValueError(f"mixture_ce_rows: unsupported device {device}")
    out = [torch.empty((r,), dtype=torch.float32, device=device)
           for _ in range(5)]
    p = cuda_lib.ptr
    lib = _library()
    rc = lib.icee_mixture_rows(p(logits_o), p(logits_n), p(targets), p(co),
                               p(cn), p(weights), *(p(t) for t in out), r, v,
                               cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "mixture_ce_rows")
    mixture_ce_rows.launches += 1
    return tuple(out)


mixture_ce_rows.launches = 0


def mixture_row_cotangents(p_o, p_n, co, cn, weights, g):
    """The mixture CE's per-row cotangents -> (d_co, d_cn, fac_o, fac_n):
    with g_p = -(w g) live / max(p_mix, 1e-37), zero where the floor bit
    (``_mixture_bwd``), d_co = g_p p_o, d_cn = g_p p_n and each head's
    ``fac = g_p c p``, whose negation is :func:`ce_grad_rows`' per-row
    weight."""
    p_mix = co * p_o + cn * p_n
    live = (p_mix > PROB_FLOOR).to(torch.float32)
    g_p = -(weights * g) * live / torch.clamp(p_mix, min=PROB_FLOOR)
    return g_p * p_o, g_p * p_n, g_p * co * p_o, g_p * cn * p_n


class _MixtureCE(torch.autograd.Function):
    """sum(weights * -log(max(co p_o + cn p_n, 1e-37))) over (B, T), with
    ``p_* = softmax(hh_* w_* + b_*)[target]``."""

    @staticmethod
    def forward(ctx, hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets,
                weights, t_chunk):
        need = ctx.needs_input_grad
        xs = (_to_chunks(hh_o, t_chunk), _to_chunks(hh_n, t_chunk))
        coc, cnc = _to_chunks(co, t_chunk), _to_chunks(cn, t_chunk)
        tc = _to_chunks(targets.long(), t_chunk)
        wc = _to_chunks(weights, t_chunk)
        n, r = xs[0].shape[0], xs[0].shape[1] * xs[0].shape[2]
        # a head whose x, w or b needs a gradient keeps every chunk's
        # logits for the backward; the other writes one chunk of scratch
        keep = (any(need[i] for i in (0, 4, 5)),
                any(need[i] for i in (1, 6, 7)))
        bufs = [hh_o.new_empty((n if kp else 1, r, w.shape[1]))
                for w, kp in zip((w_o, w_n), keep)]
        rows, contribs = [], []
        for k in range(n):
            lo, ln = (torch.addmm(bias, x[k].reshape(r, -1), w,
                                  out=buf[k if kp else 0])
                      for x, w, bias, buf, kp in zip(
                          xs, (w_o, w_n), (b_o, b_n), bufs, keep))
            lse_o, lse_n, p_o, p_n, contrib = mixture_ce_rows(
                lo, ln, tc[k].reshape(-1), coc[k].reshape(-1),
                cnc[k].reshape(-1), wc[k].reshape(-1))
            rows.append(torch.stack([lse_o, lse_n, p_o, p_n]))
            contribs.append(contrib)
        ctx.t_chunk = t_chunk
        ctx.save_for_backward(hh_o, hh_n, co, cn, w_o, w_n, targets,
                              weights, torch.stack(rows),
                              *(buf if kp else None
                                for buf, kp in zip(bufs, keep)))
        return torch.cat(contribs).sum()

    @staticmethod
    def backward(ctx, g):
        (hh_o, hh_n, co, cn, w_o, w_n, targets, weights, rows, *kept
         ) = ctx.saved_tensors
        need = ctx.needs_input_grad
        b, t = targets.shape
        tch = ctx.t_chunk
        xs = (_to_chunks(hh_o, tch), _to_chunks(hh_n, tch))
        coc, cnc = _to_chunks(co, tch), _to_chunks(cn, tch)
        tc = _to_chunks(targets.long(), tch)
        wc = _to_chunks(weights, tch)
        g = g.reshape(()).to(torch.float32)
        one = torch.ones((1,), dtype=torch.float32, device=g.device)
        # per head: (chunks, w, kept logits, needs dx, needs dW)
        heads = [(xs[0], w_o, kept[0], need[0], need[4]),
                 (xs[1], w_n, kept[1], need[1], need[6])]
        dw = [torch.zeros_like(w_o), torch.zeros_like(w_n)]
        db = [torch.zeros((w_o.shape[1],), dtype=torch.float32,
                          device=g.device),
              torch.zeros((w_n.shape[1],), dtype=torch.float32,
                          device=g.device)]
        dxs, dcos, dcns = [[], []], [], []
        for k in range(xs[0].shape[0]):
            lse_o, lse_n, p_o, p_n = rows[k]
            d_co, d_cn, fac_o, fac_n = mixture_row_cotangents(
                p_o, p_n, coc[k].reshape(-1), cnc[k].reshape(-1),
                wc[k].reshape(-1), g)
            dcos.append(d_co.reshape(b, tch))
            dcns.append(d_cn.reshape(b, tch))
            for i, ((xc, w, logits, n_x, n_w), fac, lse) in enumerate(
                    zip(heads, (fac_o, fac_n), (lse_o, lse_n))):
                if logits is None:
                    continue
                dl = ce_grad_rows(logits[k], tc[k].reshape(-1),
                                  (-fac).contiguous(), lse, one, db[i])
                if n_x:
                    dxs[i].append((dl @ w.T).reshape(b, tch, -1))
                if n_w:
                    dw[i].addmm_(xc[k].reshape(-1, xc.shape[-1]).T, dl)

        def unchunk(parts):
            return torch.cat(parts, dim=1)[:, :t] if parts else None

        return (unchunk(dxs[0]), unchunk(dxs[1]), unchunk(dcos),
                unchunk(dcns), dw[0] if need[4] else None,
                db[0] if need[5] else None, dw[1] if need[6] else None,
                db[1] if need[7] else None, None, None, None)


def even_t_chunk(batch: int, t: int) -> int:
    """:func:`auto_t_chunk`'s number of chunks with T shared evenly among
    them, so that no chunk is padded with empty steps (B = 128, T = 22:
    two chunks of 11 steps, not 16 + 6 padded to 32)."""
    n = -(-t // auto_t_chunk(batch, t))
    return -(-t // n)


def mixture_ce_from_hiddens(
    hh_o: torch.Tensor,          # (B, T, H) background head input
    hh_n: torch.Tensor,          # (B, T, H) sentiment head input
    co: torch.Tensor,            # (B, T) background mixture coefficient
    cn: torch.Tensor,            # (B, T) sentiment mixture coefficient
    w_o: torch.Tensor, b_o: torch.Tensor,
    w_n: torch.Tensor, b_n: torch.Tensor,
    targets: torch.Tensor,       # (B, T) int
    weights: torch.Tensor,       # (B, T) float: mask (x CE reweighting)
    t_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Chunked ``sum(weights * -log(max(co p_o + cn p_n, 1e-37)))``, the
    SentiCap switched mixture CE (``icee_tpu/ops/chunked_loss.py:364``),
    in time chunks of equal length (:func:`even_t_chunk` by default).  The
    cotangents of ``co`` and ``cn`` are ``-w / p_mix * p_{o,n}``; floored
    tokens get zero gradient.  The logits of a head that needs a gradient
    are kept for the backward instead of recomputed (its whole (B, T, V)
    array, 99 MB at B = 128, T = 22, V = 8800); a head that needs none
    (switch training freezes the background head) keeps one chunk's
    scratch and costs the backward nothing."""
    b, t = targets.shape
    if t_chunk is None:
        t_chunk = even_t_chunk(b, t)
    return _MixtureCE.apply(hh_o, hh_n, co.to(torch.float32),
                            cn.to(torch.float32), w_o, b_o, w_n, b_n,
                            targets, weights.to(torch.float32), t_chunk)


def mixture_ce_plain(hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, targets,
                     weights, t_chunk: Optional[int] = None) -> torch.Tensor:
    """:func:`mixture_ce_from_hiddens` with each chunk's two softmaxes
    materialized, differentiated by autograd (every input's gradient)."""
    b, t = targets.shape
    if t_chunk is None:
        t_chunk = even_t_chunk(b, t)
    total = torch.zeros((), dtype=torch.float32, device=hh_o.device)
    for t0 in range(0, t, t_chunk):
        sl = slice(t0, t0 + t_chunk)
        y = targets[:, sl].long()[..., None]
        p_o = torch.softmax(hh_o[:, sl] @ w_o + b_o, -1).gather(-1, y)[..., 0]
        p_n = torch.softmax(hh_n[:, sl] @ w_n + b_n, -1).gather(-1, y)[..., 0]
        p_mix = co[:, sl] * p_o + cn[:, sl] * p_n
        total = total + torch.sum(weights[:, sl] * -torch.log(
            torch.clamp(p_mix, min=PROB_FLOOR)))
    return total


def mixture_neglog2_sum_from_hiddens(
    hh_o: torch.Tensor, hh_n: torch.Tensor,
    co: torch.Tensor, cn: torch.Tensor,
    w_o: torch.Tensor, b_o: torch.Tensor,
    w_n: torch.Tensor, b_n: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    t_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Two-head form of :func:`masked_neglog2_sum_from_hiddens`, the
    switched model's perplexity numerator ``sum(mask * -log2(co p_o + cn
    p_n + 1e-20))`` (``icee_tpu/ops/chunked_loss.py:194``).  Value only: per
    chunk the forward row pass :func:`mixture_ce_rows` gives p_o and p_n,
    then one elementwise pass."""
    b, t = targets.shape
    if t_chunk is None:
        t_chunk = even_t_chunk(b, t)
    with torch.no_grad():
        xo, xn = _to_chunks(hh_o, t_chunk), _to_chunks(hh_n, t_chunk)
        coc = _to_chunks(co.to(torch.float32), t_chunk)
        cnc = _to_chunks(cn.to(torch.float32), t_chunk)
        tc = _to_chunks(targets.long(), t_chunk)
        wc = _to_chunks(mask.to(torch.float32), t_chunk)
        ones = torch.ones((b * t_chunk,), dtype=torch.float32,
                          device=hh_o.device)
        acc = torch.zeros((), dtype=torch.float32, device=hh_o.device)
        for k in range(xo.shape[0]):
            c_o, c_n = coc[k].reshape(-1), cnc[k].reshape(-1)
            _, _, p_o, p_n, _ = mixture_ce_rows(
                _chunk_logits(xo[k], w_o, b_o),
                _chunk_logits(xn[k], w_n, b_n), tc[k].reshape(-1), c_o, c_n,
                ones)
            p = c_o * p_o + c_n * p_n
            acc = acc + torch.sum(wc[k].reshape(-1) * -torch.log2(p + 1e-20))
    return acc


def _library() -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    return cuda_lib.library("chunked_ce", {
        "icee_ce_rows": ([vp] * 5 + [i, i, f, i, vp], i),
        "icee_ce_grad_ws": ([i, i], ll),
        "icee_ce_grad_rows": ([vp] * 6 + [i, vp, ll, i, i, f, i, vp], i),
        "icee_mixture_rows": ([vp] * 11 + [i, i, vp], i)})
