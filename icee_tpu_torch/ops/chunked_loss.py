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

The row passes are hand-written CUDA kernels (``csrc/chunked_ce.cu``); their
plain versions :func:`ce_rows_plain` and :func:`ce_grad_rows_plain` sit
beside them.  Each wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
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
    rc = lib.icee_ce_grad_rows(p(logits), p(targets), p(weights), p(lse),
                               p(g), p(db), 1, r, v, *_clamp_args(clamp),
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


def _library() -> ctypes.CDLL:
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_lib.library("chunked_ce", {
        "icee_ce_rows": ([vp] * 5 + [i, i, f, i, vp], i),
        "icee_ce_grad_rows": ([vp] * 6 + [i, i, i, f, i, vp], i)})
