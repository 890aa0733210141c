"""Masked beam search (port of ``icee_tpu/decode/beam.py``'s ``BeamResult``,
``beam_search`` and ``beam_search_batched``).

The reference beam (``stylenet/model.py:198-294``) shrinks the live beam
each step; this is the JAX package's proved-equivalent masked formulation:

- ``k`` slots persist for the whole decode; dead slots score ``-1e30``, so
  the flat top-``k`` over ``(k, width)`` returns the reference's candidates
  in descending-score order and "the top ``n_alive``" is ``rank < n_alive``,
- candidates that emit ``<end>`` fold into a running best-completed
  (score, sequence) with strict ``>`` — the reference's list-order tie-break,
- step 1 expands row 0 only (``model.py:239-241``),
- with no completion the result is the bare ``[<end>]`` (``model.py:288-289``).

``first_input`` gives the serving semantics (image feature fed at step 1,
``app/backend/model.py``); ``None`` reproduces the research path.

Every top-k here is :func:`top_k`: descending, ties to the lowest index, as
``lax.top_k`` — ``torch.topk`` promises no order among ties on CUDA.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30


class BeamResult(NamedTuple):
    """Best sequence per image (``<start>`` at position 0, ``<end>`` when
    present, padded with ``<end>``), its length and raw log-probability."""

    tokens: torch.Tensor   # (batch, max_len) int32
    length: torch.Tensor   # (batch,) int32
    score: torch.Tensor    # (batch,) float32


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, descending, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search_batched(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    step_fn: Optional[Callable],
    init_model_state: Tuple[torch.Tensor, ...],
    start_token: int,
    end_token: int,
    k: int,
    max_seq_length: int,
    vocab_size: int,
    batch: int,
    first_input: Optional[torch.Tensor] = None,
    step_topk_fn: Optional[Callable] = None,
) -> BeamResult:
    """Beam search for ``batch`` images at once on flat ``(batch*k, ...)``
    rows.

    ``step_fn(x, state) -> (logits (rows, V), state)`` is the full-vocab
    step.  ``step_topk_fn(x, state) -> (logp_top (rows, k), idx_top (rows,
    k), state)`` is the fused fast path (the K1 kernel): exactly equivalent,
    since the flat top-k of ``scores + logp`` only ever selects from each
    row's own top-k.  ``init_model_state`` leaves are ``(batch*k, ...)``;
    ``first_input`` is ``(batch, k, E)``.
    """
    device = init_model_state[0].device
    max_len = max_seq_length + 2
    rows = batch * k
    width = k if step_topk_fn is not None else vocab_size

    seqs = torch.full((batch, k, max_len), end_token, dtype=torch.long,
                      device=device)
    seqs[:, :, 0] = start_token
    rank = torch.arange(k, device=device)[None, :]            # (1, k)
    alive = torch.ones((batch, k), dtype=torch.bool, device=device)
    scores = torch.zeros((batch, k), dtype=torch.float32, device=device)
    prev_words = torch.full((batch, k), start_token, dtype=torch.long,
                            device=device)
    model_state = tuple(init_model_state)
    best_score = torch.full((batch,), NEG_INF, dtype=torch.float32,
                            device=device)
    best_seq = torch.full((batch, max_len), end_token, dtype=torch.long,
                          device=device)
    best_len = torch.zeros((batch,), dtype=torch.long, device=device)
    batch_base = torch.arange(batch, device=device)[:, None] * k

    # the reference checks the step bound after the body: steps 1..max+1
    for step in range(1, max_seq_length + 2):
        if not bool(alive.any()):
            break
        is_first = step == 1
        x = embed_fn(prev_words.reshape(rows))
        if is_first and first_input is not None:
            x = first_input.reshape(rows, -1).to(x.dtype)
        row_ok = (rank == 0).expand(batch, k) if is_first else alive

        if step_topk_fn is None:
            logits, model_state = step_fn(x, model_state)
            logp = torch.log_softmax(logits.float(), dim=-1)
            total = scores.reshape(rows, 1) + logp
            cand_words = None
        else:
            logp_top, idx_top, model_state = step_topk_fn(x, model_state)
            total = scores.reshape(rows, 1) + logp_top           # (rows, k)
            cand_words = idx_top.long()
        total = total.reshape(batch, k, width)
        total = torch.where(row_ok[:, :, None], total,
                            torch.full_like(total, NEG_INF))

        top_scores, idx = top_k(total.reshape(batch, k * width), k)
        prev_idx = idx // width                                  # (batch, k)
        if cand_words is None:
            words = idx % width
        else:
            words = torch.gather(cand_words.reshape(batch, k * width), 1, idx)

        n_take = k if is_first else alive.sum(dim=1, keepdim=True)
        valid = rank < n_take

        seqs = torch.gather(seqs, 1, prev_idx[:, :, None].expand(-1, -1, max_len))
        seqs[:, :, step] = words
        flat_gather = (batch_base + prev_idx).reshape(rows)
        model_state = tuple(leaf[flat_gather] for leaf in model_state)

        completed = valid & (words == end_token)
        still = valid & (words != end_token)

        comp_scores = torch.where(completed, top_scores,
                                  torch.full_like(top_scores, NEG_INF))
        i_best = torch.argmax(comp_scores, dim=1)                # first max
        step_best = torch.gather(comp_scores, 1, i_best[:, None])[:, 0]
        improves = step_best > best_score
        best_score = torch.where(improves, step_best, best_score)
        best_row = seqs[torch.arange(batch, device=device), i_best]
        best_seq = torch.where(improves[:, None], best_row, best_seq)
        best_len = torch.where(improves, torch.full_like(best_len, step + 1),
                               best_len)

        alive = still
        scores = torch.where(still, top_scores,
                             torch.full_like(top_scores, NEG_INF))
        prev_words = words

    has_any = best_score > NEG_INF / 2
    tokens = torch.where(has_any[:, None], best_seq,
                         torch.full_like(best_seq, end_token))
    length = torch.where(has_any, best_len, torch.ones_like(best_len))
    score = torch.where(has_any, best_score,
                        torch.full_like(best_score, NEG_INF))
    return BeamResult(tokens=tokens.to(torch.int32),
                      length=length.to(torch.int32), score=score)


def beam_search(
    embed_fn: Callable[[torch.Tensor], torch.Tensor],
    step_fn: Optional[Callable],
    init_model_state: Tuple[torch.Tensor, ...],
    start_token: int,
    end_token: int,
    k: int,
    max_seq_length: int,
    vocab_size: int,
    first_input: Optional[torch.Tensor] = None,
    step_topk_fn: Optional[Callable] = None,
) -> BeamResult:
    """The search for ONE image: :func:`beam_search_batched` at batch 1.

    ``init_model_state`` leaves have leading dim ``k``; ``first_input`` is
    an optional (k, E) step-1 input (serving semantics).  The step
    functions are :func:`beam_search_batched`'s over ``k`` rows.  ->
    BeamResult of ``tokens`` (max_seq_length + 2,), ``length`` () and
    ``score`` ().
    """
    res = beam_search_batched(
        embed_fn, step_fn, init_model_state, start_token, end_token, k,
        max_seq_length, vocab_size, batch=1,
        first_input=None if first_input is None else first_input[None],
        step_topk_fn=step_topk_fn)
    return BeamResult(tokens=res.tokens[0], length=res.length[0],
                      score=res.score[0])
