"""The beam decode paths (port of ``icee_tpu/decode/fast.py``'s
``factored_candidates``, ``nic_candidates``, ``attention_candidates`` and
``nic_att_candidates``).

The JAX package probes a chain of candidates (mega kernel -> per-step fused
kernel -> XLA) and falls through on any exception.  Here the caller names
the path, and nothing falls back:

- ``"mega"``: the whole search in one K2 launch (``ops/beam.py``),
- ``"fused-step"``: :func:`~icee_tpu_torch.decode.beam.beam_search_batched`
  driving the K1 step kernel (``ops/decode_step.py``) once per step.

Both are token-identical on the card (they share the kernels' device
functions) and on the CPU (where both wrappers take their plain versions).

The NIC decoder has one path, :func:`nic_decode`: K2 with ``cell="lstm"``.
The JAX package's only other NIC candidate is the plain XLA beam, which
here is K2's plain version (the CPU path).

The attention decoders (:func:`attention_decode` for StyleNet+Att,
:func:`nic_att_decode` for NIC+Att) have the same two paths: ``"mega"``,
one K7 launch (``ops/att_beam.py``), and ``"fused-step"``, the Python beam
driving K6 (``ops/att_decode_step.py``) once per step from the h0/c0
kernel (``att_init_state``, K7's bits).
Their beams have the research semantics: step 1 embeds ``<start>``, and the
spatial features (batch, P, FS) enter through h0/c0 and the attention.

:func:`sharded_factored_decode` and :func:`sharded_attention_decode` (the
counterparts of JAX's ``sharded_mega_decode`` and
``sharded_mega_att_decode``) split a batch's images over a mesh's data
group: each rank runs one K2 (K7) search on its ``batch / n_data`` images
with the whole decoder, and the results are gathered to every rank.  A
search is independent per image, so the tokens are the one-card search's.
"""

from __future__ import annotations

from typing import Optional

import torch

from icee_tpu_torch.decode.beam import BeamResult, beam_search_batched
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.parallel.collectives import gather_rows
from icee_tpu_torch.parallel.data import row_slice

PATHS = ("mega", "fused-step")


def factored_decode(
    path: str,
    dec_params: dict,
    feats: Optional[torch.Tensor],
    style: int,
    batch: int,
    k: int,
    max_seq_length: int,
    start_token: int,
    end_token: int,
) -> BeamResult:
    """Beam-decode ``batch`` images through ``path``.

    ``feats`` (batch, k, E) is the step-1 input (serving semantics); None
    decodes with the research semantics (``<start>`` embedded at step 1).
    """
    if path == "mega":
        from icee_tpu_torch.ops.beam import mega_beam_decode

        return mega_beam_decode(
            dec_params, feats, style, batch, start_token=start_token,
            end_token=end_token, k=k, max_seq_length=max_seq_length)
    if path == "fused-step":
        from icee_tpu_torch.ops.decode_step import decode_step_topk

        def topk_step(x, state):
            h, c = state
            vals, idx, h2, c2 = decode_step_topk(dec_params, x, h, c, style,
                                                 ktop=k)
            return vals, idx, (h2, c2)

        hd = dec_params["W_w"].shape[0]
        zeros = torch.zeros((batch * k, hd), dtype=dec_params["C_w"].dtype,
                            device=dec_params["C_w"].device)
        return beam_search_batched(
            embed_fn=lambda t: fl.embed(dec_params, t), step_fn=None,
            init_model_state=(zeros, zeros.clone()),
            start_token=start_token, end_token=end_token, k=k,
            max_seq_length=max_seq_length,
            vocab_size=dec_params["C_w"].shape[1], batch=batch,
            first_input=feats, step_topk_fn=topk_step)
    raise ValueError(f"unknown decode path {path!r}; choose one of {PATHS}")


def nic_decode(
    dec_params: dict,
    feats: Optional[torch.Tensor],
    batch: int,
    k: int,
    max_seq_length: int,
    start_token: int,
    end_token: int,
) -> BeamResult:
    """Beam-decode ``batch`` images with the NIC decoder in one K2 launch
    (``cell="lstm"``); ``feats`` as in :func:`factored_decode`."""
    from icee_tpu_torch.ops.beam import mega_beam_decode

    return mega_beam_decode(
        dec_params, feats, 0, batch, start_token=start_token,
        end_token=end_token, k=k, max_seq_length=max_seq_length, cell="lstm")


def _att_decode(path: str, kind: str, dec_params: dict,
                spatial: torch.Tensor, style: int, batch: int, k: int,
                max_seq_length: int, start_token: int,
                end_token: int) -> BeamResult:
    if path == "mega":
        from icee_tpu_torch.ops.att_beam import mega_att_beam_decode

        return mega_att_beam_decode(
            dec_params, spatial, style, batch, start_token=start_token,
            end_token=end_token, k=k, max_seq_length=max_seq_length,
            kind=kind)
    if path == "fused-step":
        from icee_tpu_torch.models.attention import att_projection
        from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk,
                                                        att_init_state,
                                                        step_params)

        cell, att, gate = step_params(dec_params, kind, style)
        att1 = att_projection(att, spatial)
        h0, c0 = att_init_state(dec_params, spatial)
        emb = dec_params["B"] if kind == "factored" else dec_params["embed"]

        def topk_step(x, state):
            h, c = state
            vals, idx, h2, c2, _ = att_decode_step_topk(
                cell, att, gate, x, h, c, spatial, att1, kind, k, ktop=k)
            return vals, idx, (h2, c2)

        return beam_search_batched(
            embed_fn=lambda t: emb[t.long()], step_fn=None,
            init_model_state=(h0.repeat_interleave(k, dim=0),
                              c0.repeat_interleave(k, dim=0)),
            start_token=start_token, end_token=end_token, k=k,
            max_seq_length=max_seq_length, vocab_size=emb.shape[0],
            batch=batch, step_topk_fn=topk_step)
    raise ValueError(f"unknown decode path {path!r}; choose one of {PATHS}")


def attention_decode(path: str, dec_params: dict, spatial: torch.Tensor,
                     style: int, batch: int, k: int, max_seq_length: int,
                     start_token: int, end_token: int) -> BeamResult:
    """Beam-decode ``batch`` images' spatial features (batch, P, FS) with a
    StyleNet+Att decoder through ``path``; ``style`` selects S and the
    attention net."""
    return _att_decode(path, "factored", dec_params, spatial, style, batch,
                       k, max_seq_length, start_token, end_token)


def nic_att_decode(path: str, dec_params: dict, spatial: torch.Tensor,
                   batch: int, k: int, max_seq_length: int, start_token: int,
                   end_token: int) -> BeamResult:
    """Beam-decode ``batch`` images' spatial features with a NIC+Att
    decoder through ``path``."""
    return _att_decode(path, "lstm", dec_params, spatial, 0, batch, k,
                       max_seq_length, start_token, end_token)


def _gathered(res: BeamResult, mesh) -> BeamResult:
    """Each rank's rows of a search's results, stacked in data-rank order
    on every rank (:func:`~icee_tpu_torch.parallel.collectives.
    gather_rows`)."""
    return BeamResult(*(gather_rows(x.contiguous(), mesh.data_group,
                                    mesh.data_rank, mesh.n_data)
                        for x in res))


def sharded_factored_decode(dec_params: dict, feats: Optional[torch.Tensor],
                            style: int, mesh, batch: int, k: int,
                            max_seq_length: int, start_token: int,
                            end_token: int, cell: str = "factored"
                            ) -> BeamResult:
    """Data-parallel :func:`factored_decode` through ``"mega"`` (or, with
    ``cell="lstm"``, :func:`nic_decode`): this rank's rows of ``feats``
    (batch, k, E) (None: the research semantics), one K2 launch, the
    results of every rank.  ``batch`` must divide by the data axis."""
    rows = row_slice(batch, mesh)
    local = None if feats is None else feats[rows].contiguous()
    n = rows.stop - rows.start
    common = (k, max_seq_length, start_token, end_token)
    if cell == "lstm":
        res = nic_decode(dec_params, local, n, *common)
    else:
        res = factored_decode("mega", dec_params, local, style, n, *common)
    return _gathered(res, mesh)


def sharded_attention_decode(dec_params: dict, spatial: torch.Tensor,
                             style: int, mesh, batch: int, k: int,
                             max_seq_length: int, start_token: int,
                             end_token: int, kind: str = "factored"
                             ) -> BeamResult:
    """Data-parallel attention decode through ``"mega"``: this rank's rows
    of ``spatial`` (batch, P, FS), one K7 launch, the results of every
    rank; ``kind`` ``"factored"`` (StyleNet+Att) or ``"lstm"`` (NIC+Att)."""
    rows = row_slice(batch, mesh)
    res = _att_decode("mega", kind, dec_params,
                      spatial[rows].contiguous(), style,
                      rows.stop - rows.start, k, max_seq_length, start_token,
                      end_token)
    return _gathered(res, mesh)
