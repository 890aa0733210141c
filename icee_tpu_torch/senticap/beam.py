"""SentiCap beam search: length-normalized log2 beams (port of
``icee_tpu/senticap/beam.py``).

Parity target: ``decoder_beamsearch`` / ``decoder_beamsearch_with_attention``
(``mrnn_algorithms.py:113-209``):

- scores are ``-log2 p`` accumulated per word; the live beam is pruned by
  the accumulated score each step,
- a sequence completes on token 0 (STOP) or at length ``max_len + 1``;
  completed results carry the length-normalized score ``lp / count``; the
  best (lowest) wins,
- ``with_attention`` (the switched model) also records, per emitted token,
  the switch gate of the step that emitted it, for test-time highlighting.

Two implementations, token-equivalent (tested):

- :func:`beam_decode`, the host loop around a one-step function (the
  reference's compiled-function protocol), in numpy: the oracle;
- :func:`make_device_beam`, the whole search as shape-stable masked beams in
  plain PyTorch, batched over images (the JAX package vmaps one image's
  search; here the image axis is written out).  It is the plain version of
  K9 (``ops/senticap_decode.py``).  Top-k is a stable sort: ties go to the
  lowest index, as ``lax.top_k``.  With ``with_attention`` it is the plain
  version of K10 (``ops/senticap_switched_decode.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def beam_decode(one_step_fn, v, beam_size: int = 20, max_len: int = 20,
                stop_token: int = 0, with_attention: bool = False):
    """-> (best_norm_log2prob, token_list[, attention_trace]).

    ``one_step_fn(words (B,), use_v bool, h, c) -> (s_t (B, V), h, c[, att
    (B, 1)])`` with state batched over live beams; the first call is made
    with the visual flag set, a dummy word and ``h = c = None``.  With
    ``with_attention`` each token's trace entry is the gate of the step
    that emitted it."""
    out = one_step_fn(np.zeros((1,), np.int64), True, None, None)
    s_t, h, c = out[:3]
    att = _np(out[3]) if with_attention else None
    # beam entries: (norm_lp, lp, count, words, row, trace)
    beams = [(0.0, 0.0, 0, [], 0, [])]
    state_h, state_c = _np(h), _np(c)
    probs = _np(s_t)
    results: List[Tuple[float, int, List[int], List[float]]] = []

    for _ in range(max_len + 1):
        candidates = []
        for norm_lp, lp, cnt, words, row, trace in beams:
            all_lp = -np.log2(probs[row] + 1e-37)
            best_idx = np.argsort(all_lp)[:beam_size]
            new_trace = trace + ([float(att[row, 0])] if with_attention
                                 else [])
            for i in best_idx:
                new_lp = lp + float(all_lp[i])
                new_words = words + [int(i)]
                if i == stop_token or cnt == max_len:
                    results.append((new_lp / (cnt + 1), cnt + 1, new_words,
                                    new_trace))
                else:
                    candidates.append((new_lp / (cnt + 1), new_lp, cnt + 1,
                                       new_words, row, new_trace))
        candidates.sort(key=lambda x: x[0])
        candidates = candidates[:beam_size]
        if not candidates:
            break
        # advance all surviving beams in one batched step
        rows = np.asarray([c_[4] for c_ in candidates])
        words_in = np.asarray([c_[3][-1] for c_ in candidates], np.int64)
        out = one_step_fn(words_in, False, state_h[rows], state_c[rows])
        probs, state_h, state_c = (_np(a) for a in out[:3])
        att = _np(out[3]) if with_attention else None
        beams = [(c_[0], c_[1], c_[2], c_[3], j, c_[5])
                 for j, c_ in enumerate(candidates)]

    results.sort(key=lambda x: x[0])
    best = results[0]
    if with_attention:
        return best[0], best[2], best[3]
    return best[0], best[2]


def make_device_beam(step_fn, state_width: int, beam_size: int = 20,
                     max_len: int = 20, stop_token: int = 0,
                     with_attention: bool = False):
    """Whole-search beam over a batch of images: returns ``run(v (N,
    visual)) -> (score (N,), tokens (N, max_len + 1), length (N,)[,
    att_trace (N, max_len + 1)])``, the JAX package's ``decode.run`` with
    the image axis written out.

    ``step_fn(words (N, B), use_v bool, h (N, B, S), c (N, B, S), v (N,
    visual)) -> (s_t (N, B, V), h, c[, att (N, B, 1)])``.  Semantics of the
    JAX search (``senticap/beam.py:129-185``): per beam the ``beam_size``
    lowest ``-log2(p + 1e-37)`` tokens are candidates; completed candidates
    (stop token, or the last step) replace the running best by
    length-normalized score only when strictly lower, the first (row-major,
    then rank) among equals; survivors are the ``beam_size`` lowest
    accumulated scores among non-completed candidates, ties to the lowest
    candidate index.  With ``with_attention`` a candidate's trace is its
    parent's with ``[t]`` set to the gate of the step that emitted the
    token; survivors gather their parents' traces and the best completed
    candidate keeps its own (zeros past its length)."""
    B, L = beam_size, max_len + 1

    def run(v: torch.Tensor):
        n, dev = v.shape[0], v.device
        zeros = torch.zeros((n, B, state_width), dtype=v.dtype, device=dev)
        out = step_fn(torch.zeros((n, B), dtype=torch.long, device=dev),
                      True, zeros, zeros.clone(), v)
        probs, h, c = out[:3]
        att = out[3][..., 0] if with_attention else None        # (n, B)
        inf = torch.tensor(float("inf"), device=dev)
        lp = torch.full((n, B), float("inf"), device=dev)
        lp[:, 0] = 0.0                         # only beam 0 live at t = 0
        seqs = torch.full((n, B, L), stop_token, dtype=torch.long, device=dev)
        b_sc = torch.full((n,), float("inf"), device=dev)
        b_seq = torch.full((n, L), stop_token, dtype=torch.long, device=dev)
        b_len = torch.ones((n,), dtype=torch.long, device=dev)
        trace = torch.zeros((n, B, L), device=dev)
        b_att = torch.zeros((n, L), device=dev)
        img = torch.arange(n, device=dev)
        for t in range(L):
            nll = -torch.log2(probs + 1e-37)
            srt, order = torch.sort(nll, dim=-1, stable=True)
            top, tok = srt[..., :B], order[..., :B]            # (n, B, B)
            cand_lp = lp[:, :, None] + top
            is_stop = (tok == stop_token) | (t == max_len)
            norm = cand_lp / float(t + 1)

            # completed candidates -> running best (first minimum:
            # beam-row major, then rank)
            res = torch.where(is_stop, norm, inf).reshape(n, B * B)
            ci = torch.argmin(res, dim=1)
            row, rk = ci // B, ci % B
            cand_seq = seqs[img, row].clone()
            cand_seq[:, t] = tok[img, row, rk]
            improves = res[img, ci] < b_sc
            b_sc = torch.where(improves, res[img, ci], b_sc)
            b_seq = torch.where(improves[:, None], cand_seq, b_seq)
            b_len = torch.where(improves, torch.full_like(b_len, t + 1), b_len)
            if with_attention:
                cand_att = trace[img, row].clone()
                cand_att[:, t] = att[img, row]
                b_att = torch.where(improves[:, None], cand_att, b_att)
            if t == max_len:
                break

            # survivors: the beam_size lowest accumulated scores
            live = torch.where(is_stop, inf, cand_lp).reshape(n, B * B)
            sv, sel = torch.sort(live, dim=1, stable=True)
            lp, sel = sv[:, :B], sel[:, :B]
            parent = sel // B
            words = tok.reshape(n, B * B).gather(1, sel)
            gather = parent[..., None]
            h = h.gather(1, gather.expand(-1, -1, h.shape[-1]))
            c = c.gather(1, gather.expand(-1, -1, c.shape[-1]))
            seqs = seqs.gather(1, gather.expand(-1, -1, L)).clone()
            seqs[:, :, t] = words
            if with_attention:
                trace = trace.gather(1, gather.expand(-1, -1, L)).clone()
                trace[:, :, t] = att.gather(1, parent)
            out = step_fn(words, False, h, c, v)
            probs, h, c = out[:3]
            att = out[3][..., 0] if with_attention else None
        if with_attention:
            return b_sc, b_seq, b_len, b_att
        return b_sc, b_seq, b_len

    return run
