"""Widths that are not a multiple of 4 on the decode and attention kernels.

K1, K2, K5, K6 and K7 read their weights (and the attention kernels their
features and att1) as float4 column quads, so each width they index in
memory, F, H, V, A and FS, must be a multiple of 4 there.  A model of any
width runs on them through a padded layout that the wrappers make: every
such width rounded up to :func:`quad`, the weights copied into zeros (the
head's bias into ``LOGIT_FILL``), then the kernel at the padded widths and
its outputs cut back to the true ones.  The padded copy of a weight set is
made once and kept while its tensors are unchanged
(:func:`~icee_tpu_torch.ops.cuda_lib.checked_weights`), never once a step.

Why the results are the unpadded model's:

* a padded F, A or FS entry is 0 in every weight that produces it and in
  every weight that reads it, so it adds exact zeros to each sum that
  crosses it (``fmaf(0, w, s) == s``);
* a padded hidden unit has zero pre-activations, so its gates are 1/2 and
  its cell input tanh 0 = 0: c' = c / 2 + 0 = 0 from c = 0, h' = 0, and it
  stays 0 every step;
* a padded vocabulary column's logit is ``LOGIT_FILL`` = -1e30: exp of it
  less the row's max is exactly 0 in logZ (never ``inf - inf``, as -inf
  could give), it ranks below every real logit, and its id, past V - 1,
  loses every tie.

The plain versions run at the true widths; the CPU tests hold the plain
version on the padded layout, cut back, to the JAX package at the true
width (``tests/test_torch_widths.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib

QUAD = 4             # floats a kernel reads at once along a width
LOGIT_FILL = -1e30   # the head bias of a padded vocabulary column

# The axes of every weight the five kernels read, by name, in the trees
# their wrappers take: a token per axis, "4H" a gate-stacked axis (four
# blocks of H), a number an axis that is never padded, X the input rows
# (E, then FS for the attention cells).  A tensor with one axis more than
# its entry carries a leading stack axis (styles), kept as it is.
AXES = {
    # the factored cell (K1, K2, K6, K7) and its head
    "V_w": "X 4F", "V_b": "4 F", "S_w": "4 F F", "S_b": "4 F",
    "U_w": "4 F H", "U_b": "4 H", "W_w": "H 4H", "W_b": "4 H",
    "C_w": "H V", "C_b": "V",
    # the torch LSTM cell (K2 lstm, K6, K7) and the NIC head
    "W_ih": "X 4H", "b_ih": "4H", "W_hh": "H 4H", "b_hh": "4H",
    "linear_w": "H V", "linear_b": "V",
    # the embedding tables (read a row at a time: padded only so that a
    # whole decoder padded for a plain search stays consistent)
    "B": "V E", "embed": "V E",
    # the attention net, its gate and h0 / c0 (K6, K7, K5)
    "enc_w": "FS A", "enc_b": "A", "dec_w": "H A", "dec_b": "A",
    "full_w": "A 1", "full_b": "1",
    "f_beta_w": "H FS", "f_beta_b": "FS", "fb_w": "H FS", "fb_b": "FS",
    "init_h_w": "FS H", "init_h_b": "H", "init_c_w": "FS H",
    "init_c_b": "H",
    # K5's kernel-facing cells: the input matrices split by rows
    "V_we": "E 4F", "V_wc": "FS 4F", "W_ihe": "E 4H", "W_ihc": "FS 4H",
}
FILLS = {"C_b": LOGIT_FILL, "linear_b": LOGIT_FILL}

Widths = Dict[str, Tuple[int, int]]


def quad(n: int) -> int:
    """``n`` rounded up to a multiple of ``QUAD``."""
    return -(-n // QUAD) * QUAD


def widths(pad: Tuple[str, ...] = ("F", "H", "V", "A", "FS"),
           **dims: int) -> Widths:
    """{name: (true width, padded width)} of ``dims``: the names in
    ``pad`` rounded up to :func:`quad`, the others kept (E, and what a
    kernel reads one float at a time).  ``X`` (the input rows) is E + FS
    padded in its FS part where ``FS`` is given, else E."""
    out = {name: (n, quad(n) if name in pad else n)
           for name, n in dims.items()}
    e = dims.get("E", 0)
    fs = out.get("FS", (0, 0))
    out.setdefault("X", (e + fs[0], e + fs[1]))
    return out


def ragged(w: Widths) -> bool:
    """Whether any width of ``w`` grows."""
    return any(n != np for n, np in w.values())


def _axis(token: str, w: Widths) -> Tuple[int, int, int]:
    """(blocks, true width, padded width) of one axis token."""
    if token.isdigit():
        return 1, int(token), int(token)
    blocks, name = (4, token[1:]) if token[0] == "4" else (1, token)
    n, np_ = w[name]
    return blocks, n, np_


def pad(t: torch.Tensor, axes: str, w: Widths,
        fill: float = 0.0) -> torch.Tensor:
    """``t`` laid out at the padded widths: a new contiguous tensor holding
    ``t`` in the leading corner of each (block of each) axis and ``fill``
    elsewhere; ``t`` itself where no axis grows."""
    tokens = axes.split()
    lead = list(t.shape[:t.dim() - len(tokens)])
    view, grown, shape = list(lead), list(lead), list(lead)
    for token in tokens:
        blocks, n, np_ = _axis(token, w)
        if blocks > 1:
            view += [blocks, n]
            grown += [blocks, np_]
        else:
            view.append(n)
            grown.append(np_)
        shape.append(blocks * np_)
    if view == grown:
        return t
    out = t.new_full(grown, fill)
    out[tuple(slice(0, n) for n in view)] = t.reshape(view)
    return out.view(shape)


def cut(t: torch.Tensor, axes: str, w: Widths) -> torch.Tensor:
    """The inverse of :func:`pad`: the leading corner of each (block of
    each) axis of ``t``, laid out at the second widths of ``w``, at its
    first widths; contiguous."""
    tokens = axes.split()
    lead = list(t.shape[:t.dim() - len(tokens)])
    view, index, shape = list(lead), [slice(None)] * len(lead), list(lead)
    for token in tokens:
        blocks, n, np_ = _axis(token, w)
        if blocks > 1:
            view += [blocks, np_]
            index += [slice(None), slice(0, n)]
        else:
            view.append(np_)
            index.append(slice(0, n))
        shape.append(blocks * n)
    return t.reshape(view)[tuple(index)].reshape(shape).contiguous()


def pad_tree(tree: dict, w: Widths, fn=None) -> dict:
    """``tree`` with every weight named in ``AXES`` padded (:func:`pad`;
    or given to ``fn(tensor, axes, w)``, e.g. :func:`cut`), nested trees
    likewise, other entries as they are."""
    out = {}
    for name, t in tree.items():
        if isinstance(t, dict):
            out[name] = pad_tree(t, w, fn)
        elif name in AXES and isinstance(t, torch.Tensor):
            out[name] = (fn(t, AXES[name], w) if fn is not None
                         else pad(t, AXES[name], w, FILLS.get(name, 0.0)))
        else:
            out[name] = t
    return out


def checked(w: Widths, held) -> tuple:
    """A wrapper's ``cuda_lib.checked_weights`` result ``(w, held)``,
    marked as holding copies of the weights where a width grows (then
    ``held`` points into a padded copy)."""
    return (cuda_lib.Copies if ragged(w) else tuple)((w, held))


def pad_last(t: torch.Tensor, n_padded: int) -> torch.Tensor:
    """``t`` with its last axis grown to ``n_padded`` by zeros (a step's h
    or c, the features' FS, att1's A); ``t`` itself where it is that
    wide."""
    n = t.shape[-1]
    if n == n_padded:
        return t
    out = t.new_zeros((*t.shape[:-1], n_padded))
    out[..., :n] = t
    return out


def cut_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` entries of ``t``'s last axis, contiguous; ``t``
    itself where it is that wide."""
    return t if t.shape[-1] == n else t[..., :n].contiguous()
