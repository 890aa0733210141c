"""Recurrent cell math in plain PyTorch (port of ``icee_tpu/ops/cells.py``'s
``factored_lstm_cell``).

Gate stacking as in the JAX package:

- ``V_w``: (E_in, 4F)   word/feature -> factored space, all gates at once
- ``S_w``: (num_styles, 4, F, F) per-style factor (selected by ``style``)
- ``U_w``: (4, F, H)    factored -> hidden
- ``W_w``: (H, 4H)      recurrent projection

Gate order is ``[i, f, o, c]``.  Reference quirk kept on purpose: the
FactoredLSTM emits ``h = o * c`` with NO tanh on the cell state
(``stylenet/model.py:153``); trained checkpoints depend on it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def factored_lstm_cell(
    params: dict,
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    style: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One FactoredLSTM step (``stylenet/model.py:115-155``).

    x: (B, E_in); h, c: (B, H); style: int id (0=factual, 1=happy, 2=sad,
    3=angry).  Returns (h_new, c_new) in the dtypes of h and c.
    """
    f_dim = params["U_w"].shape[1]
    h_dim = h.shape[-1]
    v = (x @ params["V_w"]).reshape(x.shape[0], 4, f_dim) + params["V_b"]
    s_w = params["S_w"][style]                       # (4, F, F)
    s_b = params["S_b"][style]                       # (4, F)
    s = torch.einsum("bgf,gfk->bgk", v, s_w) + s_b
    u = torch.einsum("bgf,gfh->bgh", s, params["U_w"]) + params["U_b"]
    w = (h @ params["W_w"]).reshape(h.shape[0], 4, h_dim) + params["W_b"]
    z = u + w
    i_t = torch.sigmoid(z[:, 0])
    f_t = torch.sigmoid(z[:, 1])
    o_t = torch.sigmoid(z[:, 2])
    g_t = torch.tanh(z[:, 3])
    c_new = f_t * c + i_t * g_t
    h_new = o_t * c_new  # reference quirk: no tanh (model.py:153)
    return h_new.to(h.dtype), c_new.to(c.dtype)
