"""Recurrent cell math in plain PyTorch (port of ``icee_tpu/ops/cells.py``:
``factored_lstm_cell``, ``lstm_cell`` and ``multilayer_lstm_cell``).

Gate stacking as in the JAX package:

- ``V_w``: (E_in, 4F)   word/feature -> factored space, all gates at once
- ``S_w``: (num_styles, 4, F, F) per-style factor (selected by ``style``)
- ``U_w``: (4, F, H)    factored -> hidden
- ``W_w``: (H, 4H)      recurrent projection

Gate order is ``[i, f, o, c]`` for the factored cell and torch's
``[i, f, g, o]`` for the standard cell (so torch LSTM checkpoints import as
a transpose).  Reference quirk kept on purpose: the FactoredLSTM emits
``h = o * c`` with NO tanh on the cell state (``stylenet/model.py:153``);
trained checkpoints depend on it.  The standard cell has the real tanh.
"""

from __future__ import annotations

from typing import List, Tuple

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


def lstm_cell(params: dict, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard LSTM cell = torch ``nn.LSTMCell`` (``nic/model.py:51``).

    params: ``W_ih`` (E, 4H), ``W_hh`` (H, 4H), ``b_ih``/``b_hh`` (4H,), gate
    order [i, f, g, o] along the 4H axis.  The sum keeps the JAX float
    order, ``((x W_ih + b_ih) + h W_hh) + b_hh``: folding the two biases
    into one vector would change the bits.
    """
    z = x @ params["W_ih"] + params["b_ih"] + h @ params["W_hh"] \
        + params["b_hh"]
    h_dim = h.shape[-1]
    i_t = torch.sigmoid(z[..., 0 * h_dim:1 * h_dim])
    f_t = torch.sigmoid(z[..., 1 * h_dim:2 * h_dim])
    g_t = torch.tanh(z[..., 2 * h_dim:3 * h_dim])
    o_t = torch.sigmoid(z[..., 3 * h_dim:4 * h_dim])
    c_new = f_t * c + i_t * g_t
    h_new = o_t * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def multilayer_lstm_cell(params_layers: List[dict], x: torch.Tensor,
                         h: torch.Tensor, c: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack of standard LSTM cells = one torch ``nn.LSTM`` step
    (``seq2seq/model.py:46-49``).  h, c: (num_layers, B, H).  -> (top
    hidden, h_new, c_new)."""
    hs, cs = [], []
    inp = x
    for layer, p in enumerate(params_layers):
        h_new, c_new = lstm_cell(p, inp, h[layer], c[layer])
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return inp, torch.stack(hs), torch.stack(cs)
