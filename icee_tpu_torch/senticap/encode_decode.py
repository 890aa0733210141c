"""SentiCap encoder-decoder variant (port of
``icee_tpu/senticap/encode_decode.py``; reference ``mrnn_encode_decode.py``,
SURVEY C5; unused by the reference drivers but part of the family).

An encoder mRNN runs over a conditioning word sequence; its final hidden
state concatenates with the image feature to form the decoder's step-0
"visual" input (``mrnn_encode_decode.py:1017-1031``:
``v_i = concat([encoder_hh, v])``).  The decoder is the base mRNN with
``wvm`` widened to ``(H_enc + visual, E)``.

:func:`forward` calls the base model's ``forward`` without
``return_hiddens``, as the JAX package does, so the decoder runs the
model's own scan (no kernel) on every device, like the encoder.
"""

from __future__ import annotations

import math

import torch

from icee_tpu_torch.senticap.config import senticap_conf
from icee_tpu_torch.senticap.model import (cell, forward as base_forward,
                                           init_params as init_base, loss_fn)


def encdec_conf(**overrides):
    conf = senticap_conf(DECODER=True)
    conf.update(overrides)
    return conf


def init_params(generator: torch.Generator, vocab_size: int, conf,
                dtype=torch.float32, device="cpu") -> dict:
    """``{"encoder", "decoder"}``: two base mRNN parameter sets drawn from
    ``generator`` in turn, the decoder's ``wvm`` redrawn as ``(H + visual,
    E)``, uniform +-sqrt(6 / (H + visual + E))."""
    enc = init_base(generator, vocab_size, conf, dtype=dtype, device=device)
    dec = init_base(generator, vocab_size, conf, dtype=dtype, device=device)
    h, vis, e = conf["lstm_hidden_size"], conf["visual_size"], conf["emb_size"]
    # decoder's pseudo-word projection consumes [encoder_h ; v]
    a = math.sqrt(6.0 / (h + vis + e))
    u = torch.rand((h + vis, e), generator=generator, dtype=dtype,
                   device=generator.device)
    dec["wvm"] = (u * (2 * a) - a).to(device)
    return {"encoder": enc, "decoder": dec}


def encode(params: dict, conf: dict, encoder_words: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """Run the encoder mRNN over the conditioning words -> final hidden
    (the reference's ``encoder.start_step``)."""
    enc = params["encoder"]
    b, t = encoder_words.shape
    emb = enc["wemb"][encoder_words.long()]
    vis = v @ enc["wvm"] + enc["bmv"]
    h = torch.zeros((b, conf["lstm_hidden_size"]), dtype=emb.dtype,
                    device=emb.device)
    c = torch.zeros_like(h)
    for step in range(t):
        x_t = vis if step == 0 else emb[:, step]
        h, c = cell(enc, x_t, h, c, conf["GRAD_CLIP_SIZE"])
    return h


def forward(params: dict, conf: dict, words: torch.Tensor,
            encoder_words: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Decoder teacher-forced scan conditioned on [encoder_h ; v]."""
    enc_h = encode(params, conf, encoder_words, v)
    cond = torch.cat([enc_h, v], dim=-1)
    return base_forward(params["decoder"], conf, words, cond,
                        use_visual=True, x_drop=None, y_drop=None)


def loss(params: dict, conf: dict, words: torch.Tensor, y: torch.Tensor,
         mask: torch.Tensor, encoder_words: torch.Tensor, v: torch.Tensor
         ) -> torch.Tensor:
    return loss_fn(forward(params, conf, words, encoder_words, v), y, mask)
