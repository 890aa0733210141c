"""Seq2seq style-transfer family (port of ``icee_tpu/models/seq2seq.py``).

Parity target: ``EncoderRNN`` / ``DecoderRNN`` / ``Seq2Seq``
(``seq2seq/model.py:30-301``, SURVEY.md M8): an LSTM encoder over the factual
caption prefixed by the image feature, and one decoder LSTM per emotion.  The
encoder's final (h, c) reaches the emotion decoders only at SAMPLE time —
the reference's ``DecoderRNN.forward`` takes the states argument but zeroes
its own h/c (``model.py:168-176``), a quirk kept here.

The three per-emotion decoders are one stacked parameter set ``(3, ...)``
in (happy, sad, angry) order, selected by an emotion id, as in the JAX
package; one optimizer over the stacked tensors then behaves as JAX's.

Init parity: this family never calls a reset, so parameters keep torch
defaults — ``nn.Embedding`` ~ N(0,1), ``nn.LSTM``/``nn.Linear`` ~
U(-1/sqrt(fan)).

The JAX package runs this family in ``lax.scan`` and reaches no Pallas
kernel; here the loops are PyTorch's on every device.  Randomness as in
:mod:`icee_tpu_torch.models.factored_lstm`: the dropout keep-mask (B, T, E)
and the teacher-forcing coins (T,) come from a ``torch.Generator`` or are
passed in (``keep``, ``coins``), which is how the tests hand the port the
JAX PRNG's draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import Seq2SeqConfig
from icee_tpu_torch.models.lstm import (init_multilayer,
                                        multilayer_initial_state)
from icee_tpu_torch.ops.cells import multilayer_lstm_cell

State = Tuple[torch.Tensor, torch.Tensor]  # (num_layers, B, H) each


def _init_half(generator: torch.Generator, cfg: Seq2SeqConfig, dtype,
               device) -> dict:
    """One encoder-or-decoder parameter set (embed + LSTM stack + head)."""
    e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
    embed = torch.randn((v, e), generator=generator, dtype=dtype,
                        device=generator.device).to(device)
    return {
        "embed": embed,
        "lstm": init_multilayer(generator, e, h, cfg.num_layers, dtype,
                                xavier=False, device=device),
        "linear_w": init.torch_linear_default(generator, (h, v), h, dtype,
                                              device),
        "linear_b": init.torch_linear_default(generator, (v,), h, dtype,
                                              device),
    }


def stack_trees(trees):
    """Leafwise ``torch.stack`` of same-shaped trees (dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def _take(tree, emotion: int):
    if isinstance(tree, dict):
        return {k: _take(v, emotion) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take(v, emotion) for v in tree)
    return tree[emotion]


def init_params(generator: torch.Generator, cfg: Seq2SeqConfig,
                dtype=torch.float32, device="cpu") -> dict:
    """``{"encoder": half, "decoders": three halves stacked on axis 0 in
    (happy, sad, angry) order}``, drawn from ``generator`` (not the JAX
    package's numbers; parity tests move the JAX params across with
    :mod:`icee_tpu_torch.bridge`)."""
    encoder = _init_half(generator, cfg, dtype, device)
    decoders = [_init_half(generator, cfg, dtype, device) for _ in range(3)]
    return {"encoder": encoder, "decoders": stack_trees(decoders)}


def select_decoder(params: dict, emotion) -> dict:
    """Emotion id (0=happy, 1=sad, 2=angry) -> that decoder's parameters
    (views into the stacked tensors: a gradient through them lands in that
    emotion's slice only)."""
    return _take(params["decoders"], int(emotion))


def _scheduled_rnn(half: dict, cfg: Seq2SeqConfig, tokens: torch.Tensor,
                   prefix: Optional[torch.Tensor], state: Optional[State],
                   teacher_forcing_ratio: float,
                   generator: Optional[torch.Generator], train: bool,
                   return_hiddens: bool = False, keep=None,
                   coins: Optional[Sequence[bool]] = None
                   ) -> Tuple[torch.Tensor, State]:
    """Shared teacher-forced loop (``seq2seq/model.py:68-98,162-191``).

    Dropout on the token embeddings (not on the prefix, nor on a free
    step's input, the UN-dropped embedding of the previous argmax).  Step t
    consumes the teacher input where coin t is set, else the embedding of
    the previous step's argmax (step 0's "previous" is ``tokens[:, 0]``).
    With ``return_hiddens`` the loop emits the top-layer hidden states
    (B, T, H) instead of logits, for the chunked training loss; the head
    then runs on the detached hidden state, only where the next step needs
    its argmax.  At ratio >= 1 (no ``coins`` given) every coin is set."""
    b, t = tokens.shape
    device = tokens.device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    emb = half["embed"][tokens.long()]
    if train and cfg.dropout > 0.0:
        if keep is None:
            keep = torch.rand(tuple(emb.shape), generator=generator,
                              device=generator.device) < 1.0 - cfg.dropout
        if not torch.is_tensor(keep):
            keep = torch.from_numpy(np.array(keep, copy=True))
        keep = keep.to(device).bool()
        emb = torch.where(keep, emb / (1.0 - cfg.dropout), 0.0)
    if prefix is not None:
        teacher_inputs = torch.cat([prefix[:, None, :].to(emb.dtype),
                                    emb[:, :-1]], dim=1)
    else:
        teacher_inputs = emb
    if coins is None and float(teacher_forcing_ratio) < 1.0:
        coins = torch.rand((t,), generator=generator,
                           device=generator.device) < teacher_forcing_ratio
    if coins is None:
        coins = [True] * t
    else:    # one host read of the T coins
        coins = [bool(c) for c in (coins.cpu().tolist() if torch.is_tensor(
            coins) else np.asarray(coins).tolist())]
    if state is None:
        state = multilayer_initial_state(cfg.num_layers, b, cfg.hidden_size,
                                         emb.dtype, device)
    h, c = state
    prev = tokens[:, 0].long()
    outs = []
    for step in range(t):
        x = teacher_inputs[:, step] if coins[step] else half["embed"][prev]
        top, h, c = multilayer_lstm_cell(half["lstm"], x, h, c)
        if return_hiddens:
            outs.append(top)
            if step + 1 < t and not coins[step + 1]:
                logits = top.detach() @ half["linear_w"] + half["linear_b"]
                prev = torch.argmax(logits, dim=-1)
        else:
            logits = top @ half["linear_w"] + half["linear_b"]
            outs.append(logits)
            prev = torch.argmax(logits, dim=-1)
    return torch.stack(outs, dim=1), (h, c)


def encode(params: dict, cfg: Seq2SeqConfig, features: torch.Tensor,
           src_tokens: torch.Tensor, teacher_forcing_ratio: float = 0.5,
           generator: Optional[torch.Generator] = None, train: bool = True,
           return_hiddens: bool = False, keep=None, coins=None
           ) -> Tuple[torch.Tensor, State]:
    """EncoderRNN.forward: feature-prefixed autoencoding pass
    (``seq2seq/model.py:68-98``) -> (logits or hiddens, final state)."""
    return _scheduled_rnn(params["encoder"], cfg, src_tokens, features, None,
                          teacher_forcing_ratio, generator, train,
                          return_hiddens, keep, coins)


def decode_emotion(params: dict, cfg: Seq2SeqConfig, state: Optional[State],
                   dst_tokens: torch.Tensor, emotion,
                   teacher_forcing_ratio: float = 0.5,
                   generator: Optional[torch.Generator] = None,
                   train: bool = True, return_hiddens: bool = False,
                   keep=None, coins=None) -> torch.Tensor:
    """Per-emotion DecoderRNN.forward (``seq2seq/model.py:162-191``).

    Reference quirk kept: ``DecoderRNN.forward`` accepts the encoder's final
    ``states`` but never reads them — it builds fresh zero h/c
    (``seq2seq/model.py:168-176``), so the emotion decoder TRAINS from a zero
    state and only ``sample`` threads the encoder state.  ``state`` stays
    in the signature for the reference's call shape, and is ignored."""
    del state  # dead in the reference's training forward (model.py:168-176)
    half = select_decoder(params, emotion)
    out, _ = _scheduled_rnn(half, cfg, dst_tokens, None, None,
                            teacher_forcing_ratio, generator, train,
                            return_hiddens, keep, coins)
    return out


def forward(params: dict, cfg: Seq2SeqConfig, features: torch.Tensor,
            src: Tuple[torch.Tensor, torch.Tensor],
            dst: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            emotion=None, teacher_forcing_ratio: float = 0.8,
            generator: Optional[torch.Generator] = None, train: bool = True):
    """Seq2Seq.forward (``seq2seq/model.py:256-283``): factual mode returns
    the encoder logits; emotion modes continue with that emotion's decoder
    (the training steps call :func:`encode` / :func:`decode_emotion`
    themselves, with their injected draws)."""
    src_tokens, _src_len = src
    enc_logits, state = encode(params, cfg, features, src_tokens,
                               teacher_forcing_ratio, generator, train)
    if emotion is None:
        return enc_logits
    dst_tokens, _dst_len = dst
    return decode_emotion(params, cfg, state, dst_tokens, emotion,
                          teacher_forcing_ratio, generator, train)


@torch.no_grad()
def greedy_sample(params: dict, cfg: Seq2SeqConfig, features: torch.Tensor,
                  start_token: int, emotion=None) -> torch.Tensor:
    """Seq2Seq.sample (``seq2seq/model.py:285-301``): greedy encoder rollout
    from the image feature; for emotion modes, continue greedily with that
    emotion's decoder from the encoder's final state.  -> (B, L) int64
    ids, L = ``cfg.max_seq_length``."""
    b = features.shape[0]

    def rollout(half, x, state):
        h, c = state
        preds: List[torch.Tensor] = []
        for _ in range(cfg.max_seq_length):
            top, h, c = multilayer_lstm_cell(half["lstm"], x, h, c)
            pred = torch.argmax(top @ half["linear_w"] + half["linear_b"],
                                dim=-1)
            preds.append(pred)
            x = half["embed"][pred]
        return torch.stack(preds, dim=1), (h, c)

    state0 = multilayer_initial_state(cfg.num_layers, b, cfg.hidden_size,
                                      features.dtype, features.device)
    enc_ids, enc_state = rollout(params["encoder"], features, state0)
    if emotion is None:
        return enc_ids
    # Reference quirk kept: the emotion decoder continues from the encoder's
    # *greedy rollout* final state (Seq2Seq.sample's states threading,
    # seq2seq/model.py:285-301).
    half = select_decoder(params, emotion)
    start = torch.full((b,), int(start_token), dtype=torch.long,
                       device=features.device)
    ids, _ = rollout(half, half["embed"][start], enc_state)
    return ids
