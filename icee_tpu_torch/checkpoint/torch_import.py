"""Import shims: reference torch ``state_dict`` checkpoints -> the port's
parameter trees (port of ``icee_tpu/checkpoint/torch_import.py``: the
StyleNet, NIC, their attention variants', the seq2seq and the encoder-head
importers).

The reference saves raw ``state_dict`` files (``train.py:214-220``, loaded
by ``sample.py:46-47``) or whole-module pickles (``utils.py:63-90``, whose
tensors are the same state_dict entries; see :mod:`.torch_pickle`).  These
shims map the per-gate/per-style ``nn.Linear`` tensors onto the stacked
layout of the JAX package, so trained reference artifacts serve here.

Layout recap (``ops/cells.py``): factored gate order [i, f, o, c]; style
order [factual, happy, sad, angry]; linear weights are the transpose of
torch's ``(out, in)``; ``nn.LSTMCell`` weights (4H, in) in [i, f, g, o]
order are the LSTM cell's layout transposed.

Tensors may be torch tensors or numpy arrays; the trees hold contiguous
float32 CPU tensors (``dtype`` otherwise), to be moved to the device by the
caller.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

GATES = ("i", "f", "o", "c")
STYLE_PREFIXES = ("f", "happy_", "sad_", "angry_")  # S_fi vs S_happy_i naming


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear_w(sd: Mapping, name: str) -> np.ndarray:
    """torch Linear weight (out, in) -> ours (in, out)."""
    return _np(sd[f"{name}.weight"]).T


def _linear_b(sd: Mapping, name: str) -> np.ndarray:
    return _np(sd[f"{name}.bias"])


def _tensor(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def import_factored_decoder_state_dict(sd: Mapping,
                                       dtype=torch.float32) -> dict:
    """``DecoderFactoredLSTM`` state_dict (stylenet/model.py:52-94) ->
    params."""
    v_w = np.concatenate([_linear_w(sd, f"V_{g}") for g in GATES], axis=1)
    v_b = np.stack([_linear_b(sd, f"V_{g}") for g in GATES])
    s_w = np.stack([
        np.stack([_linear_w(sd, f"S_{sp}{g}") for g in GATES])
        for sp in STYLE_PREFIXES
    ])
    s_b = np.stack([
        np.stack([_linear_b(sd, f"S_{sp}{g}") for g in GATES])
        for sp in STYLE_PREFIXES
    ])
    u_w = np.stack([_linear_w(sd, f"U_{g}") for g in GATES])
    u_b = np.stack([_linear_b(sd, f"U_{g}") for g in GATES])
    w_w = np.concatenate([_linear_w(sd, f"W_{g}") for g in GATES], axis=1)
    w_b = np.stack([_linear_b(sd, f"W_{g}") for g in GATES])

    params = {
        "B": _np(sd["B.weight"]),
        "V_w": v_w, "V_b": v_b,
        "S_w": s_w, "S_b": s_b,
        "U_w": u_w, "U_b": u_b,
        "W_w": w_w, "W_b": w_b,
        "C_w": _linear_w(sd, "C"),
        "C_b": _linear_b(sd, "C"),
    }
    return {k: _tensor(v, dtype) for k, v in params.items()}


def _linear_pair(sd: Mapping, name: str, dtype) -> tuple:
    return (_tensor(_linear_w(sd, name), dtype),
            _tensor(_linear_b(sd, name), dtype))


def _att_extras(params: dict, sd: Mapping, dtype) -> dict:
    """The h/c init projections and the context gate, as ``init_h_w`` ...
    ``f_beta_b``."""
    for name in ("init_h", "init_c", "f_beta"):
        params[f"{name}_w"], params[f"{name}_b"] = _linear_pair(sd, name,
                                                                dtype)
    return params


def import_factored_att_decoder_state_dict(sd: Mapping,
                                           dtype=torch.float32) -> dict:
    """``DecoderFactoredLSTMAtt`` state_dict (stylenet/model_att.py:93-164):
    the factored decoder with input E + 2048, one attention net per style
    (stacked in style order), the h/c init projections and the gate."""
    params = import_factored_decoder_state_dict(sd, dtype)
    att_names = ("attention", "attention_happy", "attention_sad",
                 "attention_angry")
    att = {}
    for ours, theirs in (("enc", "encoder_att"), ("dec", "decoder_att"),
                         ("full", "full_att")):
        att[f"{ours}_w"] = np.stack([_linear_w(sd, f"{a}.{theirs}")
                                     for a in att_names])
        att[f"{ours}_b"] = np.stack([_linear_b(sd, f"{a}.{theirs}")
                                     for a in att_names])
    params["attention"] = {k: _tensor(v, dtype) for k, v in att.items()}
    return _att_extras(params, sd, dtype)


def import_nic_att_decoder_state_dict(sd: Mapping,
                                      dtype=torch.float32) -> dict:
    """``DecoderRNNAtt`` state_dict (nic/model_att.py:73-161): embedding +
    LSTMCell(E + 2048 -> H) + output linear + one attention net + the h/c
    init projections and the gate."""
    params = import_nic_decoder_state_dict(sd, dtype)
    att = {}
    for ours, theirs in (("enc", "encoder_att"), ("dec", "decoder_att"),
                         ("full", "full_att")):
        att[f"{ours}_w"], att[f"{ours}_b"] = _linear_pair(
            sd, f"attention.{theirs}", dtype)
    params["attention"] = att
    return _att_extras(params, sd, dtype)


def import_nic_decoder_state_dict(sd: Mapping, dtype=torch.float32) -> dict:
    """``DecoderRNN`` state_dict (nic/model.py:48-53): embedding + LSTMCell
    + output linear.  torch LSTMCell weights are (4H, in) in [i,f,g,o]
    order: the cell layout transposed."""
    return {
        "embed": _tensor(_np(sd["embed.weight"]), dtype),
        "cell": {
            "W_ih": _tensor(_np(sd["lstm.weight_ih"]).T, dtype),
            "W_hh": _tensor(_np(sd["lstm.weight_hh"]).T, dtype),
            "b_ih": _tensor(_np(sd["lstm.bias_ih"]), dtype),
            "b_hh": _tensor(_np(sd["lstm.bias_hh"]), dtype),
        },
        "linear_w": _tensor(_linear_w(sd, "linear"), dtype),
        "linear_b": _tensor(_linear_b(sd, "linear"), dtype),
    }


def _seq2seq_half(sd: Mapping, prefix: str, dtype) -> dict:
    """One ``EncoderRNN``/``DecoderRNN`` half (``seq2seq/model.py:30-64,
    125-144``): embedding + ``nn.LSTM`` layer stack + output linear.
    ``nn.LSTM`` stores per-layer ``weight_ih_l{n}`` (4H, in) in torch's
    [i, f, g, o] gate order — the cell layout transposed."""
    layers = []
    n = 0
    while f"{prefix}.lstm.weight_ih_l{n}" in sd:
        layers.append({
            "W_ih": _tensor(_np(sd[f"{prefix}.lstm.weight_ih_l{n}"]).T,
                            dtype),
            "W_hh": _tensor(_np(sd[f"{prefix}.lstm.weight_hh_l{n}"]).T,
                            dtype),
            "b_ih": _tensor(_np(sd[f"{prefix}.lstm.bias_ih_l{n}"]), dtype),
            "b_hh": _tensor(_np(sd[f"{prefix}.lstm.bias_hh_l{n}"]), dtype),
        })
        n += 1
    if not layers:
        raise KeyError(f"no {prefix}.lstm.weight_ih_l0 in state_dict")
    return {
        "embed": _tensor(_np(sd[f"{prefix}.embed.weight"]), dtype),
        "lstm": layers,
        "linear_w": _tensor(_linear_w(sd, f"{prefix}.linear"), dtype),
        "linear_b": _tensor(_linear_b(sd, f"{prefix}.linear"), dtype),
    }


def import_seq2seq_state_dict(sd: Mapping, dtype=torch.float32) -> dict:
    """``Seq2Seq`` state_dict (``seq2seq/model.py:220-254``) -> the port's
    tree: the encoder half + the three per-emotion decoders stacked on axis
    0 in (happy, sad, angry) order (``models/seq2seq.py`` emotion ids)."""
    from icee_tpu_torch.models.seq2seq import stack_trees

    decoders = [_seq2seq_half(sd, f"decoder_{m}", dtype)
                for m in ("happy", "sad", "angry")]
    return {"encoder": _seq2seq_half(sd, "encoder", dtype),
            "decoders": stack_trees(decoders)}


def import_encoder_head_state_dict(sd: Mapping, dtype=torch.float32) -> dict:
    """``EncoderCNN`` head (linear + bn) state_dict (stylenet/model.py:
    19-20).  The ResNet trunk goes through
    :func:`icee_tpu_torch.models.resnet.import_torch_state_dict` with the
    ``resnet.`` prefix stripped."""
    return {
        "linear_w": _tensor(_linear_w(sd, "linear"), dtype),
        "linear_b": _tensor(_linear_b(sd, "linear"), dtype),
        "bn": {
            "weight": _tensor(_np(sd["bn.weight"]), dtype),
            "bias": _tensor(_np(sd["bn.bias"]), dtype),
            "running_mean": _tensor(_np(sd["bn.running_mean"]), dtype),
            "running_var": _tensor(_np(sd["bn.running_var"]), dtype),
        },
    }
