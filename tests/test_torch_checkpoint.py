"""Reference torch checkpoints into the port: ``icee_tpu_torch.checkpoint``
(``torch_import``, ``torch_pickle``; the StyleNet, NIC, StyleNet+Att, NIC+Att
and encoder-head importers) and the ResNet importer/loader of
``models/resnet.py``, against the JAX package's importers on the same
state dicts (made with numpy from seeds), and full-module pickles loaded
without the reference's classes (as ``tests/test_torch_pickle.py`` sets
them up for the JAX package).  The importers only transpose, stack and copy,
so the trees must be equal exactly.
"""

import sys
import types

import jax
import numpy as np
import pytest
import torch

from icee_tpu.checkpoint import torch_import as jti
from icee_tpu.models import resnet as jresnet
from icee_tpu_torch import bridge
from icee_tpu_torch.checkpoint import torch_import as ti
from icee_tpu_torch.checkpoint.torch_pickle import (
    load_reference_full_checkpoint, load_torch_pickle, module_state_dict)
from icee_tpu_torch.models import resnet

V, E, F, H, FEAT, A = 30, 6, 8, 10, 12, 7


def _w(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _factored_sd(seed=0, e_in=E):
    rng = np.random.default_rng(seed)
    sd = {"B.weight": _w(rng, V, E), "C.weight": _w(rng, V, H),
          "C.bias": _w(rng, V)}
    for g in jti.GATES:
        for name, (o, i) in (("V", (F, e_in)), ("U", (H, F)), ("W", (H, H))):
            sd[f"{name}_{g}.weight"] = _w(rng, o, i)
            sd[f"{name}_{g}.bias"] = _w(rng, o)
        for sp in jti.STYLE_PREFIXES:
            sd[f"S_{sp}{g}.weight"] = _w(rng, F, F)
            sd[f"S_{sp}{g}.bias"] = _w(rng, F)
    return sd


def _nic_sd(seed=1, e_in=E):
    rng = np.random.default_rng(seed)
    return {"embed.weight": _w(rng, V, E),
            "lstm.weight_ih": _w(rng, 4 * H, e_in),
            "lstm.weight_hh": _w(rng, 4 * H, H),
            "lstm.bias_ih": _w(rng, 4 * H), "lstm.bias_hh": _w(rng, 4 * H),
            "linear.weight": _w(rng, V, H), "linear.bias": _w(rng, V)}


def _att_extras(sd, rng, nets):
    """The attention nets (``encoder_att``, ``decoder_att``, ``full_att``
    Linears), the h/c init projections and the gate of an attention
    decoder's state dict (``model_att.py:32-70``, ``:140-164``)."""
    for net in nets:
        for name, (o, i) in (("encoder_att", (A, FEAT)),
                             ("decoder_att", (A, H)), ("full_att", (1, A))):
            sd[f"{net}.{name}.weight"] = _w(rng, o, i)
            sd[f"{net}.{name}.bias"] = _w(rng, o)
    for name, (o, i) in (("init_h", (H, FEAT)), ("init_c", (H, FEAT)),
                         ("f_beta", (FEAT, H))):
        sd[f"{name}.weight"] = _w(rng, o, i)
        sd[f"{name}.bias"] = _w(rng, o)
    return sd


def _factored_att_sd(seed=4):
    return _att_extras(_factored_sd(seed, E + FEAT),
                       np.random.default_rng(seed + 100),
                       ("attention", "attention_happy", "attention_sad",
                        "attention_angry"))


def _nic_att_sd(seed=5):
    return _att_extras(_nic_sd(seed, E + FEAT),
                       np.random.default_rng(seed + 100), ("attention",))


def _head_sd(seed=2):
    rng = np.random.default_rng(seed)
    return {"linear.weight": _w(rng, E, FEAT), "linear.bias": _w(rng, E),
            "bn.weight": _w(rng, E), "bn.bias": _w(rng, E),
            "bn.running_mean": _w(rng, E),
            "bn.running_var": np.abs(_w(rng, E))}


def _resnet_sd(seed=3):
    """Every key of torchvision's resnet152 state dict, with small random
    tensors of the right rank (the importers only transpose and copy)."""
    rng = np.random.default_rng(seed)
    sd = {"conv1.weight": _w(rng, 4, 3, 7, 7)}

    def bn(prefix, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.{k}"] = _w(rng, c)

    bn("bn1", 4)
    for li, nblocks in enumerate(resnet.LAYERS_152):
        for bi in range(nblocks):
            pre = f"layer{li + 1}.{bi}"
            for j, kk in ((1, 1), (2, 3), (3, 1)):
                sd[f"{pre}.conv{j}.weight"] = _w(rng, 2, 3, kk, kk)
                bn(f"{pre}.bn{j}", 2)
            if bi == 0:
                sd[f"{pre}.downsample.0.weight"] = _w(rng, 2, 3, 1, 1)
                bn(f"{pre}.downsample.1", 2)
    return sd


def _same(got, want):
    """Port tree (torch) == JAX tree, exactly, leaf by leaf."""
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(bridge.to_numpy(got)) == \
        jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, bridge.to_numpy(got), want)
    for leaf in jax.tree.leaves(got, is_leaf=torch.is_tensor):
        assert leaf.dtype == torch.float32 and leaf.is_contiguous()


@pytest.mark.parametrize("name,make", [
    ("import_factored_decoder_state_dict", _factored_sd),
    ("import_nic_decoder_state_dict", _nic_sd),
    ("import_encoder_head_state_dict", _head_sd),
    ("import_factored_att_decoder_state_dict", _factored_att_sd),
    ("import_nic_att_decoder_state_dict", _nic_att_sd),
])
def test_importers_match_jax(name, make):
    sd = make()
    _same(getattr(ti, name)(sd), getattr(jti, name)(sd))
    # torch tensors in, the same trees out
    _same(getattr(ti, name)({k: torch.tensor(v) for k, v in sd.items()}),
          getattr(jti, name)(sd))


def test_attention_importers_stack_the_style_nets():
    """StyleNet+Att's four per-style nets stack in style order; NIC+Att's
    one net stays unstacked."""
    sd = _factored_att_sd()
    got = ti.import_factored_att_decoder_state_dict(sd)
    assert got["attention"]["enc_w"].shape == (4, FEAT, A)
    assert got["attention"]["full_w"].shape == (4, A, 1)
    np.testing.assert_array_equal(got["attention"]["dec_w"][2].numpy(),
                                  sd["attention_sad.decoder_att.weight"].T)
    assert got["V_w"].shape == (E + FEAT, 4 * F)
    nic = ti.import_nic_att_decoder_state_dict(_nic_att_sd())
    assert nic["attention"]["enc_w"].shape == (FEAT, A)
    assert nic["cell"]["W_ih"].shape == (E + FEAT, 4 * H)
    assert nic["f_beta_w"].shape == (H, FEAT)


def test_resnet_import_and_loader_match_jax(tmp_path):
    sd = _resnet_sd()
    want = jresnet.import_torch_state_dict(sd)
    _same(resnet.import_torch_state_dict(sd), want)
    npz = str(tmp_path / "r.npz")
    np.savez(npz, **sd)
    _same(resnet.load_resnet_params(npz), want)
    # a .pth from an EncoderCNN wrapper: the "resnet." prefix is stripped
    pth = str(tmp_path / "r.pth")
    torch.save({f"resnet.{k}": torch.tensor(v) for k, v in sd.items()}, pth)
    _same(resnet.load_resnet_params(pth), want)


@pytest.fixture
def full_module_pickle(tmp_path):
    """A reference-style full checkpoint whose module classes live in a
    throwaway module ``model``, deleted after saving."""
    import torch.nn as nn

    mod = types.ModuleType("model")

    class EncoderCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.resnet = nn.Sequential(nn.Conv2d(3, 4, 1))
            self.linear = nn.Linear(FEAT, E)
            self.bn = nn.BatchNorm1d(E, momentum=0.01)

    class DecoderRNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, E)
            self.lstm = nn.LSTMCell(E, H)
            self.linear = nn.Linear(H, V)

    for cls in (EncoderCNN, DecoderRNN):
        cls.__module__, cls.__qualname__ = "model", cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules["model"] = mod
    try:
        torch.manual_seed(0)
        enc, dec = EncoderCNN(), DecoderRNN()
        with torch.no_grad():
            enc.bn.running_mean.uniform_(-1, 1)
            enc.bn.running_var.uniform_(0.5, 2)
        path = str(tmp_path / "HAP_BEST_checkpoint_nic.pth.tar")
        torch.save({"epoch": 3, "epochs_since_improvement": 1, "bleu-4": 0.25,
                    "encoder": enc, "decoder": dec}, path)
    finally:
        del sys.modules["model"]
    return path, enc.state_dict(), dec.state_dict()


def test_full_module_pickle_loads_without_the_classes(full_module_pickle):
    path, enc_sd, dec_sd = full_module_pickle
    with pytest.raises(Exception):
        torch.load(path, map_location="cpu", weights_only=False)
    blob = load_torch_pickle(path)
    got_dec = module_state_dict(blob["decoder"])
    got_enc = module_state_dict(blob["encoder"])
    assert list(got_dec) == list(dec_sd) and list(got_enc) == list(enc_sd)
    for got, want in ((got_dec, dec_sd), (got_enc, enc_sd)):
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    out = load_reference_full_checkpoint(path)
    assert out["epoch"] == 3 and out["bleu-4"] == 0.25
    # the import the engine makes: decoder, and the head without resnet.*
    nic = ti.import_nic_decoder_state_dict(out["decoder_state"])
    _same(nic, jti.import_nic_decoder_state_dict(
        {k: v.numpy() for k, v in dec_sd.items()}))
    torch.testing.assert_close(nic["cell"]["W_ih"],
                               dec_sd["lstm.weight_ih"].T, rtol=0, atol=0)
    head = ti.import_encoder_head_state_dict(
        {k: v for k, v in out["encoder_state"].items()
         if not k.startswith("resnet.")})
    _same(head, jti.import_encoder_head_state_dict(
        {k: v.numpy() for k, v in enc_sd.items()}))
