"""The attention decoders' inference half (``icee_tpu_torch/models/
attention.py``) against ``icee_tpu/models/attention.py`` on the same
weights (JAX's init, bridged) and the same numpy inputs: ``attend``,
``attend_precomputed``, ``init_hidden_state`` and both decode steps; the
parameter trees of both decoders through the bridge and back; the config;
and the spatial features of one backbone pass.

Tolerance atol 1e-5 on logits, alpha, h and c: float32 on both sides, the
attention score a dot over A and the context a sum over P in each
framework's own order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import AttentionDecoderConfig as JAttCfg
from icee_tpu.models import attention as ja
from icee_tpu.models import resnet as jresnet
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import AttentionDecoderConfig
from icee_tpu_torch.models import attention as ta
from icee_tpu_torch.models import encoder, resnet

torch.set_num_threads(2)
DIMS = dict(vocab_size=300, embed_size=16, hidden_size=24, factored_size=20,
            attention_size=20, feature_size=32)
B, P = 6, 9
ATOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _trees(kind, seed=0):
    """JAX-initialised decoder params with non-zero biases -> (jax tree,
    torch tree)."""
    init = (ja.init_factored_att_params if kind == "factored"
            else ja.init_rnn_att_params)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed),
                                         JAttCfg(**DIMS)))
    rng = np.random.default_rng(seed + 10)
    tree = jax.tree.map(
        lambda a: a + _np(rng, *a.shape, scale=0.1) if a.ndim <= 2 else a,
        tree)
    return jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_attend_and_init_hidden_state_match_jax():
    jp, tp = _trees("lstm")
    rng = np.random.default_rng(1)
    feats, hidden = _np(rng, B, P, 32), _np(rng, B, 24)
    want_ctx, want_alpha = ja.attend(jp["attention"], feats, hidden)
    got_ctx, got_alpha = ta.attend(tp["attention"], torch.tensor(feats),
                                   torch.tensor(hidden))
    _close(got_ctx, want_ctx)
    _close(got_alpha, want_alpha)
    att1 = feats @ np.asarray(jp["attention"]["enc_w"]) \
        + np.asarray(jp["attention"]["enc_b"])
    got_pre = ta.attend_precomputed(tp["attention"], torch.tensor(att1),
                                    torch.tensor(feats), torch.tensor(hidden))
    _close(got_pre[0], want_ctx)
    _close(got_pre[1], want_alpha)
    _close(ta.att_projection(tp["attention"], torch.tensor(feats)), att1)
    want_g, want_ga = ja._gated_context(jp, jp["attention"], feats, hidden)
    got_g, got_ga = ta._gated_context(tp, tp["attention"],
                                      torch.tensor(feats),
                                      torch.tensor(hidden))
    _close(got_g, want_g)
    _close(got_ga, want_ga)
    for want, got in zip(ja.init_hidden_state(jp, feats),
                         ta.init_hidden_state(tp, torch.tensor(feats))):
        _close(got, want)


@pytest.mark.parametrize("style,hoisted", [(0, False), (3, True)])
def test_factored_att_decode_step_matches_jax(style, hoisted):
    jp, tp = _trees("factored", seed=2)
    rng = np.random.default_rng(style)
    emb, h, c = _np(rng, B, 16), _np(rng, B, 24), _np(rng, B, 24)
    feats = _np(rng, B, P, 32)
    att1 = None
    if hoisted:
        att = ja._select_attention(jp["attention"], jnp.asarray(style))
        att1 = feats @ np.asarray(att["enc_w"]) + np.asarray(att["enc_b"])
    want = ja.factored_att_decode_step(jp, emb, feats, (h, c),
                                       jnp.asarray(style), att1=att1)
    got = ta.factored_att_decode_step(
        tp, torch.tensor(emb), torch.tensor(feats),
        (torch.tensor(h), torch.tensor(c)), style,
        att1=None if att1 is None else torch.tensor(att1))
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2][0], want[2][0])
    _close(got[2][1], want[2][1])


def test_rnn_att_decode_step_matches_jax():
    jp, tp = _trees("lstm", seed=3)
    rng = np.random.default_rng(4)
    emb, h, c = _np(rng, B, 16), _np(rng, B, 24), _np(rng, B, 24)
    feats = _np(rng, B, P, 32)
    want = ja.rnn_att_decode_step(jp, emb, feats, (h, c))
    got = ta.rnn_att_decode_step(tp, torch.tensor(emb), torch.tensor(feats),
                                 (torch.tensor(h), torch.tensor(c)))
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2][0], want[2][0])
    _close(got[2][1], want[2][1])


@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_attention_params_bridge_round_trip(kind):
    """JAX's tree -> torch -> numpy is the identity, and the port's own init
    gives the JAX init's tree: the same keys, shapes and dtypes."""
    jp, tp = _trees(kind, seed=5)
    back = bridge.to_numpy(tp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 jp, back)
    init = (ta.init_factored_att_params if kind == "factored"
            else ta.init_rnn_att_params)
    ours = init(torch.Generator().manual_seed(0),
                AttentionDecoderConfig(**DIMS))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert jax.tree.map(lambda t: (tuple(t.shape), "float32"),
                        ours) == shapes
    if kind == "factored":
        assert ours["attention"]["enc_w"].shape == (4, 32, 20)
        assert ta.select_attention(ours, 2)["dec_w"].shape == (24, 20)
    else:
        assert ta.select_attention(ours, 2) is ours["attention"]


def test_attention_config_matches_jax():
    ours, theirs = AttentionDecoderConfig(), JAttCfg()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.input_size == theirs.input_size == 300 + 2048
    assert AttentionDecoderConfig(**DIMS).input_size == 16 + 32


def test_backbone_gives_pooled_and_spatial_features_from_one_pass():
    """``Backbone.features``: one feature map gives the pooled features and
    the 14 x 14 grid (the JAX package's adaptive pool on the same map), as
    ``spatial_features`` and ``encode_spatial`` give them."""
    params = resnet.init_params(torch.Generator().manual_seed(0))
    for li in range(1, 5):
        for block in params[f"layer{li}"]:
            block["bn3"]["weight"].mul_(0.2)
    backbone = resnet.Backbone(params)
    images = torch.randn((2, 64, 64, 3), generator=torch.Generator()
                         .manual_seed(1))
    calls = []
    forward = backbone.forward
    backbone.forward = lambda x: calls.append(1) or forward(x)
    with torch.no_grad():
        pooled, spatial = backbone.features(images)
        fmap = forward(images)
        grid = resnet.spatial_features(params, images)
        flat = encoder.encode_spatial(params, images)
    assert len(calls) == 1
    assert fmap.shape == (2, 2, 2, 2048)
    want = np.asarray(jresnet.adaptive_avg_pool(jnp.asarray(fmap.numpy()),
                                                (14, 14)))
    np.testing.assert_allclose(grid.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(spatial.numpy(), want.reshape(2, 196, 2048),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(flat.numpy(), spatial.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pooled.numpy(), fmap.mean(dim=(1, 2)).numpy(),
                               rtol=1e-6, atol=1e-6)
