"""The NIC decoder: the port's ``ops/cells.py`` LSTM cells and
``models/lstm.py`` against the JAX package's, at a tiny width.

Weights come from the JAX package's own init (moved across with
``icee_tpu_torch.bridge``) with non-zero biases; the dropout keep-mask and
the teacher-forcing coins are drawn with ``jax.random`` as JAX's
``_prep_forward`` draws them and injected into the port (torch cannot
reproduce ``jax.random``).  Tolerance 1e-5 throughout (float32 on both sides,
BLAS sums in other orders); gradients 1e-5 as well (a few steps of small
products).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.models import lstm as jnic
from icee_tpu.ops import cells as jcells
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import DecoderConfig
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.ops import cells

torch.set_num_threads(2)
V, E, H, B, T = 40, 12, 16, 6, 7
TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(vocab_size=V, embed_size=E, hidden_size=H, factored_size=H,
            dropout=0.5)


def _params(seed=0):
    p = jax.tree.map(np.asarray, jnic.init_params(jax.random.PRNGKey(seed),
                                                  JDecoderConfig(**DIMS)))
    rng = np.random.default_rng(seed)
    for name in ("b_ih", "b_hh"):
        p["cell"][name] = (0.1 * rng.standard_normal(4 * H)).astype(np.float32)
    p["linear_b"] = (0.1 * rng.standard_normal(V)).astype(np.float32)
    return p


def _data(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, T)).astype(np.int32),
            rng.standard_normal((B, E)).astype(np.float32))


def _draws(key, ratio):
    """The keep-mask and coins JAX's _prep_forward draws from ``key``."""
    k_drop, k_tf = jax.random.split(key)
    keep = np.asarray(jax.random.bernoulli(k_drop, 0.5, (B, T, E)))
    coins = (None if ratio >= 1.0 else
             np.asarray(jax.random.bernoulli(k_tf, ratio, (T,))))
    return keep, coins


def test_lstm_cell_and_multilayer_match_jax():
    rng = np.random.default_rng(2)
    layers = [_params(0)["cell"], jax.tree.map(  # layer 2 takes H inputs
        np.asarray, jnic.init_cell_params(jax.random.PRNGKey(1), H, H,
                                          xavier=False))]
    x = rng.standard_normal((B, E)).astype(np.float32)
    h = rng.standard_normal((2, B, H)).astype(np.float32)
    c = rng.standard_normal((2, B, H)).astype(np.float32)
    want = jcells.lstm_cell(layers[0], x, h[0], c[0])
    got = cells.lstm_cell(bridge.to_torch(layers[0]), torch.tensor(x),
                          torch.tensor(h[0]), torch.tensor(c[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want = jcells.multilayer_lstm_cell(layers, x, h, c)
    got = cells.multilayer_lstm_cell(bridge.to_torch(layers), torch.tensor(x),
                                     torch.tensor(h), torch.tensor(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the multilayer step of the model module
    top, (h2, c2) = nic.multilayer_decode_step(
        bridge.to_torch(layers), torch.tensor(x),
        nic.multilayer_initial_state(2, B, H))
    jtop, (jh2, jc2) = jnic.multilayer_decode_step(
        layers, x, jnic.multilayer_initial_state(2, B, H))
    for g, w in ((top, jtop), (h2, jh2), (c2, jc2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_decode_step_matches_jax():
    p = _params(3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, E)).astype(np.float32)
    h, c = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    w_logits, (wh, wc) = jnic.decode_step(p, x, (h, c))
    logits, (gh, gc) = nic.decode_step(bridge.to_torch(p), torch.tensor(x),
                                       (torch.tensor(h), torch.tensor(c)))
    for g, w in ((logits, w_logits), (gh, wh), (gc, wc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("ratio", [1.0, 0.8, 0.0])
def test_forward_and_forward_hiddens_match_jax(ratio):
    p = _params(5)
    captions, feats = _data(6)
    key = jax.random.PRNGKey(7)
    keep, coins = _draws(key, ratio)
    jcfg, cfg = JDecoderConfig(**DIMS), DecoderConfig(**DIMS)
    want_l = jnic.forward(p, jcfg, captions, feats, ratio, key)
    want_h = jnic.forward_hiddens(p, jcfg, captions, feats, ratio, key)
    tp = bridge.to_torch(p)
    args = (tp, cfg, torch.tensor(captions), torch.tensor(feats), ratio)
    kw = dict(keep=keep, coins=coins)
    got_l = nic.forward(*args, **kw)
    got_h = nic.forward_hiddens(*args, **kw)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    if ratio >= 1.0:    # the K4 route (its plain version on the CPU)
        fused = nic.forward_hiddens(*args, fused_scan=True, **kw)
        np.testing.assert_array_equal(fused.numpy(), got_h.numpy())
    # eval mode: no dropout, nothing drawn
    want_e = jnic.forward(p, jcfg, captions, feats, ratio, key, train=False)
    got_e = nic.forward(*args, train=False, coins=coins)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)


@pytest.mark.parametrize("hiddens", [False, True])
def test_scheduled_sampling_grads_match_jax(hiddens):
    """Ratio 0.8: ``forward`` keeps the head's gradient on every step;
    ``forward_hiddens`` detaches h before the argmax head (JAX
    ``stop_gradient``, ``models/lstm.py:213``), so no gradient reaches the
    head through the argmax path and the free steps embed the un-dropped
    argmax."""
    p = _params(8)
    captions, feats = _data(9)
    key = jax.random.PRNGKey(10)
    keep, coins = _draws(key, 0.8)
    assert coins.any() and not coins.all()
    jcfg, cfg = JDecoderConfig(**DIMS), DecoderConfig(**DIMS)
    r = np.random.default_rng(11).standard_normal(
        (B, T, H if hiddens else V)).astype(np.float32)
    jfn = jnic.forward_hiddens if hiddens else jnic.forward
    want = jax.grad(lambda q: jnp.sum(jfn(q, jcfg, captions, feats, 0.8, key)
                                      * r))(p)
    tp = {k: (v.requires_grad_(True) if k != "cell" else
              {a: b.requires_grad_(True) for a, b in v.items()})
          for k, v in bridge.to_torch(p).items()}
    fn = nic.forward_hiddens if hiddens else nic.forward
    out = fn(tp, cfg, torch.tensor(captions), torch.tensor(feats), 0.8,
             keep=keep, coins=coins)
    (out * torch.tensor(r)).sum().backward()
    got = {k: (v.grad if k != "cell" else {a: b.grad for a, b in v.items()})
           for k, v in tp.items()}
    if hiddens:
        assert got["linear_w"] is None and got["linear_b"] is None
        assert not np.asarray(want["linear_w"]).any()
        got = {k: v for k, v in got.items() if not k.startswith("linear")}
        want = {k: want[k] for k in got}
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), **TOL), got, want)


@pytest.mark.parametrize("xavier", [True, False])
def test_init_cell_params_shapes_and_bounds(xavier):
    cell = nic.init_cell_params(torch.Generator().manual_seed(0), 300, 512,
                                xavier=xavier)
    jcell = jnic.init_cell_params(jax.random.PRNGKey(0), 300, 512,
                                  xavier=xavier)
    for k, v in cell.items():
        assert tuple(v.shape) == jcell[k].shape and v.dtype == torch.float32
    if xavier:
        for k, fan_in in (("W_ih", 300), ("W_hh", 512)):
            bound = math.sqrt(6.0 / (fan_in + 4 * 512))
            assert cell[k].abs().max() <= bound
            assert cell[k].abs().max() > 0.99 * bound   # fills the range
        assert not cell["b_ih"].any() and not cell["b_hh"].any()
    else:
        bound = 1.0 / math.sqrt(512)
        assert all(v.abs().max() <= bound for v in cell.values())
    p = nic.init_params(torch.Generator().manual_seed(1),
                        DecoderConfig(**DIMS))
    jp = jnic.init_params(jax.random.PRNGKey(1), JDecoderConfig(**DIMS))
    assert jax.tree.map(np.shape, bridge.to_numpy(p)) == \
        jax.tree.map(np.shape, jax.tree.map(np.asarray, jp))
    assert p["embed"].abs().max() <= 0.1 and not p["linear_b"].any()
    layers = nic.init_multilayer(torch.Generator().manual_seed(2), E, H, 3)
    assert [tuple(x["W_ih"].shape) for x in layers] == \
        [(E, 4 * H), (H, 4 * H), (H, 4 * H)]


def test_bridge_round_trip_of_a_nic_tree():
    """The NIC tree ``{embed, cell: {W_ih, W_hh, b_ih, b_hh}, linear_w,
    linear_b}`` crosses the bridge both ways unchanged."""
    p = _params(12)
    tp = bridge.to_torch(p)
    assert set(tp) == {"embed", "cell", "linear_w", "linear_b"}
    assert set(tp["cell"]) == {"W_ih", "W_hh", "b_ih", "b_hh"}
    back = bridge.to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, p)
