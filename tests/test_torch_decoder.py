"""The port's FactoredLSTM pieces vs the JAX package, on the same weights.

Inputs come from ``numpy.random.default_rng``; JAX weights move to the port
through ``icee_tpu_torch.bridge``.  Tolerance atol = rtol = 1e-5: both sides
are float32 on the CPU, and the two BLAS libraries sum in different orders.
"""

import jax
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.ops.cells import factored_lstm_cell as jcell
from icee_tpu_torch import bridge
from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import DecoderConfig
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.ops.cells import factored_lstm_cell

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(seed=0, vocab=50, e=16, h=24, f=20):
    cfg = JDecoderConfig(vocab_size=vocab, embed_size=e, hidden_size=h,
                         factored_size=f)
    jp = jax.tree.map(np.asarray, jfl.init_params(jax.random.PRNGKey(seed),
                                                  cfg))
    # non-zero biases so every bias path is exercised
    rng = np.random.default_rng(seed)
    for name in ("V_b", "S_b", "U_b", "W_b", "C_b"):
        jp[name] = rng.standard_normal(jp[name].shape).astype(np.float32) * .1
    return cfg, jp, bridge.to_torch(jp)


@pytest.mark.parametrize("style", [0, 1, 2, 3])
def test_factored_cell_and_decode_step_match_jax(style):
    cfg, jp, tp = _weights(seed=style)
    rng = np.random.default_rng(10 + style)
    x = rng.standard_normal((7, cfg.embed_size)).astype(np.float32)
    h = rng.standard_normal((7, cfg.hidden_size)).astype(np.float32)
    c = rng.standard_normal((7, cfg.hidden_size)).astype(np.float32)

    want_h, want_c = jcell(jp, x, h, c, style)
    got_h, got_c = factored_lstm_cell(tp, torch.tensor(x), torch.tensor(h),
                                      torch.tensor(c), style)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)

    want_logits, (wh, wc) = jfl.decode_step(jp, x, (h, c), style)
    got_logits, (gh, gc) = fl.decode_step(
        tp, torch.tensor(x), (torch.tensor(h), torch.tensor(c)), style)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)


def test_embed_and_initial_state_match_jax():
    cfg, jp, tp = _weights(seed=4)
    toks = np.array([0, 3, 49, 7], np.int32)
    np.testing.assert_array_equal(fl.embed(tp, torch.tensor(toks)).numpy(),
                                  np.asarray(jfl.embed(jp, toks)))
    h, c = fl.initial_state(3, DecoderConfig(hidden_size=24))
    jh, jc = jfl.initial_state(3, cfg)
    assert h.shape == jh.shape and c.shape == jc.shape
    assert not h.any() and not c.any()


def test_init_params_layout_and_ranges_match_jax():
    """Same keys, shapes and dtypes as the JAX init, drawn from the same
    distributions (xavier bounds, U(-0.1, 0.1) for B and C_w, zero biases)."""
    cfg = DecoderConfig(vocab_size=300, embed_size=32, hidden_size=48,
                        factored_size=40)
    tp = fl.init_params(torch.Generator().manual_seed(0), cfg)
    jp = jfl.init_params(jax.random.PRNGKey(0), JDecoderConfig(
        vocab_size=300, embed_size=32, hidden_size=48, factored_size=40))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        assert tp[k].dtype == torch.float32
    for k in ("B", "C_w"):
        assert float(tp[k].abs().max()) <= 0.1
    bound = np.sqrt(6.0 / (40 + 40))
    assert float(tp["S_w"].abs().max()) <= bound
    assert float(tp["S_w"].abs().max()) > 0.9 * bound
    for k in ("V_b", "S_b", "U_b", "W_b", "C_b"):
        assert not tp[k].any()


def test_initializers_draw_from_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = init.xavier_uniform(g1, (4, 30, 50))
    b = init.xavier_uniform(g2, (4, 30, 50))
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= np.sqrt(6.0 / 80)
    w = init.torch_linear_default(g1, (64, 8), fan_in=64)
    assert float(w.abs().max()) <= 1 / 8
    with pytest.raises(ValueError):
        init.xavier_uniform(g1, (5,))


def test_bridge_round_trip_keeps_trees():
    _, jp, tp = _weights(seed=5)
    back = bridge.to_numpy(tp)
    assert sorted(back) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(back[k], jp[k])
    nested = {"a": [np.ones((2, 3), np.float32), {"b": np.arange(3)}]}
    again = bridge.to_numpy(bridge.to_torch(nested))
    np.testing.assert_array_equal(again["a"][0], nested["a"][0])
    np.testing.assert_array_equal(again["a"][1]["b"], nested["a"][1]["b"])
