"""The port's StyleNet and NIC train and validation steps vs the JAX
package's ``make_caption_steps``, at a tiny width, with JAX's dropout keep-mask and
teacher-forcing coins injected into the port (torch cannot reproduce
``jax.random``; the test draws them as ``_prep_forward`` does).

Each case runs one factual step, one emotion step (style 2) and one
validation step from the same weights, and compares the loss (1e-6), the
pre-optimizer grads (1e-5; float32 sums in other orders), the BatchNorm
running statistics and the updated parameters.  The updates are held to
1e-6 except where |grad| < 1e-5: Adam's first step is about sign(g) * lr,
so rounding noise in a near-zero grad can flip a whole step, and there the
tolerance is 2 * lr (as ``tests/test_chunked_loss.py`` notes for JAX's own
chunked-vs-materialized steps).  On the ratio-1.0 path the port runs its
K3 autograd function (plain versions on the CPU); JAX runs its XLA scan,
which its own tests hold to the Pallas kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.core.config import EncoderConfig as JEncoderConfig
from icee_tpu.core.config import TrainConfig as JTrainConfig
from icee_tpu.models import encoder as jenc
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.models import lstm as jnic
from icee_tpu.train import optim as joptim
from icee_tpu.train.steps import make_caption_steps as jmake
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import DecoderConfig, TrainConfig
from icee_tpu_torch.train import optim
from icee_tpu_torch.train.steps import make_caption_steps

torch.set_num_threads(2)
V, E, HD, FD, B, T, FEAT = 31, 10, 16, 16, 8, 6, 12
LR, LR_LANG = 1e-3, 5e-4


def _setup():
    jcfg = JDecoderConfig(vocab_size=V, embed_size=E, hidden_size=HD,
                          factored_size=FD, feature_size=FEAT, dropout=0.5)
    dec = jfl.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    dec = {k: (v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
               if k.endswith("_b") else v) for k, v in dec.items()}
    head = jenc.init_head_params(jax.random.PRNGKey(1),
                                 JEncoderConfig(embed_size=E,
                                                feature_size=FEAT))
    data = dict(
        pooled=rng.standard_normal((B, FEAT)).astype(np.float32),
        captions=rng.integers(0, V, (B, T)).astype(np.int32),
        lengths=np.array([6, 4, 2, 6, 0, 5, 3, 6], np.int32),
        sample_mask=np.array([True] * 6 + [False, True]))
    return jcfg, jax.tree.map(np.asarray, dec), jax.tree.map(np.asarray,
                                                             head), data


def _draws(key, ratio):
    """The keep-mask and coins JAX's _prep_forward draws from ``key``."""
    k_drop, k_tf = jax.random.split(key)
    keep = np.asarray(jax.random.bernoulli(k_drop, 0.5, (B, T, E)))
    coins = (None if ratio >= 1.0 else
             np.asarray(jax.random.bernoulli(k_tf, ratio, (T,))))
    return keep, coins


def _close_tree(got, want, **tol):
    jax.tree.map(lambda w, g: np.testing.assert_allclose(
        bridge.to_numpy(g), w, **tol), want, got)


def _close_update(got, want, grads, lr):
    """Updated params: 1e-6, or 2 * lr where |grad| < 1e-5."""
    def one(w, g, gr):
        g = bridge.to_numpy(g)
        tol = np.where(np.abs(gr) < 1e-5, 2 * lr, 1e-6)
        assert (np.abs(g - w) <= tol).all(), np.abs(g - w).max()
    jax.tree.map(one, want, got, grads)


def _head_part(h):
    """The head's parameters (its BatchNorm running statistics are state)."""
    return {"linear_w": h["linear_w"], "linear_b": h["linear_b"],
            "bn_weight": h["bn"]["weight"], "bn_bias": h["bn"]["bias"]}


def _adam_step(tx, params, grads):
    """One step of the JAX package's ``make_adam`` from a fresh state."""
    upd, _ = tx.update(grads, tx.init(params), params)
    return jax.tree.map(np.asarray, optax.apply_updates(params, upd))


@pytest.fixture(scope="module")
def jax_val_step():
    """JAX's val step; it depends on neither the ratio nor chunked_ce, so
    one compile serves every case."""
    jcfg, *_ = _setup()
    ident = optax.identity()
    return jmake(jcfg, JTrainConfig(), ident, ident)[2]


@pytest.mark.parametrize("ratio", [1.0, 0.7])
@pytest.mark.parametrize("chunked", [True, False])
def test_steps_match_jax(ratio, chunked, jax_val_step):
    """JAX's own factual and emotion steps run with ``optax.identity()`` as
    their optimizer, so each returns params + grads: the test reads the
    step's gradient from it (float32 rounding ~3e-8 at these magnitudes)
    and applies the JAX package's ``make_adam`` to it for the update, which
    keeps one compiled step per track and case."""
    jcfg, dec, head, data = _setup()
    jt = JTrainConfig(teacher_forcing_ratio=ratio, fused_scan=False,
                      chunked_ce=chunked)
    ident = optax.identity()
    jfac, jemo, _ = jmake(jcfg, jt, ident, ident)
    key = jax.random.PRNGKey(9)
    keep, coins = _draws(key, ratio)

    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=HD,
                        factored_size=FD, feature_size=FEAT, dropout=0.5)
    tcfg = TrainConfig(teacher_forcing_ratio=ratio, fused_scan=ratio >= 1.0,
                       chunked_ce=chunked)
    fac, emo, val = steps = make_caption_steps(
        cfg, tcfg, optim.make_adam(LR, tcfg), optim.make_adam(LR_LANG, tcfg),
        device="cpu")
    td = {k: torch.tensor(v) for k, v in data.items()}
    args = (td["pooled"], td["captions"], td["lengths"], td["sample_mask"])
    sub = lambda a, b: np.asarray(a) - b  # noqa: E731

    # factual step: the optimizer covers (decoder, head)
    d1, h1, _, want_loss = jfac(dec, head, ident.init(None), *data.values(),
                                key)
    want_g = (jax.tree.map(sub, d1, dec),
              jax.tree.map(sub, _head_part(h1), _head_part(head)))
    tdec, thead = bridge.to_torch(dec), bridge.to_torch(head)
    loss, grads, _ = steps.factual_grads(tdec, thead, *args, keep=keep,
                                         coins=coins)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6,
                               atol=1e-6)
    _close_tree((grads[0], _head_part(grads[1])), want_g, rtol=1e-5,
                atol=1e-5)
    _, _, _, loss2 = fac(tdec, thead, steps.optimizer.init((tdec, thead)),
                         *args, keep=keep, coins=coins)
    assert float(loss2) == float(loss)
    want = _adam_step(joptim.make_adam(LR, jt), (dec, _head_part(head)),
                      want_g)
    _close_update((tdec, _head_part(thead)), want, want_g, LR)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(thead["bn"][k].numpy(),
                                   np.asarray(h1["bn"][k]), rtol=1e-6,
                                   atol=1e-6)

    # emotion step, style 2, from the original weights: decoder only
    d2, h2, _, want_loss = jemo(dec, head, ident.init(None), *data.values(),
                                jnp.asarray(2), key)
    want_g = jax.tree.map(sub, d2, dec)
    tdec, thead = bridge.to_torch(dec), bridge.to_torch(head)
    loss, grads, _ = steps.emotion_grads(tdec, thead, *args, 2, keep=keep,
                                         coins=coins)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6,
                               atol=1e-6)
    _close_tree(grads, want_g, rtol=1e-5, atol=1e-5)
    for s in (0, 1, 3):           # other styles' slices get no gradient
        assert not grads["S_w"][s].any()
    emo(tdec, thead, steps.lang_optimizer.init(tdec), *args, 2, keep=keep,
        coins=coins)
    _close_update(tdec, _adam_step(joptim.make_adam(LR_LANG, jt), dec,
                                   want_g), want_g, LR_LANG)
    np.testing.assert_array_equal(thead["linear_w"].numpy(),
                                  head["linear_w"])
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(thead["bn"][k].numpy(),
                                   np.asarray(h2["bn"][k]), rtol=1e-6,
                                   atol=1e-6)

    # validation: free-running, head in eval mode
    w_loss, w_top5, w_preds = jax_val_step(dec, head, *data.values(), 1)
    g_loss, g_top5, g_preds = val(bridge.to_torch(dec), bridge.to_torch(head),
                                  *args, 1)
    np.testing.assert_allclose(float(g_loss), float(w_loss), rtol=1e-6,
                               atol=1e-6)
    assert float(g_top5) == pytest.approx(float(w_top5), abs=1e-4)
    np.testing.assert_array_equal(g_preds.numpy(), np.asarray(w_preds))


def test_adam_with_clamp_freeze_and_decay_matches_optax():
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                    "d": rng.standard_normal((2, 2)).astype(np.float32)}}
    mask = {"a": True, "b": {"c": False, "d": True}}
    tcfg = JTrainConfig()
    jtx = joptim.make_adam(2e-3, tcfg, param_mask=mask)
    jstate = jtx.init(params)
    jp = params
    tp = bridge.to_torch(params)
    tx = optim.make_adam(2e-3, TrainConfig(), param_mask=mask)
    state = tx.init(tp)
    for step in range(3):
        grads = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 0.6
                       ).astype(np.float32), params)
        grads["a"][0, 0] = 0.0               # a zero grad still decays
        upd, jstate = jtx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(bridge.to_torch(grads), state, tp)
        if step == 1:
            assert joptim.decay_lr(jstate, 0.8) == pytest.approx(
                optim.decay_lr(state, 0.8), rel=1e-6)
        _close_tree(tp, jax.tree.map(np.asarray, jp), rtol=1e-6, atol=1e-6)
    assert optim.get_lr(state) == pytest.approx(joptim.get_lr(jstate),
                                                rel=1e-6)
    np.testing.assert_array_equal(tp["b"]["c"].numpy(), params["b"]["c"])
    assert state.mu[1] is None                # frozen: no moments


def test_steps_refuse_other_devices_and_nic():
    cfg, tcfg = DecoderConfig(vocab_size=V), TrainConfig()
    steps = make_caption_steps(cfg, tcfg, None, None, device="cpu")
    assert not steps.use_fused and not steps.use_chunked
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_caption_steps(cfg, tcfg, None, None)


@pytest.fixture(scope="module")
def jax_nic_val_step():
    jcfg, *_ = _setup()
    ident = optax.identity()
    return jmake(jcfg, JTrainConfig(), ident, ident, factored=False)[2]


@pytest.mark.parametrize("ratio", [1.0, 0.7])
@pytest.mark.parametrize("chunked", [True, False])
def test_nic_steps_match_jax(ratio, chunked, jax_nic_val_step):
    """``factored=False``: the NIC decoder's factual, emotion and val steps,
    JAX's run with ``optax.identity()`` as above.  NIC has no style
    weights: the emotion step ignores its style and trains the whole
    decoder, as JAX's does; the head is (linear_w, linear_b)."""
    jcfg, _, head, data = _setup()
    dec = jax.tree.map(np.asarray, jnic.init_params(jax.random.PRNGKey(3),
                                                    jcfg))
    rng = np.random.default_rng(5)
    for name in ("b_ih", "b_hh"):
        dec["cell"][name] = (0.05 * rng.standard_normal(4 * HD)).astype(
            np.float32)
    jt = JTrainConfig(teacher_forcing_ratio=ratio, fused_scan=False,
                      chunked_ce=chunked)
    ident = optax.identity()
    jfac, jemo, _ = jmake(jcfg, jt, ident, ident, factored=False)
    key = jax.random.PRNGKey(11)
    keep, coins = _draws(key, ratio)
    cfg = DecoderConfig(vocab_size=V, embed_size=E, hidden_size=HD,
                        factored_size=FD, feature_size=FEAT, dropout=0.5)
    tcfg = TrainConfig(teacher_forcing_ratio=ratio, fused_scan=ratio >= 1.0,
                       chunked_ce=chunked)
    fac, emo, val = steps = make_caption_steps(
        cfg, tcfg, optim.make_adam(LR, tcfg), optim.make_adam(LR_LANG, tcfg),
        factored=False, device="cpu")
    td = {k: torch.tensor(v) for k, v in data.items()}
    args = (td["pooled"], td["captions"], td["lengths"], td["sample_mask"])
    sub = lambda a, b: np.asarray(a) - b  # noqa: E731

    d1, h1, _, want_loss = jfac(dec, head, ident.init(None), *data.values(),
                                key)
    want_g = (jax.tree.map(sub, d1, dec),
              jax.tree.map(sub, _head_part(h1), _head_part(head)))
    tdec, thead = bridge.to_torch(dec), bridge.to_torch(head)
    loss, grads, _ = steps.factual_grads(tdec, thead, *args, keep=keep,
                                         coins=coins)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6,
                               atol=1e-6)
    _close_tree((grads[0], _head_part(grads[1])), want_g, rtol=1e-5,
                atol=1e-5)
    np.testing.assert_array_equal(grads[0]["cell"]["b_ih"].numpy(),
                                  grads[0]["cell"]["b_hh"].numpy())
    fac(tdec, thead, steps.optimizer.init((tdec, thead)), *args, keep=keep,
        coins=coins)
    _close_update((tdec, _head_part(thead)),
                  _adam_step(joptim.make_adam(LR, jt), (dec, _head_part(head)),
                             want_g), want_g, LR)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(thead["bn"][k].numpy(),
                                   np.asarray(h1["bn"][k]), rtol=1e-6,
                                   atol=1e-6)

    # emotion step: the style is ignored, the whole decoder trains
    d2, _, _, want_loss = jemo(dec, head, ident.init(None), *data.values(),
                               jnp.asarray(2), key)
    want_g = jax.tree.map(sub, d2, dec)
    tdec, thead = bridge.to_torch(dec), bridge.to_torch(head)
    loss, grads, _ = steps.emotion_grads(tdec, thead, *args, 2, keep=keep,
                                         coins=coins)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6,
                               atol=1e-6)
    _close_tree(grads, want_g, rtol=1e-5, atol=1e-5)
    loss3, *_ = steps.emotion_grads(tdec, thead, *args, 0, keep=keep,
                                    coins=coins)
    assert float(loss3) == float(loss)
    emo(tdec, thead, steps.lang_optimizer.init(tdec), *args, 2, keep=keep,
        coins=coins)
    _close_update(tdec, _adam_step(joptim.make_adam(LR_LANG, jt), dec,
                                   want_g), want_g, LR_LANG)

    w_loss, w_top5, w_preds = jax_nic_val_step(dec, head, *data.values(), 1)
    g_loss, g_top5, g_preds = val(bridge.to_torch(dec), bridge.to_torch(head),
                                  *args, 1)
    np.testing.assert_allclose(float(g_loss), float(w_loss), rtol=1e-6,
                               atol=1e-6)
    assert float(g_top5) == pytest.approx(float(w_top5), abs=1e-4)
    np.testing.assert_array_equal(g_preds.numpy(), np.asarray(w_preds))
