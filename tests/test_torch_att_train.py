"""The port's attention training (StyleNet+Att and NIC+Att) vs the JAX
package's: the training half of ``models/attention.py`` and
``make_attention_steps``, at a tiny width, with JAX's dropout keep-mask and
teacher-forcing coins injected into the port (torch cannot reproduce
``jax.random``; the test draws them from the step's key as the JAX forward
does: ``k_drop, k_tf = split(key)``).

The port runs K5's autograd functions (their plain versions on the CPU);
the JAX side runs its XLA scans, and where ``fused`` its Pallas K5 kernels
in interpret mode (batch 8, divisible by its tile).  Each step case runs a
factual step, an emotion step (style 2) and compares the loss (1e-6) and
the pre-optimizer grads (1e-5; float32 sums in other orders), then one
Adam update (1e-6, or 2 * lr where |grad| < 1e-5, as
``tests/test_torch_train_step.py``); JAX's own steps run with
``optax.identity()`` so they return params + grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icee_tpu.core.config import AttentionDecoderConfig as JAttConfig
from icee_tpu.core.config import TrainConfig as JTrainConfig
from icee_tpu.models import attention as jatt
from icee_tpu.train import optim as joptim
from icee_tpu.train.steps import make_attention_steps as jmake
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import AttentionDecoderConfig, TrainConfig
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.train import optim
from icee_tpu_torch.train.steps import make_attention_steps

torch.set_num_threads(2)
V, E, HD, FD, A, FS, P, B, T = 23, 6, 8, 8, 8, 12, 5, 8, 7
LR, LR_LANG = 1e-3, 5e-4
CFG = dict(vocab_size=V, embed_size=E, hidden_size=HD, factored_size=FD,
           feature_size=FS, attention_size=A, dropout=0.5)


def _setup(factored):
    jcfg = JAttConfig(**CFG)
    init = (jatt.init_factored_att_params if factored
            else jatt.init_rnn_att_params)
    dec = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    noisy = jax.tree_util.tree_map_with_path(
        lambda path, v: (v + 0.05 * rng.standard_normal(v.shape)
                         ).astype(np.float32)
        if jax.tree_util.keystr(path).endswith(("_b']", "b_ih']", "b_hh']"))
        else v, dec)
    data = dict(
        features=(0.5 * rng.standard_normal((B, P, FS))).astype(np.float32),
        captions=rng.integers(0, V, (B, T)).astype(np.int32),
        lengths=np.array([7, 4, 2, 7, 0, 5, 3, 6], np.int32),
        sample_mask=np.array([True] * 6 + [False, True]))
    return jcfg, noisy, data


def _draws(key, ratio):
    """The keep-mask and coins the JAX forward draws from ``key`` for the
    shifted captions (T - 1 steps)."""
    k_drop, k_tf = jax.random.split(key)
    keep = np.array(jax.random.bernoulli(k_drop, 0.5, (B, T - 1, E)))
    coins = (None if ratio >= 1.0 else
             np.asarray(jax.random.bernoulli(k_tf, ratio, (T - 1,))))
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


def _adam_step(tx, params, grads):
    upd, _ = tx.update(grads, tx.init(params), params)
    return jax.tree.map(np.asarray, optax.apply_updates(params, upd))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ratio", [1.0, 0.8])
@pytest.mark.parametrize("factored", [True, False])
def test_forward_hiddens_match_jax(factored, ratio, fused):
    """``*_att_forward_hiddens``: hidden states, alphas and the grads of a
    random linear loss on both; with ``fused`` JAX runs its K5 kernels
    (interpret mode) and the port K5's autograd functions, without it both
    their cell loops."""
    jcfg, dec, data = _setup(factored)
    key = jax.random.PRNGKey(3)
    keep, coins = _draws(key, ratio)
    caps = data["captions"][:, :-1]
    rng = np.random.default_rng(4)
    kh = rng.standard_normal((B, T - 1, HD)).astype(np.float32)
    ka = rng.standard_normal((B, T - 1, P)).astype(np.float32)

    def jloss(p):
        if factored:
            h, a = jatt.factored_att_forward_hiddens(
                p, jcfg, caps, data["features"], 1, ratio, key, True, fused)
        else:
            h, a = jatt.rnn_att_forward_hiddens(
                p, jcfg, caps, data["features"], ratio, key, True, fused)
        return jnp.sum(h * kh) + jnp.sum(a * ka), (h, a)

    (_, (wh, wa)), wg = jax.value_and_grad(jloss, has_aux=True)(dec)
    cfg = AttentionDecoderConfig(**CFG)
    td = {k: v for k, v in bridge.to_torch(dec).items()}
    leaves = [x.requires_grad_(True) for x in optim.tree_leaves(td)]
    kw = dict(teacher_forcing_ratio=ratio, train=True, fused_scan=fused,
              keep=keep, coins=coins)
    tc, tf = torch.tensor(caps), torch.tensor(data["features"])
    if factored:
        h, a = att_mod.factored_att_forward_hiddens(td, cfg, tc, tf, 1, **kw)
    else:
        h, a = att_mod.rnn_att_forward_hiddens(td, cfg, tc, tf, **kw)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(wh),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(wa),
                               rtol=1e-5, atol=1e-6)
    loss = (h * torch.tensor(kh)).sum() + (a * torch.tensor(ka)).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for g, w in zip(grads, jax.tree.leaves(wg)):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def jax_val_steps():
    """JAX's val steps, one per family (they depend on neither the ratio
    nor chunked_ce)."""
    ident = optax.identity()
    return {f: jmake(JAttConfig(**CFG), JTrainConfig(), ident, ident,
                     factored=f)[2] for f in (True, False)}


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.8])
@pytest.mark.parametrize("factored", [True, False])
def test_attention_steps_match_jax(factored, ratio, chunked, jax_val_steps):
    """Factual (style 0), emotion (style 2) and val steps.  The chunked
    cases run JAX's fused path (its K5 kernels in interpret mode inside
    the jitted step), the others its XLA scan."""
    jcfg, dec, data = _setup(factored)
    jt = JTrainConfig(teacher_forcing_ratio=ratio, fused_scan=chunked,
                      chunked_ce=chunked)
    ident = optax.identity()
    jfac, jemo, _ = jmake(jcfg, jt, ident, ident, factored=factored)
    key = jax.random.PRNGKey(9)
    keep, coins = _draws(key, ratio)
    cfg = AttentionDecoderConfig(**CFG)
    tcfg = TrainConfig(teacher_forcing_ratio=ratio, fused_scan=True,
                       chunked_ce=chunked)
    fac, emo, val = steps = make_attention_steps(
        cfg, tcfg, optim.make_adam(LR, tcfg), optim.make_adam(LR_LANG, tcfg),
        factored=factored, device="cpu")
    td = {k: torch.tensor(v) for k, v in data.items()}
    args = (td["features"], td["captions"], td["lengths"],
            td["sample_mask"])
    sub = lambda a, b: np.asarray(a) - b  # noqa: E731

    for track, style in (("factual", 0), ("emotion", 2)):
        if track == "factual":
            d1, _, want_loss = jfac(dec, ident.init(None), *data.values(),
                                    key)
        else:
            d1, _, want_loss = jemo(dec, ident.init(None), *data.values(),
                                    jnp.asarray(style), key)
        want_g = jax.tree.map(sub, d1, dec)
        tdec = bridge.to_torch(dec)
        if track == "factual":
            loss, grads = steps.factual_grads(tdec, *args, keep=keep,
                                              coins=coins)
        else:
            loss, grads = steps.emotion_grads(tdec, *args, style, keep=keep,
                                              coins=coins)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6,
                                   atol=1e-6, err_msg=track)
        _close_tree(grads, want_g, rtol=1e-5, atol=1e-5)
        if factored and track == "emotion":
            for s in (0, 1, 3):       # other styles' slices get no gradient
                assert not grads["S_w"][s].any()
                assert not grads["attention"]["enc_w"][s].any()
        lr, opt = ((LR, steps.optimizer) if track == "factual"
                   else (LR_LANG, steps.lang_optimizer))
        step = fac if track == "factual" else emo
        extra = () if track == "factual" else (style,)
        _, _, loss2 = step(tdec, opt.init(tdec), *args, *extra, keep=keep,
                           coins=coins)
        assert float(loss2) == float(loss)
        _close_update(tdec, _adam_step(joptim.make_adam(lr, jt), dec,
                                       want_g), want_g, lr)

    # validation: free-running, no dropout
    w_loss, w_top5, w_preds = jax_val_steps[factored](dec, *data.values(), 1)
    g_loss, g_top5, g_preds = val(bridge.to_torch(dec), *args, 1)
    np.testing.assert_allclose(float(g_loss), float(w_loss), rtol=1e-6,
                               atol=1e-6)
    assert float(g_top5) == pytest.approx(float(w_top5), abs=1e-4)
    np.testing.assert_array_equal(g_preds.numpy(), np.asarray(w_preds))


def test_attention_steps_refuse_other_devices():
    cfg, tcfg = AttentionDecoderConfig(**CFG), TrainConfig()
    steps = make_attention_steps(cfg, tcfg, None, None, device="cpu")
    assert not steps.use_fused and not steps.use_chunked
    _, dec, data = _setup(True)
    td = {k: torch.tensor(v) for k, v in data.items()}
    with pytest.raises(ValueError, match="was given a tensor on meta"):
        steps.factual_grads(bridge.to_torch(dec),
                            td["features"].to("meta"), td["captions"],
                            td["lengths"], td["sample_mask"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_attention_steps(cfg, tcfg, None, None)
