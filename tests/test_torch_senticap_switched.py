"""The SentiCap switched model's training slice: the port's
``senticap/switched.py``, the mixture CE of ``ops/chunked_loss.py``, the
switched half of ``senticap/train.py`` and ``senticap/io.py``'s switched
pickles vs the JAX package's, with the same inputs drawn from numpy seeds
and the JAX params moved across with :mod:`icee_tpu_torch.bridge`.

The switch step is held against JAX's ``make_switched_step`` with CHUNKED_CE
on and off, the switch set trainable (the ``train_switched`` regime) or
every leaf; JAX's fused path (two K8 scans) runs in interpret mode and the
port's K8 and mixture-CE wrappers take their plain versions on the CPU.  The
dropout masks are drawn with ``jax.random`` from the step's key, exactly as
JAX's step draws them, and injected into the port's step.

Tolerances: float32 on both sides, sums in other orders.  Forward
probabilities, hidden states and gates atol 1e-6; losses (sums of a few
hundred terms) rtol 1e-5; gradients atol 1e-5 or, for the mixture CE's
cotangents, 1e-5 x the largest magnitude; after one step params atol 1e-5
(the RMSProp update magnifies grad rounding by up to lr / sqrt(1e-8) = 10).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.senticap import switched as jsw
from icee_tpu.senticap.config import senticap_conf as jconf
from icee_tpu_torch import bridge
from icee_tpu_torch.ops import chunked_loss as cl
from icee_tpu_torch.senticap import io as sio
from icee_tpu_torch.senticap import switched as sw
from icee_tpu_torch.senticap.config import SWITCH_PARAMS, senticap_conf

torch.set_num_threads(2)
V, E, H, VIS, B, MAXLEN = 30, 8, 8, 12, 8, 5
T = MAXLEN + 1
SMALL = dict(emb_size=E, lstm_hidden_size=H, visual_size=VIS,
             MAX_SENTENCE_LEN=MAXLEN)
MODES = ("da_sum", "da_fixed_alpha", "da_similar_param",
         "da_similar_param_2", "da_similar_param_3")


def _params(seed):
    """Switched params: a base set, duplicates perturbed so that the two
    paths differ, a gate spread off 0.5, the dead projections."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.5):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"wemb": n(V, E), "w_lstm": n(E + H, 4 * H), "w": n(H, V),
         "b": n(V, scale=0.3), "wvm": n(VIS, E), "bmv": n(E, scale=0.1)}
    for k in list(p):
        p[f"{k}_sw"] = p[k] + n(*p[k].shape, scale=0.3)
    p.update(att_w=n(2 * H, 1, scale=1.0), att_b=n(1, scale=0.1),
             wsenti=n(H, 1), wsenti2=n(H, 1))
    return p


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    words = rng.integers(1, V, (b, T)).astype(np.int32)
    words[:, 0] = 0
    y = rng.integers(0, V, (b, T)).astype(np.int32)
    lengths = rng.integers(2, T + 1, (b,))
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    v = rng.standard_normal((b, VIS)).astype(np.float32)
    switch = (rng.random((b, T)) < 0.3).astype(np.float32)
    xd = (rng.random((b, T, E)) < 0.5).astype(np.float32) * 2.0
    yd = (rng.random((b, T, H)) < 0.5).astype(np.float32) * 2.0
    return words, y, mask, v, switch, xd, yd


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=msg)


# --- the model -------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("senti", [1.0, -1.0])
def test_step_forward_and_losses_match_jax(mode, senti):
    """``step``, ``forward`` (distributions and ``return_hiddens``),
    ``loss_fn``, ``loss_fn_from_hiddens`` and ``cost_fn`` with both dropouts,
    every DOMAIN_ADAPT mode and both batch sentiments; the chunked loss's
    value and gradients by autograd vs ``jax.value_and_grad``."""
    p = _params(0)
    words, y, mask, v, switch, xd, yd = _batch(1)
    conf = senticap_conf(DOMAIN_ADAPT=mode, FUSED_SCAN=False, **SMALL)
    jc = jconf(DOMAIN_ADAPT=mode, FUSED_SCAN=False, **SMALL)
    jp, tp = _j(p), bridge.to_torch(p)
    jargs = (jnp.asarray(words), jnp.asarray(v), jnp.asarray(senti),
             jnp.asarray(xd), jnp.asarray(yd))
    targs = (_t(words), _t(v), torch.tensor(senti), _t(xd), _t(yd))

    # one step from a random state
    rng = np.random.default_rng(2)
    h, c = (rng.standard_normal((B, 2 * H)).astype(np.float32)
            for _ in range(2))
    want = jsw.step(jp, jc, jnp.asarray(words[:, 2]), jnp.asarray(False),
                    jnp.asarray(h), jnp.asarray(c), jnp.asarray(v),
                    jnp.asarray(senti), jnp.asarray(xd[:, 2]),
                    jnp.asarray(yd[:, 2]))
    got = sw.step(tp, conf, _t(words[:, 2]), False, _t(h), _t(c), _t(v),
                  torch.tensor(senti), _t(xd[:, 2]), _t(yd[:, 2]))
    for g, w in zip(got, want):
        _close(g, w)

    s, la, l1a = sw.forward(tp, conf, *targs)
    js, jla, jl1a = jsw.forward(jp, jc, *jargs)
    for g, w in ((s, js), (la, jla), (l1a, jl1a)):
        _close(g, w)
    loss = sw.loss_fn(conf, s, _t(y), _t(mask), _t(switch), la, l1a)
    jloss = jsw.loss_fn(jc, js, jnp.asarray(y), jnp.asarray(mask),
                        jnp.asarray(switch), jla, jl1a)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    def jchunked(q):
        (hh_o, hh_n, att), la_, l1a_ = jsw.forward(q, jc, *jargs,
                                                   return_hiddens=True)
        loss_ = jsw.loss_fn_from_hiddens(
            q, jc, hh_o, hh_n, att, jnp.asarray(senti), jnp.asarray(y),
            jnp.asarray(mask), jnp.asarray(switch), la_, l1a_)
        return jsw.cost_fn(q, jc, loss_, jsw.switch_param_mask(q))

    jval, jgrads = jax.value_and_grad(jchunked)(jp)
    tq = {k: a.requires_grad_(True) for k, a in bridge.to_torch(p).items()}
    (hh_o, hh_n, att), la2, l1a2 = sw.forward(tq, conf, *targs,
                                              return_hiddens=True)
    _close(att.detach(), np.exp(jla))
    closs = sw.loss_fn_from_hiddens(tq, conf, hh_o, hh_n, att,
                                    torch.tensor(senti), _t(y), _t(mask),
                                    _t(switch), la2, l1a2)
    np.testing.assert_allclose(closs.item(), float(jloss), rtol=1e-5)
    cost = sw.cost_fn(tq, conf, closs, sw.switch_param_mask(tq))
    np.testing.assert_allclose(float(cost), float(jval), rtol=1e-5)
    grads = torch.autograd.grad(cost, list(tq.values()), allow_unused=True)
    for k, g in zip(tq, grads):
        want_g = np.asarray(jgrads[k])
        _close(np.zeros_like(want_g) if g is None else g, want_g, 1e-5, k)


def test_fused_forward_runs_two_scans_and_matches_jax():
    """``forward(return_hiddens=True)`` through K8's wrapper (its plain
    version here) vs JAX's fused branch (the Pallas K8 in interpret mode);
    with every background weight frozen the background scan is left out
    of autograd, and the gradients of the rest are unchanged."""
    p = _params(3)
    words, _, _, v, _, xd, yd = _batch(4)
    conf = senticap_conf(FUSED_SCAN=True, **SMALL)
    (jo, jn, jatt), jla, _ = jsw.forward(
        _j(p), jconf(FUSED_SCAN=True, **SMALL), jnp.asarray(words),
        jnp.asarray(v), jnp.asarray(1.0), jnp.asarray(xd), jnp.asarray(yd),
        return_hiddens=True)
    grads = {}
    for frozen in (False, True):
        tp = {k: a.requires_grad_(not (frozen and k in sw.BASE_NAMES))
              for k, a in bridge.to_torch(p).items()}
        (ho, hn, att), la, _ = sw.forward(tp, conf, _t(words), _t(v),
                                          torch.tensor(1.0), _t(xd), _t(yd),
                                          return_hiddens=True)
        for g, w in ((ho, jo), (hn, jn), (att, jatt), (la, jla)):
            _close(g.detach(), w)
        assert ho.requires_grad != frozen
        loss = (att.sum() + (hn ** 2).sum())
        grads[frozen] = dict(zip(SWITCH_PARAMS[:6], torch.autograd.grad(
            loss, [tp[k] for k in SWITCH_PARAMS[:6]], allow_unused=True)))
    for k, g in grads[True].items():
        want = grads[False][k]
        assert (g is None) == (want is None), k
        if g is not None:
            _close(g, want, 1e-6, k)


def test_joined_loss_function_is_refused_by_the_switched_step():
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap.train import make_switched_step

    conf = senticap_conf(JOINED_LOSS_FUNCTION=True, batch_size_val=B,
                         **SMALL)
    ds, _ = _split(5)
    tp = bridge.to_torch(_params(6))
    step = make_switched_step(conf, make_solver(conf), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="switched model's loss is "
                             "senticap/switched.py::loss_fn"):
        step(tp, step.solver.init(tp), sio.device_dataset(ds, "cpu"),
             torch.arange(B))


def test_init_params_switch_mask_and_one_step():
    """``init_params`` seeds both paths from ``base`` (copies, not views)
    and has JAX's shapes; ``switch_param_mask``; ``one_step`` = JAX's."""
    from icee_tpu_torch.senticap import model

    conf = senticap_conf(**SMALL)
    base = model.init_params(torch.Generator().manual_seed(0), V, conf)
    tp = sw.init_params(torch.Generator().manual_seed(1), V, conf, base=base)
    jp = jsw.init_params(jax.random.PRNGKey(1), V, jconf(**SMALL))
    assert {k: tuple(a.shape) for k, a in tp.items()} == \
        {k: tuple(a.shape) for k, a in jp.items()}
    for k in sw.BASE_NAMES:
        assert torch.equal(tp[k], base[k]) and torch.equal(tp[f"{k}_sw"],
                                                           base[k])
        assert tp[f"{k}_sw"].data_ptr() != tp[k].data_ptr() != \
            base[k].data_ptr()
    assert tp["att_w"].abs().max() <= np.sqrt(6.0 / (2 * H + 1))
    assert torch.equal(tp["att_b"], torch.zeros(1))
    assert sw.switch_param_mask(tp) == jsw.switch_param_mask(jp)
    assert sorted(k for k, m in sw.switch_param_mask(tp).items() if m) == \
        sorted(SWITCH_PARAMS)
    p = _params(7)
    rng = np.random.default_rng(8)
    h, c = (rng.standard_normal((3, 2 * H)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((3, VIS)).astype(np.float32)
    want = jsw.one_step(_j(p), jconf(**SMALL), jnp.asarray([0, 4, 9]),
                        jnp.asarray(True), jnp.asarray(h), jnp.asarray(c),
                        jnp.asarray(v), jnp.asarray(1.0))
    got = sw.one_step(bridge.to_torch(p), conf, torch.tensor([0, 4, 9]),
                      True, _t(h), _t(c), _t(v), 1.0)
    for g, w in zip(got, want):
        _close(g, w)


# --- the mixture CE --------------------------------------------------------

def _mixture_inputs(seed):
    rng = np.random.default_rng(seed)
    b, t, h, v = 5, 7, 6, 40
    a = {"hh_o": 2 * rng.standard_normal((b, t, h)),
         "hh_n": 2 * rng.standard_normal((b, t, h))}
    att = rng.uniform(0.05, 0.95, (b, t))
    a.update(co=1 - att, cn=att, w_o=rng.standard_normal((h, v)),
             b_o=rng.standard_normal(v), w_n=rng.standard_normal((h, v)),
             b_n=rng.standard_normal(v))
    a = {k: np.asarray(x, np.float32) for k, x in a.items()}
    y = rng.integers(0, v, (b, t)).astype(np.int32)
    w = rng.uniform(0.0, 2.0, (b, t)).astype(np.float32)
    # one floored token: both heads give its target p ~ exp(-600) = 0
    a["b_o"][3] = a["b_n"][3] = -600.0
    y[0, 0] = 3
    return a, y, w


@pytest.mark.parametrize("t_chunk", [4, None])
def test_mixture_ce_value_and_every_cotangent_match_jax(t_chunk):
    """``mixture_ce_from_hiddens`` (the row passes' plain versions here) and
    ``mixture_ce_plain`` vs ``jax.vjp`` of JAX's custom_vjp, an upstream
    gradient of 1.7; the floored token gets zero gradient; a frozen
    background head (no gradient asked of it) leaves the rest unchanged."""
    from icee_tpu.ops.chunked_loss import mixture_ce_from_hiddens as jmix

    a, y, w = _mixture_inputs(11)
    names = list(a)
    val, vjp = jax.vjp(lambda *x: jmix(*x, jnp.asarray(y), jnp.asarray(w),
                                       t_chunk),
                       *[jnp.asarray(a[k]) for k in names])
    jgrads = dict(zip(names, vjp(jnp.float32(1.7))))
    assert float(np.asarray(jgrads["co"])[0, 0]) == 0.0
    for fn in (cl.mixture_ce_from_hiddens, cl.mixture_ce_plain):
        ta = {k: _t(a[k]).requires_grad_(True) for k in names}
        out = fn(*ta.values(), _t(y), _t(w), t_chunk)
        np.testing.assert_allclose(float(out), float(val), rtol=1e-5)
        got = torch.autograd.grad(1.7 * out, list(ta.values()))
        for k, g in zip(names, got):
            want = np.asarray(jgrads[k])
            _close(g, want, 1e-5 * np.abs(want).max(), f"{fn.__name__} {k}")
    # switch training: no gradient asked of the background head
    ta = {k: _t(a[k]).requires_grad_(k not in ("hh_o", "w_o", "b_o"))
          for k in names}
    out = cl.mixture_ce_from_hiddens(*ta.values(), _t(y), _t(w), t_chunk)
    live = [k for k in names if ta[k].requires_grad]
    for k, g in zip(live, torch.autograd.grad(1.7 * out,
                                              [ta[k] for k in live])):
        want = np.asarray(jgrads[k])
        _close(g, want, 1e-5 * np.abs(want).max(), k)


def test_mixture_rows_and_neglog2_sum_match_jax():
    """The forward row pass against its plain version, and the switched
    perplexity numerator against JAX's."""
    from icee_tpu.ops.chunked_loss import \
        mixture_neglog2_sum_from_hiddens as jneglog2

    a, y, w = _mixture_inputs(12)
    for t_chunk in (None, 3):
        want = jneglog2(*[jnp.asarray(x) for x in a.values()],
                        jnp.asarray(y), jnp.asarray(w), t_chunk)
        got = cl.mixture_neglog2_sum_from_hiddens(
            *[_t(x) for x in a.values()], _t(y), _t(w), t_chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    rng = np.random.default_rng(13)
    lo, ln = (_t(rng.standard_normal((9, 40)).astype(np.float32) * 3)
              for _ in range(2))
    tg = torch.tensor(rng.integers(0, 40, 9))
    co, wt = (_t(rng.uniform(0, 1, 9).astype(np.float32)) for _ in range(2))
    rows = cl.mixture_ce_rows(lo, ln, tg, co, 1 - co, wt)
    p_o = torch.softmax(lo, -1).gather(1, tg[:, None])[:, 0]
    p_n = torch.softmax(ln, -1).gather(1, tg[:, None])[:, 0]
    _close(rows[0], torch.logsumexp(lo, -1), 1e-5)
    _close(rows[2], p_o)
    _close(rows[3], p_n)
    _close(rows[4], wt * -torch.log(co * p_o + (1 - co) * p_n), 1e-5)


# --- training --------------------------------------------------------------

def _records(seed, n, senti=None):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V - 1)]
    return [{"image": f"img{i}",
             "tokens": list(rng.choice(words, rng.integers(2, 8))),
             "sentiment": senti if senti is not None else float(
                 rng.choice([-1.0, 1.0])),
             "switch": list(rng.integers(0, 2, 7))} for i in range(n)]


def _split(seed, n=12, senti=1.0):
    from icee_tpu.senticap import io as jio

    recs = _records(seed, n, senti)
    rng = np.random.default_rng(seed + 1)
    feats = {r["image"]: rng.standard_normal(VIS).astype(np.float32)
             for r in recs}
    w2i, _ = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    assert len(w2i) <= V
    return (sio.make_split(recs, feats, w2i, MAXLEN, VIS),
            jio.make_split(recs, feats, w2i, MAXLEN, VIS))


@pytest.mark.parametrize("chunked,masked", [(True, True), (False, True),
                                            (True, False), (False, False)])
def test_switched_step_matches_jax(chunked, masked):
    """One RMSProp step of the switched model on a sentiment-pure minibatch:
    JAX's jitted step (two fused K8 scans in interpret mode when chunked)
    vs the port's, with JAX's dropout masks injected; the solver trains the
    switch set (``train_switched``) or every leaf."""
    from icee_tpu.senticap import io as jio
    from icee_tpu.senticap import solver as jsolver
    from icee_tpu.senticap.train import make_switched_step as jmake_step
    from icee_tpu_torch.senticap import solver
    from icee_tpu_torch.senticap.train import make_switched_step

    kw = dict(CHUNKED_CE=chunked, FUSED_SCAN=True, batch_size_val=B, **SMALL)
    ds, jds = _split(40)
    p = _params(41)
    idx = np.array([3, 0, 7, 1, 9, 4, 11, 2], np.int32)
    key = jax.random.PRNGKey(5)
    mask = jsw.switch_param_mask(p) if masked else None

    jc = jconf(**kw)
    jtx = jsolver.make_solver(jc, mask)
    jp = _j(p)
    jp2, _, jloss = jmake_step(jc, jtx)(jp, jtx.init(jp),
                                        jio.device_dataset(jds),
                                        jnp.asarray(idx), key)
    kx, ky = jax.random.split(key)
    xd = jax.random.bernoulli(kx, 0.5, (B, T, E)).astype(jnp.float32) / 0.5
    yd = jax.random.bernoulli(ky, 0.5, (B, T, H)).astype(jnp.float32) / 0.5

    conf = senticap_conf(**kw)
    tx = solver.make_solver(conf, mask)
    tp = bridge.to_torch(p)
    step = make_switched_step(conf, tx, device="cpu")
    assert step.use_chunked == chunked
    _, _, loss = step(tp, tx.init(tp), sio.device_dataset(ds, "cpu"),
                      _t(idx).long(), x_drop=_t(xd), y_drop=_t(yd))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in p:
        _close(tp[k].numpy(), jp2[k], 1e-5, k)
        moved = not np.array_equal(tp[k].numpy(), p[k])
        if masked and k not in SWITCH_PARAMS:
            assert not moved, k                    # frozen: bit-identical
        if k in ("w_sw", "w_lstm_sw", "att_w", "att_b"):
            assert moved, k


def test_epoch_indices_by_sentiment_match_jax():
    from icee_tpu.senticap.train import \
        _epoch_indices_by_sentiment as jbatches
    from icee_tpu_torch.senticap.train import _epoch_indices_by_sentiment

    senti = np.random.default_rng(0).choice([-1.0, 1.0], 37).astype(
        np.float32)
    got = _epoch_indices_by_sentiment(senti, 4, np.random.default_rng(3))
    want = jbatches(senti, 4, np.random.default_rng(3))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert all(len(set(senti[g].tolist())) == 1 for g in got)


@pytest.mark.parametrize("width,lr,goes_nan", [(512, 1e-3, True),
                                               (512, 1e-4, False),
                                               (64, 1e-3, False)])
def test_switch_training_goes_nan_at_lr_1e3_in_both_packages(width, lr,
                                                              goes_nan):
    """Twelve switch-training steps from a Xavier-initialized base
    (``model.init_params``, then ``init_params(base=...)``) over styled
    captions, JAX's jitted step vs the port's with JAX's dropout masks
    injected.  At E = H = 512 and the reference's lr 1e-3 the gate, a sum
    of 2H = 1,024 inputs, saturates: sigmoid rounds to 1.0 and the loss is
    nan, at the same step (9) in both packages.  At lr 1e-4, or at lr 1e-3
    with H = 64, twelve steps stay finite.  The losses agree within rtol
    1e-5 while finite.  (Not every draw goes nan at lr 1e-3 within twelve
    steps; those that do not still see both packages' losses drift apart
    by up to 2% after ten steps, against ~1e-7 at lr 1e-4.)"""
    from icee_tpu.senticap import io as jio
    from icee_tpu.senticap import solver as jsolver
    from icee_tpu.senticap.train import make_switched_step as jmake_step
    from icee_tpu_torch.senticap import model, solver
    from icee_tpu_torch.senticap.train import make_switched_step

    b, vis, maxlen, n_steps = 16, 64, 7, 12
    t = maxlen + 1
    kw = dict(emb_size=width, lstm_hidden_size=width, visual_size=vis,
              MAX_SENTENCE_LEN=maxlen, CHUNKED_CE=False, FUSED_SCAN=False,
              batch_size_val=b, learning_rate=lr)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(297)]
    recs = [{"image": f"i{i}",
             "tokens": list(rng.choice(words, rng.integers(3, 8))),
             "sentiment": 1.0,
             "switch": list((rng.random(7) < 0.2).astype(int))}
            for i in range(4 * b)]
    feats = {r["image"]: rng.standard_normal(vis).astype(np.float32)
             for r in recs}
    w2i, _ = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    ds = sio.make_split(recs, feats, w2i, maxlen, vis)
    jds = jio.make_split(recs, feats, w2i, maxlen, vis)
    conf, jc = senticap_conf(**kw), jconf(**kw)
    base = model.init_params(torch.Generator().manual_seed(81), len(w2i),
                             conf)
    p = {k: v.numpy() for k, v in sw.init_params(
        torch.Generator().manual_seed(64), len(w2i), conf,
        base=base).items()}
    mask = jsw.switch_param_mask(p)
    jtx, tx = jsolver.make_solver(jc, mask), solver.make_solver(conf, mask)
    jstep, step = jmake_step(jc, jtx), make_switched_step(conf, tx,
                                                          device="cpu")
    jp, tp = _j(p), bridge.to_torch(p)
    jst, tst = jtx.init(jp), tx.init(tp)
    jd, td = jio.device_dataset(jds), sio.device_dataset(ds, "cpu")
    jlosses, tlosses = [], []
    for i in range(n_steps):
        idx = np.arange((i % 4) * b, (i % 4 + 1) * b, dtype=np.int32)
        key = jax.random.PRNGKey(100 + i)
        jp, jst, jloss = jstep(jp, jst, jd, jnp.asarray(idx), key)
        kx, ky = jax.random.split(key)
        xd = jax.random.bernoulli(kx, 0.5, (b, t, width)).astype(
            jnp.float32) / 0.5
        yd = jax.random.bernoulli(ky, 0.5, (b, t, width)).astype(
            jnp.float32) / 0.5
        tp, tst, tloss = step(tp, tst, td, _t(idx).long(), x_drop=_t(xd),
                              y_drop=_t(yd))
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    finite = np.isfinite(jlosses)
    np.testing.assert_array_equal(np.isfinite(tlosses), finite)
    np.testing.assert_allclose(np.asarray(tlosses)[finite],
                               np.asarray(jlosses)[finite], rtol=1e-5)
    assert (not finite.all()) == goes_nan
    if goes_nan:
        assert finite.tolist() == [True] * 9 + [False] * 3


def test_train_switched_learns_and_device_epoch_matches():
    """Three epochs of ``train_switched`` on the CPU over a mixed-sentiment
    split: the switched perplexity falls, only the switch set moves, and
    ``device_epoch`` (losses read back once per epoch) gives the same
    parameters; ``init_params_override`` is trained in place."""
    from icee_tpu_torch.senticap import model
    from icee_tpu_torch.senticap.train import (train_switched,
                                               validation_perplexity)

    recs = _records(60, 24)
    feats = {r["image"]: np.random.default_rng(i).standard_normal(
        VIS).astype(np.float32) for i, r in enumerate(recs)}
    w2i, _ = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    ds = sio.make_split(recs, feats, w2i, MAXLEN, VIS)
    conf = senticap_conf(batch_size_val=4, learning_rate=0.01, **SMALL)
    base = model.init_params(torch.Generator().manual_seed(2), V, conf)
    seen = []
    p1, _ = train_switched(ds, base, V, conf, num_epochs=3, seed=1,
                           device="cpu", callbacks=[
                               lambda e, p: seen.append(validation_perplexity(
                                   p, conf, ds, switched=True,
                                   device="cpu"))])
    p2, _ = train_switched(ds, base, V, conf, num_epochs=3, seed=1,
                           device="cpu", device_epoch=True)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        if k in sw.BASE_NAMES:
            assert torch.equal(p1[k], base[k]), k
    assert seen[-1] < seen[0]
    start = sw.init_params(torch.Generator().manual_seed(1), V, conf,
                           base=base)
    p3, _ = train_switched(ds, None, V, conf, num_epochs=3, seed=1,
                           device="cpu", init_params_override=start)
    assert p3 is start
    for k in p1:
        assert torch.equal(p1[k], p3[k]), k
    with pytest.raises(NotImplementedError, match="slice 8"):
        train_switched(ds, base, V, conf, num_epochs=1, mesh=object(),
                       device="cpu")


def test_validation_perplexity_switched_matches_jax():
    from icee_tpu.senticap.train import \
        validation_perplexity as jvalidation_perplexity
    from icee_tpu_torch.senticap.train import validation_perplexity

    p = _params(51)
    for senti in (1.0, -1.0):
        ds, jds = _split(50, senti=senti)
        for chunked in (True, False):
            want = jvalidation_perplexity(
                _j(p), jconf(CHUNKED_CE=chunked, FUSED_SCAN=False, **SMALL),
                jds, switched=True)
            got = validation_perplexity(
                bridge.to_torch(p), senticap_conf(CHUNKED_CE=chunked,
                                                  **SMALL),
                ds, switched=True, device="cpu")
            np.testing.assert_allclose(got, want, rtol=1e-5)


# --- vocab surgery ---------------------------------------------------------

def test_grow_vocab_and_embedding_closest_fn_match_jax():
    w2i = {"#START#": 0, "#STOP#": 1, **{f"w{i}": i + 2 for i in range(8)}}
    rng = np.random.default_rng(70)
    wemb = rng.standard_normal((10, E)).astype(np.float32)
    corpus = [["w1", "gloomy", "w2", "w3"], ["w4", "sunny", "w1"],
              ["w2", "gloomy", "w5"], ["lonely"], ["w6", "w6", "w7"]]
    jfind = jsw.make_embedding_closest_fn(wemb, w2i, corpus, window=2)
    find = sw.make_embedding_closest_fn(torch.tensor(wemb), w2i, corpus,
                                        window=2)
    for word in ("gloomy", "sunny", "lonely", "w3", "unseen"):
        assert find(word) == jfind(word), word
    rng = np.random.default_rng(71)
    p = {"att_w": rng.standard_normal((2 * H, 1)).astype(np.float32)}
    for suffix in ("", "_sw"):
        for name, shape in (("wemb", (10, E)), ("w", (H, 10)), ("b", (10,))):
            p[name + suffix] = rng.standard_normal(shape).astype(np.float32)
    added = [("gloomy", 10), ("sunny", 12), ("lonely", 4)]
    want = jsw.grow_vocab(_j(p), added, jfind)
    tp = bridge.to_torch(p)
    got = sw.grow_vocab(tp, added, find)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["wemb"].shape == (13, E) and got["w_sw"].shape == (H, 13)
    np.testing.assert_array_equal(tp["wemb"].numpy(), p["wemb"])


# --- io --------------------------------------------------------------------

def test_switched_pickles_cross_between_the_packages(tmp_path):
    """A switched tree (the *_sw set, the gate, the dead projections) and
    its masked RMSProp state through ``io.save_model``/``load_model``."""
    from icee_tpu.senticap import io as jio

    p = _params(80)
    conf = jconf(**SMALL)
    jio.save_model(str(tmp_path / "jax.pkl"), _j(p), conf,
                   {"cache": {k: jnp.ones(np.shape(p[k])) for k in
                              SWITCH_PARAMS}}, {".": 0})
    tp, tconf, state, _ = sio.load_model(str(tmp_path / "jax.pkl"), "cpu")
    assert tconf == conf and sorted(state["cache"]) == sorted(SWITCH_PARAMS)
    for k in p:
        np.testing.assert_array_equal(tp[k].numpy(), p[k], err_msg=k)
    sio.save_model(str(tmp_path / "torch.pkl"), tp, tconf,
                   {"cache": {k: torch.ones(2) for k in SWITCH_PARAMS}})
    with open(tmp_path / "torch.pkl", "rb") as f:
        blob = pickle.load(f)
    assert sorted(blob["params"]) == sorted(p)
    jp, _, _, _ = jio.load_model(str(tmp_path / "torch.pkl"))
    for k in p:
        np.testing.assert_array_equal(np.asarray(jp[k]), p[k], err_msg=k)


def test_io_entry_points_default_to_cuda(tmp_path):
    """``device_dataset`` and ``load_model`` put tensors on the card unless
    the caller asks for the CPU; without CUDA the default raises."""
    ds, _ = _split(90, n=4)
    sio.save_model(str(tmp_path / "m.pkl"), bridge.to_torch(_params(91)),
                   senticap_conf(**SMALL))
    assert sio.device_dataset(ds, "cpu")["X"].device.type == "cpu"
    assert sio.load_model(str(tmp_path / "m.pkl"), "cpu")[0][
        "w"].device.type == "cpu"
    if torch.cuda.is_available():
        assert sio.device_dataset(ds)["X"].device.type == "cuda"
        assert sio.load_model(str(tmp_path / "m.pkl"))[0][
            "w"].device.type == "cuda"
    else:
        for call in (lambda: sio.device_dataset(ds),
                     lambda: sio.load_model(str(tmp_path / "m.pkl"))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
