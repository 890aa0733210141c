"""The SentiCap base model's training slice: the port's ``senticap/model.py``,
``solver.py``, ``io.py``, ``train.py`` (base half) and the chunked neglog2
sum vs the JAX package's, with the same inputs drawn from numpy seeds and
the JAX params moved across with :mod:`icee_tpu_torch.bridge`.

The train step is held against JAX's ``make_base_step`` at SEMI_FORCED 1.0
and 0.8 with CHUNKED_CE on and off; JAX's fused path (K8) runs in interpret
mode and the port's K8 wrapper takes its plain version on the CPU.  The
dropout masks and the semi-forced matrix are drawn with ``jax.random`` from
the step's key, exactly as JAX's step draws them, and injected into the
port's step.

Tolerances: float32 on both sides, sums in other orders.  Cell, forward,
probabilities and hidden states atol 1e-6; losses and log2 sums rtol 1e-5
(sums of up to a few hundred terms); gradients through the scan 1e-5; the
solvers 1e-6; after one train step params atol 1e-5 (the RMSProp update
magnifies grad rounding by up to lr / sqrt(1e-8) = 10) and the loss, a
masked SUM of ~30 token terms, rtol 1e-5.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.senticap import model as jmodel
from icee_tpu.senticap import solver as jsolver
from icee_tpu.senticap.config import senticap_conf as jconf
from icee_tpu_torch import bridge
from icee_tpu_torch.ops.chunked_loss import masked_neglog2_sum_from_hiddens
from icee_tpu_torch.senticap import io as sio
from icee_tpu_torch.senticap import model
from icee_tpu_torch.senticap import solver
from icee_tpu_torch.senticap.config import senticap_conf

torch.set_num_threads(2)
V, E, H, VIS, B, MAXLEN = 30, 8, 8, 12, 8, 5
T = MAXLEN + 1
SMALL = dict(emb_size=E, lstm_hidden_size=H, visual_size=VIS,
             MAX_SENTENCE_LEN=MAXLEN)


def _params(seed, bn=False):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.5):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"wemb": n(V, E), "w_lstm": n(E + H, 4 * H), "w": n(H, V),
         "b": n(V, scale=0.3), "wvm": n(VIS, E), "bmv": n(E, scale=0.1)}
    if bn:
        p["gamma_h"] = 1.0 + n(E + H, scale=0.1)
        p["beta_h"] = n(E + H, scale=0.1)
    return p


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    words = rng.integers(1, V, (b, T)).astype(np.int32)
    words[:, 0] = 0
    y = rng.integers(0, V, (b, T)).astype(np.int32)
    lengths = rng.integers(2, T + 1, (b,))
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    v = rng.standard_normal((b, VIS)).astype(np.float32)
    xd = (rng.random((b, T, E)) < 0.5).astype(np.float32) * 2.0
    yd = (rng.random((b, T, H)) < 0.5).astype(np.float32) * 2.0
    return words, y, mask, v, xd, yd


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# --- model -------------------------------------------------------------------

@pytest.mark.parametrize("bn", [False, True])
def test_cell_and_its_grads_match_jax(bn):
    """The cell, BATCH_NORM affine quirk on and off, and its vjp: GradClip
    clamps the gradient into h (gclip 0.05 binds here)."""
    p = _params(0, bn)
    rng = np.random.default_rng(1)
    x, h, c = (rng.standard_normal((4, d)).astype(np.float32)
               for d in (E, H, H))
    gh, gc = (rng.standard_normal((4, H)).astype(np.float32) * 3
              for _ in range(2))

    def jfn(p_, h_):
        return jmodel.cell(p_, jnp.asarray(x), h_, jnp.asarray(c), 0.05, bn)

    (jh, jc), vjp = jax.vjp(jfn, _j(p), jnp.asarray(h))
    jgp, jgh = vjp((jnp.asarray(gh), jnp.asarray(gc)))
    tp = {k: v.requires_grad_(True) for k, v in bridge.to_torch(p).items()}
    th = _t(h).requires_grad_(True)
    hh, cc = model.cell(tp, _t(x), th, _t(c), 0.05, bn)
    np.testing.assert_allclose(hh.detach().numpy(), jh, atol=1e-6)
    np.testing.assert_allclose(cc.detach().numpy(), jc, atol=1e-6)
    keys = ["w_lstm"] + (["gamma_h", "beta_h"] if bn else [])
    got = torch.autograd.grad((hh, cc), [tp[k] for k in keys] + [th],
                              (_t(gh), _t(gc)))
    for k, g in zip(keys + ["h"], got):
        want = jgh if k == "h" else jgp[k]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5)
    assert np.abs(np.asarray(jgh)).max() <= 0.05 + 1e-7


def test_grad_clip_act_clips_backward_only():
    x = torch.tensor([0.5, -2.0, 3.0], requires_grad=True)
    y = model.grad_clip_act(x, 1.0)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y, x, torch.tensor([0.2, -5.0, 7.0]))
    assert g.tolist() == pytest.approx([0.2, -1.0, 1.0])


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(fused):
    """The teacher-forced forward (visual pseudo-word at step 0) with both
    dropouts: probabilities, and the hidden states for the chunked loss
    (through K8's wrapper when ``FUSED_SCAN``)."""
    p = _params(2)
    words, _, _, v, xd, yd = _batch(3)
    conf = senticap_conf(FUSED_SCAN=fused, **SMALL)
    jc = jconf(FUSED_SCAN=fused, **SMALL)
    want_s = jmodel.forward(_j(p), jc, jnp.asarray(words), jnp.asarray(v),
                            True, jnp.asarray(xd), jnp.asarray(yd))
    want_h = jmodel.forward(_j(p), jc, jnp.asarray(words), jnp.asarray(v),
                            True, jnp.asarray(xd), jnp.asarray(yd),
                            return_hiddens=True)
    tp = bridge.to_torch(p)
    got_s = model.forward(tp, conf, _t(words), _t(v), True, _t(xd), _t(yd))
    got_h = model.forward(tp, conf, _t(words), _t(v), True, _t(xd), _t(yd),
                          return_hiddens=True)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-6)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-6)
    # step 0 sees the image: another image changes it
    other = model.forward(tp, conf, _t(words), _t(v[::-1].copy()), True)
    assert not torch.allclose(other[:, 0], got_s[:, 0])


@pytest.mark.parametrize("hiddens", [False, True])
def test_semi_forced_scan_matches_jax(hiddens):
    p = _params(4)
    words, _, _, v, xd, yd = _batch(5)
    forced = (np.random.default_rng(6).random((B, T)) < 0.6).astype(
        np.float32)
    want = jmodel.forward_semi_forced(
        _j(p), jconf(**SMALL), jnp.asarray(words), jnp.asarray(v),
        jnp.asarray(forced), jnp.asarray(xd), jnp.asarray(yd),
        return_hiddens=hiddens)
    got = model.forward_semi_forced(
        bridge.to_torch(p), senticap_conf(**SMALL), _t(words), _t(v),
        _t(forced), _t(xd), _t(yd), return_hiddens=hiddens)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_loss_perplexity_and_chunked_loss_match_jax():
    p = _params(7)
    words, y, mask, v, _, _ = _batch(8)
    s = jmodel.forward(_j(p), jconf(**SMALL), jnp.asarray(words),
                       jnp.asarray(v))
    ts = model.forward(bridge.to_torch(p), senticap_conf(**SMALL), _t(words),
                       _t(v))
    args = (jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_allclose(float(model.loss_fn(ts, _t(y), _t(mask))),
                               float(jmodel.loss_fn(s, *args)), rtol=1e-5)
    np.testing.assert_allclose(float(model.perplexity(ts, _t(y), _t(mask))),
                               float(jmodel.perplexity(s, *args)), rtol=1e-5)
    hh = np.random.default_rng(9).standard_normal((B, T, H)).astype(
        np.float32)
    want = jmodel.loss_fn_from_hiddens(_j(p), jnp.asarray(hh), *args)
    got = model.loss_fn_from_hiddens(bridge.to_torch(p), _t(hh), _t(y),
                                     _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_neglog2_sum_from_hiddens_matches_jax():
    from icee_tpu.ops.chunked_loss import \
        masked_neglog2_sum_from_hiddens as jneglog2

    p = _params(10)
    _, y, mask, _, _, _ = _batch(11)
    hh = 3 * np.random.default_rng(12).standard_normal((B, T, H)).astype(
        np.float32)
    for t_chunk in (None, 4):
        want = jneglog2(jnp.asarray(hh), jnp.asarray(p["w"]),
                        jnp.asarray(p["b"]), jnp.asarray(y),
                        jnp.asarray(mask), t_chunk)
        got = masked_neglog2_sum_from_hiddens(_t(hh), _t(p["w"]), _t(p["b"]),
                                              _t(y), _t(mask), t_chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_greedy_sample_and_init_params():
    p = _params(13)
    v = np.random.default_rng(14).standard_normal((3, VIS)).astype(
        np.float32)
    want = jmodel.greedy_sample(_j(p), jconf(**SMALL), jnp.asarray(v))
    got = model.greedy_sample(bridge.to_torch(p), senticap_conf(**SMALL),
                              _t(v))
    assert got.tolist() == np.asarray(want).tolist()
    for bn in (False, True):
        conf = senticap_conf(BATCH_NORM=bn, **SMALL)
        jp = jmodel.init_params(jax.random.PRNGKey(0), V, jconf(
            BATCH_NORM=bn, **SMALL))
        tp = model.init_params(torch.Generator().manual_seed(0), V, conf)
        assert {k: tuple(a.shape) for k, a in jp.items()} == \
            {k: tuple(a.shape) for k, a in tp.items()}
        bound = np.sqrt(6.0 / (V + E))
        assert tp["wemb"].abs().max() <= bound
        assert torch.allclose(tp["b"], torch.full((V,), -np.log(V)))
    unigram = np.full(V, 1.0 / V)
    tp = model.init_params(torch.Generator().manual_seed(0), V,
                           senticap_conf(**SMALL), unigram)
    np.testing.assert_allclose(tp["b"].numpy(), np.log(unigram + 1e-20),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError, match="switched"):
        model.forward(tp, senticap_conf(JOINED_LOSS_FUNCTION=True, **SMALL),
                      torch.zeros((1, T), dtype=torch.long),
                      torch.zeros((1, VIS)))


# --- solver ------------------------------------------------------------------

@pytest.mark.parametrize("method", ["rmsprop", "adadelta"])
def test_solver_matches_jax(method):
    """Three steps of g / batch_size_val -> clip -> RMSProp or Adadelta,
    with a trainable mask that freezes two leaves."""
    import optax

    p = _params(15)
    conf = senticap_conf(GRAD_METHOD=method, **SMALL)
    mask = {k: k not in ("wvm", "bmv") for k in p}
    jtx = jsolver.make_solver(jconf(GRAD_METHOD=method, **SMALL), mask)
    jp = _j(p)
    js = jtx.init(jp)
    tx = solver.make_solver(conf, mask)
    tp = bridge.to_torch(p)
    ts = tx.init(tp)
    for i in range(3):
        g = {k: (300.0 * np.random.default_rng(20 + i).standard_normal(
            a.shape)).astype(np.float32) for k, a in p.items()}
        upd, js = jtx.update(_j(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = tx.update(bridge.to_torch(g), ts, tp)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tp["wvm"].numpy(), p["wvm"])
    with pytest.raises(ValueError, match="GRAD_METHOD"):
        solver.make_solver(senticap_conf(GRAD_METHOD="sgd"))


# --- io ------------------------------------------------------------------------

def _records(seed, n=6):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V - 1)]
    recs = [{"image": f"img{i}",
             "tokens": list(rng.choice(words, rng.integers(2, 8))),
             "sentiment": float(rng.choice([-1.0, 1.0])),
             "switch": list(rng.integers(0, 2, 7))} for i in range(n)]
    feats = {f"img{i}": rng.standard_normal(VIS + 2).astype(np.float32)
             for i in range(n)}
    return recs, feats


def test_make_split_layout_and_vocab_match_jax():
    from icee_tpu.senticap import io as jio

    recs, feats = _records(30)
    caps = [r["tokens"] for r in recs]
    w2i, i2w = sio.build_vocab(caps, min_freq=2)
    assert (w2i, i2w) == jio.build_vocab(caps, min_freq=2)
    for reverse in (False, True):
        got = sio.make_split(recs, feats, w2i, MAXLEN, VIS, reverse)
        want = jio.make_split(recs, feats, w2i, MAXLEN, VIS, reverse)
        for f in ("X", "Y", "Xlen", "V", "SW", "senti"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.ids == want.ids
    assert got.X[:, 0].tolist() == [0] * len(recs)   # START = STOP id
    assert sio.tokenize("A dog, runs!") == jio.tokenize("A dog, runs!")
    assert sio.dataset_files("coco", "/d") == jio.dataset_files("coco", "/d")
    data = sio.device_dataset(got, "cpu")
    assert data["X"].dtype == torch.int32 and data["V"].shape == (6, VIS)


def test_feature_and_caption_readers_match_jax(tmp_path):
    """``load_features`` (.npz and the reference's .mat layout, one column
    per image, read through scipy) and ``load_captions_json``."""
    import json

    from scipy.io import savemat

    from icee_tpu.senticap import io as jio

    rng = np.random.default_rng(32)
    feats = rng.standard_normal((VIS, 3)).astype(np.float32)
    names = np.array(["a.jpg", "b.jpg", "c.jpg"], dtype=object)
    savemat(str(tmp_path / "f.mat"), {"feats": feats, "image_names": names})
    np.savez(str(tmp_path / "f.npz"), **{"a.jpg": feats[:, 0]})
    for name in ("f.mat", "f.npz"):
        got = sio.load_features(str(tmp_path / name))
        want = jio.load_features(str(tmp_path / name))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    recs = [{"image": "a.jpg", "tokens": ["a", "dog"]}]
    with open(tmp_path / "c.json", "w") as f:
        json.dump({"annotations": recs}, f)
    assert sio.load_captions_json(str(tmp_path / "c.json")) == recs
    assert jio.load_captions_json(str(tmp_path / "c.json")) == recs


def test_pickles_cross_between_the_packages(tmp_path):
    from icee_tpu.senticap import io as jio

    p = _params(31)
    conf = jconf(**SMALL)
    w2i = {".": 0, "a": 1}
    jio.save_model(str(tmp_path / "jax.pkl"), _j(p), conf, None, w2i)
    tp, tconf, state, tw2i = sio.load_model(str(tmp_path / "jax.pkl"),
                                            "cpu")
    assert tconf == conf and tw2i == w2i and state is None
    for k in p:
        np.testing.assert_array_equal(tp[k].numpy(), p[k])
    sio.save_model(str(tmp_path / "torch.pkl"), tp, tconf,
                   {"cache": {"w": torch.ones(2)}}, tw2i)
    with open(tmp_path / "torch.pkl", "rb") as f:
        blob = pickle.load(f)
    assert all(isinstance(a, np.ndarray) for a in blob["params"].values())
    assert isinstance(blob["solver_state"]["cache"]["w"], np.ndarray)
    jp, jc, _, jw2i = jio.load_model(str(tmp_path / "torch.pkl"))
    assert jc == conf and jw2i == w2i
    for k in p:
        np.testing.assert_array_equal(np.asarray(jp[k]), p[k])


# --- train -------------------------------------------------------------------

def _split(seed, n=12):
    from icee_tpu.senticap import io as jio

    recs, feats = _records(seed, n)
    w2i, _ = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    assert len(w2i) <= V
    return (sio.make_split(recs, feats, w2i, MAXLEN, VIS),
            jio.make_split(recs, feats, w2i, MAXLEN, VIS))


@pytest.mark.parametrize("semi,chunked", [(1.0, True), (1.0, False),
                                          (0.8, True), (0.8, False)])
def test_base_step_matches_jax(semi, chunked):
    """One RMSProp step of the base model on a gathered minibatch: JAX's
    jitted step (fused K8 in interpret mode at SEMI_FORCED 1.0) vs the
    port's, with JAX's dropout masks and forced matrix injected."""
    from icee_tpu.senticap import io as jio
    from icee_tpu.senticap.train import make_base_step as jmake_base_step
    from icee_tpu_torch.senticap.train import make_base_step

    kw = dict(SEMI_FORCED=semi, CHUNKED_CE=chunked, FUSED_SCAN=True,
              batch_size_val=B, **SMALL)
    ds, jds = _split(40)
    p = _params(41)
    idx = np.array([3, 0, 7, 1, 9, 4, 11, 2], np.int32)
    key = jax.random.PRNGKey(5)

    jc = jconf(**kw)
    jtx = jsolver.make_solver(jc)
    jp = _j(p)
    jp2, _, jloss = jmake_base_step(jc, jtx)(jp, jtx.init(jp),
                                             jio.device_dataset(jds),
                                             jnp.asarray(idx), key)
    # the step's own draws (senticap/train.py:_base_step_impl)
    kx, ky, kf = jax.random.split(key, 3)
    xd = jax.random.bernoulli(kx, 0.5, (B, T, E)).astype(jnp.float32) / 0.5
    yd = jax.random.bernoulli(ky, 0.5, (B, T, H)).astype(jnp.float32) / 0.5
    forced = (jax.random.bernoulli(kf, semi, (B, T)).astype(jnp.float32)
              if semi < 1.0 else None)

    conf = senticap_conf(**kw)
    tx = solver.make_solver(conf)
    tp = bridge.to_torch(p)
    step = make_base_step(conf, tx, device="cpu")
    assert step.use_chunked == chunked
    _, _, loss = step(tp, tx.init(tp), sio.device_dataset(ds, "cpu"),
                      _t(idx).long(), x_drop=_t(xd), y_drop=_t(yd),
                      forced=None if forced is None else _t(forced))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp2[k]),
                                   atol=1e-5, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), p[k]), k


def test_validation_perplexity_matches_jax():
    from icee_tpu.senticap.train import \
        validation_perplexity as jvalidation_perplexity
    from icee_tpu_torch.senticap.train import validation_perplexity

    ds, jds = _split(50)
    p = _params(51)
    for chunked in (True, False):
        want = jvalidation_perplexity(_j(p), jconf(CHUNKED_CE=chunked,
                                                   **SMALL), jds)
        got = validation_perplexity(bridge.to_torch(p), senticap_conf(
            CHUNKED_CE=chunked, **SMALL), ds, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5)
        # base_only: the background model inside a switched parameter set
        sw = dict(bridge.to_torch(p), **{f"{k}_sw": 2 * bridge.to_torch(p)[k]
                                         for k in p})
        assert validation_perplexity(
            sw, senticap_conf(CHUNKED_CE=chunked, **SMALL), ds,
            switched=True, base_only=True, device="cpu") == got


def test_train_base_learns_and_device_epoch_matches():
    """Two epochs of ``train_base`` on the CPU: the loss falls, and
    ``device_epoch`` (losses read back once per epoch) gives the same
    parameters; ``_epoch_indices`` rows equal JAX's."""
    from icee_tpu.senticap.train import _epoch_indices as j_epoch_indices
    from icee_tpu_torch.senticap.train import _epoch_indices, train_base

    assert np.array_equal(_epoch_indices(13, 4, np.random.default_rng(3)),
                          j_epoch_indices(13, 4, np.random.default_rng(3)))
    ds, _ = _split(60, n=16)
    conf = senticap_conf(batch_size_val=4, learning_rate=0.01, **SMALL)
    seen = []
    p1, _ = train_base(ds, V, conf, num_epochs=3, seed=1, device="cpu",
                       callbacks=[lambda e, p: seen.append(
                           validation_perplexity_cpu(p, conf, ds))])
    p2, _ = train_base(ds, V, conf, num_epochs=3, seed=1, device="cpu",
                       device_epoch=True)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    assert seen[-1] < seen[0]
    with pytest.raises(NotImplementedError, match="slice 8"):
        train_base(ds, V, conf, num_epochs=1, mesh=object(), device="cpu")


def validation_perplexity_cpu(p, conf, ds):
    from icee_tpu_torch.senticap.train import validation_perplexity

    return validation_perplexity(p, conf, ds, device="cpu")
