"""The port's trainers (``icee_tpu_torch/train/loops.py``) against the JAX
package's on the CPU: the same weights (moved with ``bridge.to_torch``), the
same caption files (``examples/data``) and seeded pooled features, loaders
with ``seed=0`` and ``prefetch=0`` in both packages, and JAX's randomness
injected into the port: the test's ``draws`` repeats the JAX trainer's key
chain (one split per training step, none on validation) and draws the
dropout keep-mask and the teacher-forcing coins as the JAX forward does.

The port runs its kernels' plain versions (``fused_scan`` and
``chunked_ce`` on: K3 / K4 / K5 and the chunked CE, as on the card); JAX
runs its XLA paths.  Held equal: BLEU-4, ``best_bleu4``, the plateau
counters, the checkpoint names written, the JSONL events' kinds and order,
and the per-validation sample captions.  Held close: the epoch losses
(rtol 1e-5), top-5 (1e-4: a mean of float32 percentages) and the learning
rate (rtol 1e-6: JAX keeps it in float32).

The final parameters are held per tree (decoder, encoder head): the 99th
percentile of |port - JAX| to ``PARAM_P99`` and every element to
``PARAM_ATOL``.  One factual step's update agrees to 1e-6
(``tests/test_torch_train_step.py``) except where a gradient element is
rounding noise: Adam's m / sqrt(v) scales any nonzero gradient to a step
of about lr, so the sign of the noise, which differs between the two
packages' float32 sums, moves that element by up to lr either way, and the
difference feeds every later step.  Such elements are few, apart from the
encoder head's ``linear_b``: its gradient is 0 in exact arithmetic (the
BatchNorm after it subtracts the batch mean), so every step of it is the
noise's sign times lr, and the BatchNorm's ``running_mean`` averages the
output of that bias; both are held to ``PARAM_ATOL`` alone.  Scheduled sampling adds one more source: the
argmax fed back as the next input can flip where two logits tie within
the packages' difference.  Over the 14 steps of two epochs at lr 5e-3 an
element can so drift by at most about 2 x lr a step (``PARAM_ATOL``); in
these runs 99% of each tree stays within 1e-3 (``PARAM_P99``).

Validation's BLEU comes from argmax predictions.  At these widths the
logits are nearly flat, so after an epoch's rounding differences a token
can flip where two logits tie within that difference.  Every flipped
prediction is judged by its margin: the JAX logit of JAX's token minus
that of the port's token, at the first position where a row's tokens
differ, must lie within the largest |port - JAX| logit difference of that
batch.  Where no token flipped, BLEU and everything chosen from it (the
best-BLEU checkpoints, the plateau counters) must be equal; BLEU itself
has no tolerance.  Where one flipped, the flipped token is the next
step's input in free-running validation, so the rest of that row's
predictions and losses change too: the validation loss is then held to
rtol 1e-3 and top-5 to one token of the 49 the smallest validation
corpus here scores, and BLEU is not compared.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from icee_tpu.core.config import AttentionDecoderConfig as JAttConfig
from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.core.config import EncoderConfig as JEncoderConfig
from icee_tpu.core.config import TrainConfig as JTrainConfig
from icee_tpu.data import captions as jcap
from icee_tpu.data import pipeline as jpipe
from icee_tpu.data.vocab import build_vocab as jbuild_vocab
from icee_tpu.models import attention as jatt
from icee_tpu.models import encoder as jenc
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.models import lstm as jnic
from icee_tpu.train import loops as jloops
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import AttentionDecoderConfig, DecoderConfig
from icee_tpu_torch.core.config import TrainConfig
from icee_tpu_torch.data import captions as cap
from icee_tpu_torch.data import pipeline as pipe
from icee_tpu_torch.data.vocab import build_vocab
from icee_tpu_torch.parallel.mesh import Mesh
from icee_tpu_torch.train import loops

TRAIN, HAPPY = "examples/data/train.txt", "examples/data/happy.txt"
E, H, FEAT, P, MAX_LEN, LR = 16, 24, 32, 4, 10, 5e-3
PARAM_P99 = 1e-3
PARAM_ATOL = 2 * LR * 14


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One CPU thread while this module runs: with more, a thread of the
    intra-op pool can compute a float32 exp up to ~1,800 ulps off in a few
    processes in a hundred (PERF.md section 7), and these tests compare
    float32 values across packages."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    vocab, jvocab = build_vocab(TRAIN, 1), jbuild_vocab(TRAIN, 1)
    rng = np.random.default_rng(42)
    names = sorted({n for n, _ in cap.parse_caption_file(TRAIN)})
    pooled = {n: rng.standard_normal((FEAT,)).astype(np.float32)
              for n in names}
    spatial = {n: rng.random((P, FEAT)).astype(np.float32) for n in names}
    return dict(
        vocab=vocab, jvocab=jvocab, pooled=pooled, spatial=spatial,
        ds=(cap.load_caption_dataset(TRAIN, vocab),
            jcap.load_caption_dataset(TRAIN, jvocab)),
        emo=(cap.load_caption_dataset(HAPPY, vocab),
             jcap.load_caption_dataset(HAPPY, jvocab)))


def _loaders(data, which, batch, spatial=False):
    """(port loader, JAX loader) over the same examples and features."""
    feats = data["spatial" if spatial else "pooled"]
    ds, jds = data[which]
    return (pipe.caption_dataset_loader(ds, batch, MAX_LEN, feats.__getitem__,
                                        seed=0, prefetch=0),
            jpipe.caption_dataset_loader(jds, batch, MAX_LEN,
                                         feats.__getitem__, seed=0,
                                         prefetch=0))


def _jax_draws(seed, dropout, ratio):
    """The JAX trainer's ``_next_rng`` chain and its forward's draws."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draws(b, t):
        state["key"], k = jax.random.split(state["key"])
        k_drop, k_tf = jax.random.split(k)
        keep = (np.asarray(jax.random.bernoulli(k_drop, 1.0 - dropout,
                                                (b, t, E)))
                if dropout > 0 else None)
        coins = (None if ratio >= 1.0 else
                 np.asarray(jax.random.bernoulli(k_tf, ratio, (t,))))
        return keep, coins

    return draws


def _configs(vocab, family, ratio, **tkw):
    dims = dict(vocab_size=len(vocab), embed_size=E, hidden_size=H,
                factored_size=H, feature_size=FEAT, dropout=0.5,
                max_seq_length=8)
    att = family.endswith("_att")
    tk = dict(mode="happy", lr_caption=LR, lr_language=LR,
              teacher_forcing_ratio=ratio, max_caption_len=MAX_LEN,
              log_step=1000, log_step_emotion=1000, **tkw)
    if att:
        return (JAttConfig(attention_size=16, **dims),
                AttentionDecoderConfig(attention_size=16, **dims),
                JTrainConfig(**tk),
                TrainConfig(fused_scan=True, chunked_ce=True, **tk))
    return (JDecoderConfig(**dims), DecoderConfig(**dims), JTrainConfig(**tk),
            TrainConfig(fused_scan=True, chunked_ce=True, **tk))


def _weights(jcfg, family):
    init = {"factored": jfl.init_params, "nic": jnic.init_params,
            "factored_att": jatt.init_factored_att_params,
            "nic_att": jatt.init_rnn_att_params}[family]
    dec = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    if family.endswith("_att"):
        return dec, None
    head = jenc.init_head_params(jax.random.PRNGKey(1),
                                 JEncoderConfig(embed_size=E,
                                                feature_size=FEAT))
    return dec, jax.tree.map(np.asarray, head)


def _recording(fn, out):
    def sample(*args):
        words = fn(*args)
        out.append(list(words))
        return words
    return sample


def _pair(data, tmp_path, family, ratio, cls=("MultitaskTrainer",), **tkw):
    """(port trainer, JAX trainer, port samples, JAX samples) from the same
    weights, each writing into its own directory under ``tmp_path``."""
    jcfg, cfg, jtcfg, tcfg = _configs(data["vocab"], family, ratio, **tkw)
    dec, head = _weights(jcfg, family)
    samples, jsamples = [], []
    out = []
    for side, klass, conf, tconf, vocab in (
            ("port", getattr(loops, cls[0]), cfg, tcfg, data["vocab"]),
            ("jax", getattr(jloops, cls[0]), jcfg, jtcfg, data["jvocab"])):
        kw = dict(family=family, model_dir=str(tmp_path / side),
                  data_name="toy",
                  metrics_path=str(tmp_path / f"{side}.jsonl"))
        if side == "port":
            kw.update(device="cpu", draws=_jax_draws(0, 0.5, ratio))
            tr = klass(conf, tconf, vocab, bridge.to_torch(dec),
                       None if head is None else bridge.to_torch(head), **kw)
        else:
            tr = klass(conf, tconf, vocab, dec, head, **kw)
        if tr.sample_fn is not None:
            tr.sample_fn = _recording(tr.sample_fn,
                                      samples if side == "port" else jsamples)
        out.append(tr)
    return out[0], out[1], samples, jsamples, (dec, head)


def _events(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("t")
    return recs


def _assert_events_match(got, want, val_exact=True):
    assert [r["event"] for r in got] == [r["event"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if k == "train_loss" or (k == "val_loss" and val_exact):
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)
            elif k == "val_loss":
                np.testing.assert_allclose(g[k], v, rtol=1e-3, err_msg=k)
            elif k == "top5":
                assert g[k] == pytest.approx(v, abs=1e-4 if val_exact
                                             else 100 / 49), k
            elif k == "lr":
                np.testing.assert_allclose(g[k], v, rtol=1e-6)
            elif k != "bleu4" or val_exact:
                assert g[k] == v, (k, g, w)


def _head_noise(head):
    """The head without ``linear_b`` and the BatchNorm's ``running_mean``
    (held to PARAM_ATOL alone, see the module docstring)."""
    bn = {k: v for k, v in head["bn"].items() if k != "running_mean"}
    return {"linear_w": head["linear_w"], "bn": bn}


def _assert_params_close(got, want, quantile=True):
    """Every element of the tree within PARAM_ATOL and, with ``quantile``,
    99% of them within PARAM_P99."""
    d = np.concatenate(jax.tree.leaves(jax.tree.map(
        lambda w, g: np.abs(bridge.to_numpy(g) - np.asarray(w)).ravel(),
        want, got)))
    assert d.max() <= PARAM_ATOL, d.max()
    if quantile:
        assert np.quantile(d, 0.99) <= PARAM_P99, (np.quantile(d, 0.99),
                                                   d.max())


def _assert_same_run(port, jt, samples, jsamples, tmp_path,
                     val_exact=True):
    """The two runs agree; ``val_exact`` False (a validation token flipped
    at a tie, see :func:`_flips`) leaves out what is chosen from BLEU and
    holds the free-running validation loss and top-5 as the module
    docstring says."""
    if val_exact:
        assert port.best_bleu4 == jt.best_bleu4
        assert port.epochs_since_improvement == jt.epochs_since_improvement
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))
    assert samples == jsamples
    _assert_events_match(_events(tmp_path / "port.jsonl"),
                         _events(tmp_path / "jax.jsonl"), val_exact)
    _assert_params_close(port.dec, jax.tree.map(np.asarray, jt.dec))
    if jt.head is not None:
        jhead = jax.tree.map(np.asarray, jt.head)
        _assert_params_close(port.head, jhead, quantile=False)
        _assert_params_close(_head_noise(port.head), _head_noise(jhead))


@pytest.mark.parametrize("ratio", [1.0, 0.8])
@pytest.mark.parametrize("family", ["factored", "nic"])
def test_multitask_two_epochs_match_jax(data, tmp_path, family, ratio):
    port, jt, samples, jsamples, _ = _pair(data, tmp_path, family, ratio)
    args = [_loaders(data, w, b) for w, b in (("ds", 4), ("ds", 4),
                                              ("emo", 3), ("emo", 3))]
    got = port.train(*[a[0] for a in args], num_epochs=2)
    want = jt.train(*[a[1] for a in args], num_epochs=2)
    assert got == want
    assert len(samples) == 4                 # one per validation
    assert sorted(os.listdir(tmp_path / "port"))[0].startswith("HAP")
    _assert_same_run(port, jt, samples, jsamples, tmp_path)


def test_plateau_events_match_jax(data, tmp_path):
    """lr_decay_patience 1 and early stop at 2: every epoch without a new
    best BLEU decays the rate; both packages stop at the same epoch."""
    port, jt, samples, jsamples, _ = _pair(
        data, tmp_path, "factored", 1.0, lr_decay_patience=1,
        early_stop_patience=2)
    args = [_loaders(data, w, b) for w, b in (("ds", 8), ("ds", 8),
                                              ("emo", 8), ("emo", 8))]
    port.train(*[a[0] for a in args], num_epochs=5)
    jt.train(*[a[1] for a in args], num_epochs=5)
    events = [r["event"] for r in _events(tmp_path / "port.jsonl")]
    assert "lr_decay" in events
    _assert_same_run(port, jt, samples, jsamples, tmp_path)


def _record_val(tr, out, logits_fn):
    """Record each validation batch's argmax predictions and free-running
    logits (recomputed with the same arguments)."""
    step = tr.val_step

    def val(*args):
        res = step(*args)
        out.append((np.asarray(res[2]), np.asarray(logits_fn(*args))))
        return res

    tr.val_step = val


def _flips(port_vals, jax_vals):
    """Count rows whose predictions differ; each first difference must be a
    tie within the batch's logit difference between the packages."""
    flips = 0
    assert len(port_vals) == len(jax_vals)
    for (pp, plog), (jp, jlog) in zip(port_vals, jax_vals):
        drift = np.abs(plog - jlog).max()
        for b in range(pp.shape[0]):
            diff = np.nonzero(pp[b] != jp[b])[0]
            if len(diff):
                t = diff[0]
                margin = jlog[b, t, jp[b, t]] - jlog[b, t, pp[b, t]]
                assert 0.0 <= margin <= drift, (b, t, margin, drift)
                flips += 1
    return flips


def test_stylenet_att_epoch_matches_jax(data, tmp_path):
    from icee_tpu_torch.models import attention as patt

    port, jt, samples, jsamples, _ = _pair(data, tmp_path, "factored_att",
                                           0.8)
    vals, jvals = [], []
    _record_val(port, vals, lambda d, f, c, ln, m, s: patt.factored_att_forward(
        d, port.cfg, c[:, :-1], f, int(s), teacher_forcing_ratio=0.0,
        train=False)[0])
    _record_val(jt, jvals, lambda d, f, c, ln, m, s: jatt.factored_att_forward(
        d, jt.cfg, c[:, :-1], f, s, teacher_forcing_ratio=0.0,
        train=False)[0])
    args = [_loaders(data, w, b, spatial=True)
            for w, b in (("ds", 8), ("ds", 8), ("emo", 8), ("emo", 8))]
    port.train(*[a[0] for a in args], num_epochs=1)
    jt.train(*[a[1] for a in args], num_epochs=1)
    assert samples == [] and port.sample_fn is None
    _assert_same_run(port, jt, samples, jsamples, tmp_path,
                     val_exact=_flips(vals, jvals) == 0)


@pytest.mark.parametrize("family", ["factored", "nic"])
def test_transfer_epoch_matches_jax(data, tmp_path, family):
    port, jt, samples, jsamples, (dec, _) = _pair(
        data, tmp_path, family, 1.0, cls=("TransferTrainer",))
    emo, val = _loaders(data, "emo", 3), _loaders(data, "emo", 3)
    got = port.train_transfer(emo[0], val[0], num_epochs=1)
    assert got == jt.train_transfer(emo[1], val[1], num_epochs=1)
    frozen = "B" if family == "factored" else "embed"
    np.testing.assert_array_equal(port.dec[frozen].numpy(), dec[frozen])
    assert not np.array_equal(port.dec["S_w" if family == "factored"
                                       else "cell"]["W_hh"]
                              if family == "nic" else port.dec["S_w"],
                              dec["cell"]["W_hh"] if family == "nic"
                              else dec["S_w"])
    _assert_same_run(port, jt, samples, jsamples, tmp_path)


def test_paper_regime_epoch_matches_jax(data, tmp_path):
    port, jt, samples, jsamples, (dec, _) = _pair(
        data, tmp_path, "factored", 1.0, cls=("PaperRegimeTrainer",))
    ids = [e.caption_ids for e in data["emo"][0]]
    fac = _loaders(data, "ds", 4)
    port.train(fac[0], {"happy": pipe.styled_caption_loader(
        ids, 3, MAX_LEN, seed=0, prefetch=0)}, num_epochs=1)
    jt.train(fac[1], {"happy": jpipe.styled_caption_loader(
        ids, 3, MAX_LEN, seed=0, prefetch=0)}, num_epochs=1)
    assert os.listdir(tmp_path / "port") == ["PAPER_checkpoint_toy"]
    # the happy optimizer's moments and the sad / angry slices: exactly 0
    # and exactly as initialized
    state = port.style_opt_states["happy"]
    names = list(port.dec)
    for name in ("S_w", "S_b"):
        i = names.index(name)
        for mom in (state.mu[i], state.nu[i]):
            assert mom[[0, 2, 3]].abs().max().item() == 0.0
            assert mom[1].abs().max().item() > 0.0
        np.testing.assert_array_equal(port.dec[name][2:].numpy(),
                                      dec[name][2:])
    assert all(state.mu[names.index(k)] is None for k in names
               if k not in ("S_w", "S_b"))
    _assert_same_run(port, jt, samples, jsamples, tmp_path)


def test_refusals_name_their_slice(data, tmp_path):
    jcfg, cfg, _, tcfg = _configs(data["vocab"], "factored", 1.0)
    dec, head = _weights(jcfg, "factored")
    args = (cfg, tcfg, data["vocab"], bridge.to_torch(dec),
            bridge.to_torch(head))
    kw = dict(device="cpu", model_dir=str(tmp_path))
    # a mesh whose data axis (3) the batch sizes do not divide: refused
    # with JAX's message before any collective
    mesh = Mesh((3, 1), 0, None, None, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="must divide by the data-axis "
                                         "size 3"):
        loops.MultitaskTrainer(*args, mesh=mesh, **kw)
    with pytest.raises(ValueError, match="family"):
        loops.MultitaskTrainer(*args, family="seq2seq", **kw)
    loops.PaperRegimeTrainer(*args, **kw)
    # the trainer trains its own copies: the caller's trees stay as given
    np.testing.assert_array_equal(args[3]["S_w"].numpy(), dec["S_w"])


@pytest.mark.parametrize("style", [1, 3])
def test_style_adam_matches_optax(style):
    """``optim.make_style_adam`` (the slice zeroing before the clamp, every
    other leaf frozen) against the JAX package's optax chain over three
    steps with a decay, to the tolerance of the plain Adam's test
    (``tests/test_torch_train_step.py``, 1e-6)."""
    import optax

    from icee_tpu.train import optim as joptim
    from icee_tpu_torch.train import optim

    rng = np.random.default_rng(style)
    params = {"B": rng.standard_normal((5, 3)).astype(np.float32),
              "S_w": rng.standard_normal((4, 2, 3, 3)).astype(np.float32),
              "S_b": rng.standard_normal((4, 2, 3)).astype(np.float32),
              "C_w": rng.standard_normal((3, 5)).astype(np.float32)}
    jtx = joptim.make_style_adam(2e-3, style, JTrainConfig())
    jstate, jp = jtx.init(params), params
    tx = optim.make_style_adam(2e-3, style, TrainConfig())
    tp = bridge.to_torch(params)
    state = tx.init(tp)
    for step in range(3):
        grads = {k: (rng.standard_normal(x.shape) * 0.6).astype(np.float32)
                 for k, x in params.items()}
        upd, jstate = jtx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(bridge.to_torch(grads), state, tp)
        if step == 1:
            assert joptim.decay_lr(jstate, 0.8) == pytest.approx(
                optim.decay_lr(state, 0.8), rel=1e-6)
        for k, w in jp.items():
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("B", "C_w"):
        np.testing.assert_array_equal(tp[k].numpy(), params[k])
        assert state.mu[list(params).index(k)] is None
    others = [s for s in range(4) if s != style]
    for k in ("S_w", "S_b"):
        i = list(params).index(k)
        np.testing.assert_array_equal(tp[k][others].numpy(),
                                      params[k][others])
        assert not state.mu[i][others].any() and not state.nu[i][others].any()
        assert state.mu[i][style].abs().min() > 0
