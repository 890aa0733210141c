"""Seq2seq style transfer in the port (``models/seq2seq.py``,
``train/steps.py::make_seq2seq_steps``, ``train/loops.py::Seq2SeqTrainer``,
``checkpoint/torch_import.py::import_seq2seq_state_dict``) against the JAX
package's, on the CPU at a tiny width (V from ``examples/data`` or 40, E 8,
H 16, 1 and 2 layers), JAX's weights moved across with
:mod:`icee_tpu_torch.bridge` and JAX's draws injected: the dropout
keep-mask and the teacher-forcing coins come from the key ``_scheduled_rnn``
splits (the emotion pass's from the second half of its step key's split).

Tolerances: float32 on both sides, sums in other orders, one CPU thread.
Logits, hidden states and states atol 1e-5; argmax ids equal; losses rtol
1e-5; gradients atol 1e-5.  After Adam steps on the stacked decoders 99.9%
of the elements within 1e-5 and every one within 2 x lr a step (a
near-zero gradient element's step is ±lr by the sign of its rounding
noise).  The trainer's
logged losses rtol 1e-5, the final parameters as ``test_torch_trainer.py``
holds them: every element within 2 x lr a step, 99% within 1e-3, but the
encoder head's ``linear_b`` and BatchNorm ``running_mean`` to the first
bound alone (Adam turns the zero-in-exact-arithmetic gradient of
``linear_b`` into a step of ±lr whose sign is rounding noise, and the
running mean averages that bias's output).  The pinned
epochs equal the port's host-loader epochs at atol 0.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icee_tpu.core.config import EncoderConfig as JEncoderConfig
from icee_tpu.core.config import Seq2SeqConfig as JSeq2SeqConfig
from icee_tpu.core.config import TrainConfig as JTrainConfig
from icee_tpu.models import encoder as jenc
from icee_tpu.models import seq2seq as js2s
from icee_tpu.train import optim as joptim
from icee_tpu.train.steps import make_seq2seq_steps as jmake
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import Seq2SeqConfig, TrainConfig
from icee_tpu_torch.models import seq2seq as s2s
from icee_tpu_torch.train import optim
from icee_tpu_torch.train.steps import make_seq2seq_steps

V, E, H, B, T, FEAT, DROP = 40, 8, 16, 6, 7, 12, 0.22
LR = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One CPU thread: float32 values are compared across packages (see
    ``tests/test_torch_trainer.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(layers=1, vocab=V, max_len=6):
    kw = dict(vocab_size=vocab, embed_size=E, hidden_size=H,
              num_layers=layers, dropout=DROP, max_seq_length=max_len,
              feature_size=FEAT)
    return JSeq2SeqConfig(**kw), Seq2SeqConfig(**kw)


def _weights(jcfg, seed=0):
    params = jax.tree.map(np.asarray, js2s.init_params(
        jax.random.PRNGKey(seed), jcfg))
    head = jax.tree.map(np.asarray, jenc.init_head_params(
        jax.random.PRNGKey(seed + 1), JEncoderConfig(embed_size=E,
                                                     feature_size=FEAT)))
    return params, head


def _draws(key, b, t, ratio, emotion=False):
    """The (keep, coins) ``_scheduled_rnn`` draws from a step's key."""
    if emotion:
        key = jax.random.split(key)[1]
    k_drop, k_tf = jax.random.split(key)
    keep = np.asarray(jax.random.bernoulli(k_drop, 1.0 - DROP, (b, t, E)))
    coins = (None if ratio >= 1.0 else
             np.asarray(jax.random.bernoulli(k_tf, ratio, (t,))))
    return keep, coins


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, V, (B, T)).astype(np.int64)
    lens = np.array([7, 5, 2, 7, 0, 4])
    smask = np.array([True, True, True, True, False, True])
    feats = rng.standard_normal((B, E)).astype(np.float32)
    pooled = rng.standard_normal((B, FEAT)).astype(np.float32)
    return caps, lens, smask, feats, pooled


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(bridge.to_numpy(got) if torch.is_tensor(got)
                               else got, np.asarray(want), atol=atol)


def _tree_close(got, want, atol=1e-5):
    for g, w in zip(jax.tree.leaves(bridge.to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g, w, atol=atol)


@pytest.mark.parametrize("layers", [1, 2])
def test_model_matches_jax(layers):
    """``init_params``' tree, ``select_decoder``, ``encode`` (logits and
    hiddens, the final state), ``decode_emotion``, ``forward`` and
    ``greedy_sample`` (factual and an emotion) vs JAX, at ratio 0.5 with
    JAX's draws and at ratio 0 in eval mode."""
    jcfg, cfg = _cfgs(layers)
    p, _ = _weights(jcfg)
    tp = bridge.to_torch(p)
    port_tree = s2s.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.structure(jax.tree.map(np.shape, p)) == \
        jax.tree.structure(jax.tree.map(np.shape, bridge.to_numpy(
            port_tree)))
    assert jax.tree.map(np.shape, p) == jax.tree.map(
        np.shape, bridge.to_numpy(port_tree))
    assert len(tp["decoders"]["lstm"]) == layers
    for eid in range(3):
        _tree_close(s2s.select_decoder(tp, eid),
                    js2s.select_decoder(p, jnp.asarray(eid)), atol=0)
    caps, _, _, feats, _ = _batch()
    key = jax.random.PRNGKey(9)
    keep, coins = _draws(key, B, T, 0.5)
    for hid in (False, True):
        out, (h, c) = js2s.encode(p, jcfg, feats, caps, 0.5, key, True,
                                  return_hiddens=hid)
        tout, (th, tc) = s2s.encode(tp, cfg, torch.tensor(feats),
                                    torch.tensor(caps), 0.5, None, True,
                                    hid, torch.tensor(keep), coins)
        _close(tout, out)
        _close(th, h)
        _close(tc, c)
    # the emotion decoder on dst[:, :-1], emotion 1, and the ratio-0 eval
    dkeep, dcoins = _draws(key, B, T - 1, 0.5)
    for hid in (False, True):
        want = js2s.decode_emotion(p, jcfg, None, caps[:, :-1], 1, 0.5, key,
                                   True, return_hiddens=hid)
        got = s2s.decode_emotion(tp, cfg, None, torch.tensor(caps[:, :-1]),
                                 1, 0.5, None, True, hid,
                                 torch.tensor(dkeep), dcoins)
        _close(got, want)
    src = (caps, np.full((B,), T))
    tsrc = (torch.tensor(caps), torch.full((B,), T))
    tdst = (torch.tensor(caps[:, :-1]), torch.full((B,), T - 1))
    for emotion in (None, 2):
        want = js2s.forward(p, jcfg, feats, src,
                            (caps[:, :-1], np.full((B,), T - 1)), emotion,
                            0.0, key, False)
        got = s2s.forward(tp, cfg, torch.tensor(feats), tsrc, tdst, emotion,
                          0.0, None, False)
        _close(got, want)
        want = js2s.greedy_sample(p, jcfg, feats, 1, emotion)
        got = s2s.greedy_sample(tp, cfg, torch.tensor(feats), 1, emotion)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert got.shape == (B, cfg.max_seq_length)


def test_emotion_decoder_ignores_the_encoder_state():
    """Reference quirk (``seq2seq/model.py:168-176``): ``decode_emotion``
    trains from zeros whatever state it is given.  A decoder that read the
    state would fail here: the output with the encoder's state must equal
    the output without it, and differ from a loop started from that
    state."""
    jcfg, cfg = _cfgs(2)
    tp = bridge.to_torch(_weights(jcfg)[0])
    caps, _, _, feats, _ = _batch()
    caps_t = torch.tensor(caps)
    _, state = s2s.encode(tp, cfg, torch.tensor(feats), caps_t, 1.0, None,
                          False)
    with_state = s2s.decode_emotion(tp, cfg, state, caps_t, 0, 1.0, None,
                                    False)
    without = s2s.decode_emotion(tp, cfg, None, caps_t, 0, 1.0, None, False)
    assert torch.equal(with_state, without)
    threaded, _ = s2s._scheduled_rnn(s2s.select_decoder(tp, 0), cfg, caps_t,
                                     None, state, 1.0, None, False)
    assert not torch.allclose(threaded, without, atol=1e-3)


def test_greedy_sample_threads_the_encoder_rollout_state():
    """Reference quirk (``seq2seq/model.py:285-301``): the emotion
    decoder's greedy rollout starts from the encoder rollout's final state.
    A sample that started the decoder from zeros would fail here."""
    jcfg, cfg = _cfgs(1)
    tp = bridge.to_torch(_weights(jcfg)[0])
    feats = torch.tensor(_batch()[3])
    half = s2s.select_decoder(tp, 2)

    def rollout(state):
        h, c = state
        x = half["embed"][torch.full((B,), 1)]
        ids = []
        for _ in range(cfg.max_seq_length):
            top, h, c = s2s.multilayer_lstm_cell(half["lstm"], x, h, c)
            ids.append(torch.argmax(top @ half["linear_w"]
                                    + half["linear_b"], -1))
            x = half["embed"][ids[-1]]
        return torch.stack(ids, 1)

    enc = tp["encoder"]
    h = c = torch.zeros((1, B, H))
    x = feats
    for _ in range(cfg.max_seq_length):
        top, h, c = s2s.multilayer_lstm_cell(enc["lstm"], x, h, c)
        x = enc["embed"][torch.argmax(top @ enc["linear_w"]
                                      + enc["linear_b"], -1)]
    got = s2s.greedy_sample(tp, cfg, feats, 1, 2)
    assert torch.equal(got, rollout((h, c)))
    zeros = torch.zeros((1, B, H))
    assert not torch.equal(got, rollout((zeros, zeros)))


def _assert_adam_close(got, want, steps):
    """After ``steps`` Adam steps: every element within 2 x lr a step (a
    near-zero gradient element's step is ±lr by the sign of its rounding
    noise), 99.9% within 1e-5."""
    d = np.concatenate([np.abs(g - np.asarray(w)).ravel() for g, w in zip(
        jax.tree.leaves(bridge.to_numpy(got)), jax.tree.leaves(want))])
    assert d.max() <= 2 * LR * steps and np.quantile(d, 0.999) <= 1e-5


def _jsteps(jcfg, jtcfg, tx, etx):
    return jmake(jcfg, jtcfg, tx, etx)


@pytest.mark.parametrize("ratio,chunked", [(1.0, True), (0.5, False)])
def test_steps_match_jax(ratio, chunked):
    """One factual and one emotion step (emotion 1) with JAX's steps run
    under ``optax.identity()`` (the update is the gradient), teacher-forced
    with the chunked CE and scheduled with the materialized CE (the
    scheduled chunked path: the trainer and masked-Adam tests): the loss, the
    pre-optimizer gradients (the emotion's other slices exactly 0), the
    head's BatchNorm statistics; then both validation steps."""
    jcfg, cfg = _cfgs(2)
    p, head = _weights(jcfg)
    jt = JTrainConfig(teacher_forcing_ratio=ratio, chunked_ce=chunked)
    ident = optax.identity()
    jfac, jemo, jvf, jve = _jsteps(jcfg, jt, ident, ident)
    caps, lens, smask, _, pooled = _batch()
    key = jax.random.PRNGKey(4)
    jp2, jh2, _, jloss = jfac(p, head, ident.init((p["encoder"], head)),
                              pooled, caps, lens, smask, key)
    steps = make_seq2seq_steps(cfg, TrainConfig(teacher_forcing_ratio=ratio,
                                                chunked_ce=chunked),
                               None, None, device="cpu")
    assert steps.use_chunked == chunked
    tp, th = bridge.to_torch(p), bridge.to_torch(head)
    targs = (torch.tensor(pooled), torch.tensor(caps), torch.tensor(lens),
             torch.tensor(smask))
    keep, coins = _draws(key, B, T, ratio)
    loss, (g_enc, g_head), new_head = steps.factual_grads(
        tp, th, *targs, keep=torch.tensor(keep), coins=coins)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want_enc = jax.tree.map(lambda a, b: np.asarray(a) - b, jp2["encoder"],
                            p["encoder"])
    _tree_close(g_enc, want_enc)
    _tree_close(g_head["linear_w"], np.asarray(jh2["linear_w"])
                - head["linear_w"])
    for k in ("running_mean", "running_var"):
        _close(new_head["bn"][k], jh2["bn"][k], atol=1e-6)
    # the emotion step: dst = src, emotion 1
    jp3, _, jloss = jemo(p, head, ident.init(p["decoders"]), pooled, caps,
                         lens, caps, lens, smask, 1, key)
    keep, coins = _draws(key, B, T - 1, ratio, emotion=True)
    loss, g_dec = steps.emotion_grads(tp, targs[1], targs[2], targs[3], 1,
                                      keep=torch.tensor(keep), coins=coins)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want_dec = jax.tree.map(lambda a, b: np.asarray(a) - b, jp3["decoders"],
                            p["decoders"])
    _tree_close(g_dec, want_dec)
    for g in jax.tree.leaves(bridge.to_numpy(g_dec)):
        assert not g[0].any() and not g[2].any() and g[1].any()
    # validation: free-running from step 0, eval-mode head
    for jfn, fn, extra in ((jvf, steps.val_factual_step, ()),
                           (jve, steps.val_emotion_step, (2,))):
        if extra:
            want = jfn(p, head, pooled, caps, lens, caps, lens, smask, 2)
            got = fn(tp, th, targs[0], targs[1], targs[2], targs[1],
                     targs[2], targs[3], 2)
        else:
            want = jfn(p, head, pooled, caps, lens, smask)
            got = fn(tp, th, *targs)
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
        np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-4)
        assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_one_masked_adam_over_the_stacked_decoders():
    """The hazard of JAX's ONE Adam over the stacked decoders with masked
    gradients (``icee_tpu/train/steps.py:385-392``): three emotion steps
    (emotions 0, 1, 1) with the real optimizers, chunked CE on.  After
    emotion 1's steps emotion 0's slice has still moved (its moments
    decay, m_hat / sqrt(v_hat) stays finite), emotion 2's never has, in
    both packages alike."""
    chunked = True
    jcfg, cfg = _cfgs(1)
    p, head = _weights(jcfg)
    jt = JTrainConfig(teacher_forcing_ratio=0.5, chunked_ce=chunked,
                      lr_language=LR)
    tcfg = TrainConfig(teacher_forcing_ratio=0.5, chunked_ce=chunked,
                       lr_language=LR)
    jtx = joptim.make_adam(LR, jt)
    _, jemo, _, _ = _jsteps(jcfg, jt, jtx, jtx)
    tx = optim.make_adam(LR, tcfg)
    steps = make_seq2seq_steps(cfg, tcfg, tx, tx, device="cpu")
    caps, lens, smask, _, pooled = _batch()
    tp = bridge.to_torch(p)
    jstate, state = jtx.init(p["decoders"]), tx.init(tp["decoders"])
    jp = p
    before = {}
    for i, eid in enumerate((0, 1, 1)):
        key = jax.random.PRNGKey(20 + i)
        jp, jstate, jloss = jemo(jp, head, jstate, pooled, caps, lens, caps,
                                 lens, smask, eid, key)
        keep, coins = _draws(key, B, T - 1, 0.5, emotion=True)
        before = {k: v.clone() for k, v in tp["decoders"].items()
                  if torch.is_tensor(v)}
        tp, state, loss = steps.emotion_train_step(
            tp, None, state, None, None, None, torch.tensor(caps),
            torch.tensor(lens), torch.tensor(smask), eid,
            keep=torch.tensor(keep), coins=coins)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _assert_adam_close(tp["decoders"], jp["decoders"], i + 1)
        if i == 2:   # emotion 1's second step still moves emotion 0
            moved = tp["decoders"]["linear_w"][0] - before["linear_w"][0]
            assert moved.abs().max() > 0.1 * LR
    assert np.array_equal(bridge.to_numpy(tp["decoders"]["linear_w"][2]),
                          p["decoders"]["linear_w"][2])


def test_steps_refuse_another_device():
    jcfg, cfg = _cfgs(1)
    steps = make_seq2seq_steps(cfg, TrainConfig(), None, None, device="cpu")
    p = bridge.to_torch(_weights(jcfg)[0])
    p["decoders"]["linear_b"] = p["decoders"]["linear_b"].to("meta")
    caps, lens, smask, _, _ = _batch()
    with pytest.raises(ValueError, match="given a tensor on meta"):
        steps.emotion_grads(p, torch.tensor(caps), torch.tensor(lens),
                            torch.tensor(smask), 0)


def test_bridge_carries_the_seq2seq_tree_both_ways():
    jcfg, _ = _cfgs(2)
    p, _ = _weights(jcfg)
    back = bridge.to_numpy(bridge.to_torch(p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("layers", [1, 2])
def test_import_seq2seq_state_dict_matches_jax(layers):
    """A reference-shaped ``Seq2Seq`` state dict (torch tensors, ``nn.LSTM``
    per-layer names) imports to JAX's tree, bit for bit."""
    from icee_tpu.checkpoint.torch_import import \
        import_seq2seq_state_dict as jimport
    from icee_tpu_torch.checkpoint.torch_import import \
        import_seq2seq_state_dict

    rng = np.random.default_rng(5)
    sd = {}
    for half in ("encoder", "decoder_happy", "decoder_sad", "decoder_angry"):
        sd[f"{half}.embed.weight"] = rng.standard_normal((V, E))
        for n in range(layers):
            width = E if n == 0 else H
            sd[f"{half}.lstm.weight_ih_l{n}"] = rng.standard_normal(
                (4 * H, width))
            sd[f"{half}.lstm.weight_hh_l{n}"] = rng.standard_normal(
                (4 * H, H))
            sd[f"{half}.lstm.bias_ih_l{n}"] = rng.standard_normal(4 * H)
            sd[f"{half}.lstm.bias_hh_l{n}"] = rng.standard_normal(4 * H)
        sd[f"{half}.linear.weight"] = rng.standard_normal((V, H))
        sd[f"{half}.linear.bias"] = rng.standard_normal(V)
    sd = {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
    got = import_seq2seq_state_dict(sd)
    want = jimport(sd)
    assert jax.tree.structure(bridge.to_numpy(got)) == \
        jax.tree.structure(jax.tree.map(np.asarray, want))
    _tree_close(got, want, atol=0)
    assert got["decoders"]["lstm"][0]["W_ih"].shape == (3, E, 4 * H)
    assert all(t.is_contiguous() for t in
               jax.tree.leaves(got, is_leaf=torch.is_tensor))
    with pytest.raises(KeyError, match="decoder_happy"):
        import_seq2seq_state_dict({k: v for k, v in sd.items()
                                   if not k.startswith("decoder_happy.lstm")})


# --- the trainer ---------------------------------------------------------

TRAIN, HAPPY = "examples/data/train.txt", "examples/data/happy.txt"
MAX_LEN = 10


@pytest.fixture(scope="module")
def corpus():
    from icee_tpu.data import captions as jcap
    from icee_tpu.data.vocab import build_vocab as jbuild_vocab
    from icee_tpu_torch.data import captions as cap
    from icee_tpu_torch.data.vocab import build_vocab

    vocab, jvocab = build_vocab(TRAIN, 1), jbuild_vocab(TRAIN, 1)
    rng = np.random.default_rng(42)
    names = sorted({n for n, _ in cap.parse_caption_file(TRAIN)})
    pooled = {n: rng.standard_normal((FEAT,)).astype(np.float32)
              for n in names}
    return dict(vocab=vocab, jvocab=jvocab, pooled=pooled,
                ds=(cap.load_caption_dataset(TRAIN, vocab),
                    jcap.load_caption_dataset(TRAIN, jvocab)),
                emo=(cap.load_caption_dataset(HAPPY, vocab),
                     jcap.load_caption_dataset(HAPPY, jvocab)))


def _loaders(corpus, which, batch, shuffle=True):
    from icee_tpu.data import pipeline as jpipe
    from icee_tpu_torch.data import pipeline as pipe

    ds, jds = corpus[which]
    f = corpus["pooled"].__getitem__
    return (pipe.caption_dataset_loader(ds, batch, MAX_LEN, f, shuffle=shuffle,
                                        seed=0, prefetch=0),
            jpipe.caption_dataset_loader(jds, batch, MAX_LEN, f,
                                         shuffle=shuffle, seed=0, prefetch=0))


def _pinned(corpus, which, batch, shuffle=True):
    from icee_tpu_torch.data import device as ddev

    return ddev.from_examples(corpus[which][0], batch, MAX_LEN,
                              corpus["pooled"].__getitem__, shuffle=shuffle,
                              seed=0, device="cpu")


def _trainer_draws(seed, ratio):
    """The JAX trainer's ``_next_rng`` chain (one split a training step,
    none on validation) and its steps' draws."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draws(b, t, track):
        state["key"], k = jax.random.split(state["key"])
        return _draws(k, b, t, ratio, emotion=track == "emotion")

    return draws


def _configs(corpus, ratio):
    jcfg, cfg = _cfgs(1, vocab=len(corpus["vocab"]), max_len=8)
    tk = dict(lr_caption=LR, lr_language=LR, teacher_forcing_ratio=ratio,
              max_caption_len=MAX_LEN, chunked_ce=True)
    return jcfg, cfg, JTrainConfig(**tk), TrainConfig(**tk)


def _log_numbers(path):
    with open(path) as f:
        text = f.read()
    return (re.sub(r"\d+\.\d+", "#", text),
            [float(x) for x in re.findall(r"\d+\.\d+", text)])


def _diffs(got, want):
    return np.concatenate([np.abs(g - np.asarray(w)).ravel() for g, w in zip(
        jax.tree.leaves(bridge.to_numpy(got)), jax.tree.leaves(want))])


def _assert_trained_close(tr, jtr, steps):
    """The port trainer's parameters and head against JAX's after
    ``steps`` Adam steps: every element within 2 x lr a step, 99% within
    1e-3, but the head's ``linear_b`` and BatchNorm ``running_mean``
    (rounding noise times lr, see the module docstring) to the first
    bound alone."""
    noise = ("linear_b", "running_mean")
    head = {k: v for k, v in tr.head.items() if k != "linear_b"}
    head["bn"] = {k: v for k, v in tr.head["bn"].items() if k not in noise}
    jhead = {k: v for k, v in jtr.head.items() if k != "linear_b"}
    jhead["bn"] = {k: v for k, v in jtr.head["bn"].items() if k not in noise}
    for got, want in ((tr.params, jtr.params), (head, jhead)):
        d = _diffs(got, want)
        assert d.max() <= 2 * LR * steps and np.quantile(d, 0.99) <= 1e-3
    d = _diffs([tr.head["linear_b"], tr.head["bn"]["running_mean"]],
               [jtr.head["linear_b"], jtr.head["bn"]["running_mean"]])
    assert d.max() <= 2 * LR * steps


def _port_trainer(corpus, cfg, tcfg, p, head, log, ratio):
    from icee_tpu_torch.train.loops import Seq2SeqTrainer

    return Seq2SeqTrainer(cfg, tcfg, corpus["vocab"], bridge.to_torch(p),
                          bridge.to_torch(head), log_path=log, device="cpu",
                          draws=_trainer_draws(0, ratio))


def test_trainer_host_epochs_match_jax(corpus, tmp_path):
    """Two epochs of ``Seq2SeqTrainer.train`` from the host loader at ratio
    0.8, factual pass and the happy pass with both validations, in both
    packages: the same log lines, their numbers rtol 1e-5, and the final
    parameters close (see the module docstring).  (Ratio 1.0 through the
    CLI: ``tests/test_torch_cli.py::test_seq2seq_train_matches_jax_and_
    device_resident_equals_host``.)"""
    from icee_tpu.train.loops import Seq2SeqTrainer as JTrainer

    ratio = 0.8
    jcfg, cfg, jt, tcfg = _configs(corpus, ratio)
    p, head = _weights(jcfg)
    logs = {}
    for side in ("port", "jax"):
        fac, jfac = _loaders(corpus, "ds", 6)
        emo, jemo = _loaders(corpus, "emo", 5)
        vfac, jvfac = _loaders(corpus, "ds", 6, shuffle=False)
        vemo, jvemo = _loaders(corpus, "emo", 5, shuffle=False)
        logs[side] = str(tmp_path / f"{side}.log")
        if side == "port":
            tr = _port_trainer(corpus, cfg, tcfg, p, head, logs[side], ratio)
            tr.train(fac, {"happy": emo}, 2, vfac, {"happy": vemo})
        else:
            jtr = JTrainer(jcfg, jt, corpus["jvocab"], p, head,
                           log_path=logs[side])
            jtr.train(jfac, {"happy": jemo}, 2, jvfac, {"happy": jvemo})
    text, nums = _log_numbers(logs["port"])
    jtext, jnums = _log_numbers(logs["jax"])
    assert text == jtext and text.count("Epoch") == 4
    np.testing.assert_allclose(nums, jnums, rtol=1e-5)
    _assert_trained_close(tr, jtr, 2 * (3 + 2))


def test_pinned_epochs_equal_the_host_loader_and_jax(corpus, tmp_path):
    """Pinned splits (``data/device.py::from_examples``) train and validate
    to the port's host-loader run at atol 0 (parameters, both Adam states,
    the log), and close to JAX's device epoch over its own pinned splits."""
    from icee_tpu.data import device as jdev
    from icee_tpu.train.loops import Seq2SeqTrainer as JTrainer

    jcfg, cfg, jt, tcfg = _configs(corpus, 0.8)
    p, head = _weights(jcfg)
    runs = {}
    for tier in ("host", "pinned"):
        log = str(tmp_path / f"{tier}.log")
        tr = _port_trainer(corpus, cfg, tcfg, p, head, log, 0.8)
        if tier == "host":
            fac, emo = _loaders(corpus, "ds", 6)[0], \
                _loaders(corpus, "emo", 5)[0]
            vfac = _loaders(corpus, "ds", 6, False)[0]
            vemo = _loaders(corpus, "emo", 5, False)[0]
        else:
            fac, emo = _pinned(corpus, "ds", 6), _pinned(corpus, "emo", 5)
            vfac = _pinned(corpus, "ds", 6, False)
            vemo = _pinned(corpus, "emo", 5, False)
        tr.train(fac, {"happy": emo}, 2, vfac, {"happy": vemo})
        with open(log) as f:
            runs[tier] = (tr, f.read())
    (host, host_log), (pinned, pinned_log) = runs["host"], runs["pinned"]
    assert host_log == pinned_log
    for a, b in ((host.params, pinned.params), (host.head, pinned.head),
                 (host.opt_state.mu, pinned.opt_state.mu),
                 (host.opt_state.nu, pinned.opt_state.nu),
                 (host.emotion_opt_state.mu, pinned.emotion_opt_state.mu),
                 (host.emotion_opt_state.nu, pinned.emotion_opt_state.nu)):
        for x, y in zip(jax.tree.leaves(bridge.to_numpy(a)),
                        jax.tree.leaves(bridge.to_numpy(b))):
            assert np.array_equal(x, y)
    # JAX's whole-epoch scans over its pinned splits
    f = corpus["pooled"].__getitem__
    jds, jemo = corpus["ds"][1], corpus["emo"][1]
    jlog = str(tmp_path / "jax.log")
    jtr = JTrainer(jcfg, jt, corpus["jvocab"], p, head, log_path=jlog)
    jtr.train(jdev.from_examples(jds, 6, MAX_LEN, f, seed=0),
              {"happy": jdev.from_examples(jemo, 5, MAX_LEN, f, seed=0)}, 2,
              jdev.from_examples(jds, 6, MAX_LEN, f, shuffle=False),
              {"happy": jdev.from_examples(jemo, 5, MAX_LEN, f,
                                           shuffle=False)})
    text, nums = _log_numbers(str(tmp_path / "pinned.log"))
    jtext, jnums = _log_numbers(jlog)
    assert text == jtext
    np.testing.assert_allclose(nums, jnums, rtol=1e-5)
    _assert_trained_close(pinned, jtr, 10)


def test_trainer_refuses_a_mesh_and_a_streamed_split(corpus):
    from icee_tpu_torch.data import device as ddev
    from icee_tpu_torch.train.loops import Seq2SeqTrainer

    jcfg, cfg, _, tcfg = _configs(corpus, 1.0)
    p, head = _weights(jcfg)
    from icee_tpu_torch.parallel.mesh import Mesh

    # a mesh whose data axis the batch sizes do not divide: refused with
    # JAX's message before any collective
    mesh = Mesh((7, 1), 0, None, None, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="must divide by the data-axis "
                                         "size 7"):
        Seq2SeqTrainer(cfg, tcfg, corpus["vocab"], bridge.to_torch(p),
                       bridge.to_torch(head), mesh=mesh, device="cpu")
    tr = Seq2SeqTrainer(cfg, tcfg, corpus["vocab"], bridge.to_torch(p),
                        bridge.to_torch(head), device="cpu")
    streamed = ddev.from_examples_streamed(
        corpus["ds"][0], 6, MAX_LEN, corpus["pooled"].__getitem__,
        budget_bytes=6 * FEAT * 4, device="cpu")
    with pytest.raises(ValueError, match="streamed"):
        tr.train(streamed, {}, 1)
