"""The port's data- and tensor-parallel training (``train/steps.py``,
``train/loops.py`` and ``senticap/train.py`` with ``mesh=``) on gloo worlds
of spawned ranks, against the JAX package's mesh steps and the port's own
single-process runs.

Two worlds run every rank program once (``parallel/programs.py::
several``, a file store under ``tmp_path``, one CPU thread a rank): four
ranks on a (2, 2) mesh (the StyleNet steps at DP x TP; the multitask,
transfer and paper-regime trainers) and two on (2, 1) (the NIC and
StyleNet+Att steps at DP 2; the seq2seq trainer; SentiCap base and switch
training).  JAX's steps run in this process on conftest's virtual devices
placed on the same mesh shapes (``icee_tpu/parallel/train.py``), with
``optax.identity()`` so they return params + grads; the dropout keep-masks
and coins are drawn from the step's key as the JAX forward draws them and
given to every rank for the global batch.

Tolerances: a step's loss rtol 1e-5 and its gradients within 1e-5 x the
tree's max |g| of JAX's (float32 sums in other orders: the global batch's
token count, the BatchNorm statistics, the split vocabulary's logsumexp);
the BatchNorm running statistics 1e-6.  Trained parameters: every rank's
equal rank 0's at atol 0; against the single-process port run within
``2 x lr x steps`` (Adam turns a rounding-sized gradient difference into a
step of about lr, ``tests/test_torch_trainer.py``); every step's loss,
and the logs' numbers, rtol 1e-5 and the logs' text equal.
"""

import functools
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icee_tpu.core.config import AttentionDecoderConfig as JAttConfig
from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.core.config import TrainConfig as JTrainConfig
from icee_tpu.parallel import mesh as jmesh
from icee_tpu.parallel import train as jtrain
from icee_tpu.train.steps import make_attention_steps as jmake_att
from icee_tpu.train.steps import make_caption_steps as jmake
from icee_tpu_torch import bridge
from icee_tpu_torch.checkpoint import ckpt
from icee_tpu_torch.core.config import (AttentionDecoderConfig,
                                        DecoderConfig, EncoderConfig,
                                        Seq2SeqConfig, TrainConfig)
from icee_tpu_torch.data import captions as cap
from icee_tpu_torch.data.vocab import build_vocab
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.models import encoder as enc_mod
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.models import seq2seq as s2s
from icee_tpu_torch.parallel import launch, programs

V, E, HD, B, T, FEAT, P = 32, 10, 16, 8, 6, 12, 5
RATIO, DROPOUT = 0.7, 0.5
TRAIN, HAPPY = "examples/data/train.txt", "examples/data/happy.txt"
LR, EPOCHS = 5e-3, 2
FAMILIES = {"factored": ((2, 2), 4), "nic": ((2, 1), 2),
            "factored_att": ((2, 1), 2)}
TRAINERS = ["multitask", "transfer", "paper"]
RESIDENT = "multitask:resident"    # pinned splits, a progress record a batch


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- one step of each family against JAX's mesh step ------------------------

@functools.lru_cache(maxsize=None)
def _step_case(family):
    """(JAX config, the steps' keys, port payload) of one step case: the
    port's seeded initial weights (as numpy), a global batch of B rows, the
    dropout keep-masks and coins JAX's steps draw from their keys."""
    att = family.endswith("_att")
    dims = dict(vocab_size=V, embed_size=E, hidden_size=HD,
                factored_size=HD, feature_size=FEAT, dropout=DROPOUT)
    gen = torch.Generator().manual_seed(0)
    if att:
        jcfg = JAttConfig(attention_size=8, **dims)
        cfg = AttentionDecoderConfig(attention_size=8, **dims)
        dec = att_mod.init_factored_att_params(gen, cfg)
        head = None
    else:
        jcfg, cfg = JDecoderConfig(**dims), DecoderConfig(**dims)
        dec = (fl if family == "factored" else nic).init_params(gen, cfg)
        head = bridge.to_numpy(enc_mod.init_head_params(
            torch.Generator().manual_seed(1),
            EncoderConfig(embed_size=E, feature_size=FEAT)))
    rng = np.random.default_rng(1)
    steps = T - 1 if att else T
    keys = [jax.random.PRNGKey(9), jax.random.PRNGKey(10)]
    draws = []
    for k in keys:
        k_drop, k_tf = jax.random.split(k)
        draws.append((np.asarray(jax.random.bernoulli(
            k_drop, 1.0 - DROPOUT, (B, steps, E))),
            np.asarray(jax.random.bernoulli(k_tf, RATIO, (steps,)))))
    feats = (rng.random((B, P, FEAT)) if att
             else rng.standard_normal((B, FEAT))).astype(np.float32)
    p = dict(family=family, cfg=cfg, head=head, dec=bridge.to_numpy(dec),
             tcfg=TrainConfig(teacher_forcing_ratio=RATIO, fused_scan=False,
                              chunked_ce=True),
             feats=feats, captions=rng.integers(0, V, (B, T)),
             lengths=np.array([6, 4, 2, 6, 0, 5, 3, 6]),
             sample_mask=np.array([True] * 6 + [False, True]), style=2,
             draws=draws)
    return jcfg, keys, p


def _jax_mesh_step(family, shape):
    """JAX's factual step (and for StyleNet its emotion step) on a
    ``shape`` mesh of virtual devices -> {track: (loss, decoder grads[,
    head grads])}, "bn"."""
    jcfg, keys, p = _step_case(family)
    mesh = jmesh.make_mesh(shape, devices=jax.devices()[:shape[0] *
                                                         shape[1]])
    ident = optax.identity()
    jt = JTrainConfig(teacher_forcing_ratio=RATIO, chunked_ce=True)
    att = family.endswith("_att")
    if att:
        fac, emo, _ = jmake_att(jcfg, jt, ident, ident, factored=True)
    else:
        fac, emo, _ = jmake(jcfg, jt, ident, ident, family == "factored")
    dec = jtrain.place_decoder(p["dec"], mesh)
    batch = jtrain.place_batch(mesh, *(jnp.asarray(p[k]) for k in (
        "feats", "captions", "lengths", "sample_mask")))
    sub = lambda a, b: np.asarray(a) - b  # noqa: E731
    out = {}
    if att:
        d1, _, loss = fac(dec, ident.init(None), *batch, keys[0])
        out["factual"] = (float(loss), jax.tree.map(sub, d1, p["dec"]))
        return out
    head = jtrain.place_replicated(p["head"], mesh)
    d1, h1, _, loss = fac(dec, head, ident.init(None), *batch, keys[0])
    part = lambda h: {k: h[k] for k in ("linear_w", "linear_b")}  # noqa
    out["factual"] = (float(loss), jax.tree.map(sub, d1, p["dec"]),
                      jax.tree.map(sub, part(h1), part(p["head"])))
    out["bn"] = jax.tree.map(np.asarray, h1["bn"])
    if family == "factored":
        d2, _, _, loss = emo(dec, head, ident.init(None), *batch,
                             jnp.asarray(2), keys[1])
        out["emotion"] = (float(loss), jax.tree.map(sub, d2, p["dec"]))
        out["text_style"] = _jax_text_style_step(jcfg, dec, batch[1:],
                                                 p["style"], keys[1])
    return out


def _jax_text_style_step(jcfg, dec, batch, style, key):
    """The loss and gradients of the JAX paper-regime trainer's text-only
    style step (``icee_tpu/train/loops.py`` ``PaperRegimeTrainer``: the
    decoder's forward without features, the masked token-mean CE) on the
    placed decoder and batch."""
    from icee_tpu.evaluation.metrics import masked_cross_entropy
    from icee_tpu.models import factored_lstm as jfl

    def loss_fn(d, captions, lengths, sample_mask):
        logits = jfl.forward(d, jcfg, captions, None, style, RATIO, key,
                             True)
        return masked_cross_entropy(logits, captions, lengths, sample_mask)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(dec, *batch)
    return float(loss), jax.tree.map(np.asarray, grads)


# --- the trainers -------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    vocab = build_vocab(TRAIN, 1)
    if len(vocab) % 2:
        vocab.add_word("<extra>")      # a vocabulary the model axis splits
    rng = np.random.default_rng(42)
    names = sorted({n for n, _ in cap.parse_caption_file(TRAIN)})
    emotion = cap.load_caption_dataset(HAPPY, vocab)
    return dict(vocab=vocab, features={
        n: rng.standard_normal((FEAT,)).astype(np.float32) for n in names},
        datasets={"train": cap.load_caption_dataset(TRAIN, vocab),
                  "emotion": emotion,
                  "styled": {"happy": [e.caption_ids for e in emotion]}})


def _trainer_case(corpus, kind, tmp, side):
    resident = kind == RESIDENT
    kind = kind.split(":")[0]
    dims = dict(vocab_size=len(corpus["vocab"]), embed_size=E,
                hidden_size=HD, factored_size=HD, feature_size=FEAT,
                dropout=DROPOUT, max_seq_length=8)
    tcfg = TrainConfig(mode="happy", lr_caption=LR, lr_language=LR,
                       teacher_forcing_ratio=0.8, max_caption_len=10,
                       log_step=1000, log_step_emotion=1000, fused_scan=True,
                       chunked_ce=True, caption_batch_size=8,
                       language_batch_size=4,
                       progress_chunk=1 if resident else 0)
    gen = torch.Generator().manual_seed(0)
    if kind == "seq2seq":
        cfg = Seq2SeqConfig(vocab_size=dims["vocab_size"], embed_size=E,
                            hidden_size=HD, num_layers=1, dropout=DROPOUT,
                            max_seq_length=8)
        dec = bridge.to_numpy(s2s.init_params(gen, cfg))
    else:
        cfg = DecoderConfig(**dims)
        dec = bridge.to_numpy(fl.init_params(gen, cfg))
    head = bridge.to_numpy(enc_mod.init_head_params(
        torch.Generator().manual_seed(1),
        EncoderConfig(embed_size=E, feature_size=FEAT)))
    name = f"{kind}{'_resident' if resident else ''}_{side}"
    (tmp / name).mkdir()
    return dict(corpus, kind=kind, family="factored", cfg=cfg, tcfg=tcfg,
                dec=dec, head=head, epochs=EPOCHS, model_dir=str(tmp / name),
                log_path=str(tmp / f"{name}.log"),
                metrics_path=str(tmp / f"{name}.jsonl"), resident=resident)


def _senticap_case():
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap.config import senticap_conf

    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(20)]
    recs = [{"image": f"img{i}", "tokens": list(rng.choice(words, 5)),
             "sentiment": 1.0, "switch": list(rng.integers(0, 2, 6))}
            for i in range(16)]
    feats = {r["image"]: rng.standard_normal(12).astype(np.float32)
             for r in recs}
    w2i, _ = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    conf = senticap_conf(emb_size=8, lstm_hidden_size=8, visual_size=12,
                         MAX_SENTENCE_LEN=6, batch_size_val=8,
                         learning_rate=0.01, CHUNKED_CE=True)
    ds = sio.make_split(recs, feats, w2i, 6, 12)
    return dict(ds=ds, sw_ds=ds, V=len(w2i), conf=conf, epochs=2)


@pytest.fixture(scope="module", autouse=True)
def _world_runs(tmp_path_factory, corpus):
    """The (2, 2) world and the (2, 1) world, each run once, started as
    the module starts and run in the background while JAX's steps
    compile."""
    tmp = tmp_path_factory.mktemp("parallel_train")
    four = {"step_grads:factored": _step_case("factored")[2]}
    for kind in TRAINERS:
        four[f"trainer:{kind}"] = _trainer_case(corpus, kind, tmp, "mesh")
    two = {"step_grads:nic": _step_case("nic")[2],
           "step_grads:factored_att": _step_case("factored_att")[2],
           "trainer:seq2seq": _trainer_case(corpus, "seq2seq", tmp, "mesh"),
           f"trainer:{RESIDENT}": _trainer_case(corpus, RESIDENT, tmp,
                                                "mesh"),
           "senticap": _senticap_case()}
    with ThreadPoolExecutor(2) as pool:      # the two worlds at once
        yield tmp, {n: pool.submit(launch.spawn, programs.several, n,
                                   payload, workdir=str(tmp / f"w{n}"),
                                   shape=shape)
                    for n, payload, shape in ((4, four, (2, 2)),
                                              (2, two, (2, 1)))}


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's mesh steps of every family (compiled while the worlds run)."""
    return {f: _jax_mesh_step(f, shape) for f, (shape, _) in FAMILIES.items()}


@pytest.fixture(scope="module")
def worlds(_world_runs, jax_steps):
    tmp, runs = _world_runs
    return {"tmp": tmp, **{n: run.result() for n, run in runs.items()}}


def _close_grads(got, want):
    """Every leaf within 1e-5 x the tree's max |g|."""
    want_l = [np.asarray(w) for w in jax.tree.leaves(want)]
    got_l = [np.asarray(g) for g in jax.tree.leaves(got)]
    assert len(got_l) == len(want_l)
    scale = max(np.abs(w).max() for w in want_l)
    for g, w in zip(got_l, want_l):
        assert np.abs(g - w).max() <= 1e-5 * scale, \
            np.abs(g - w).max() / scale


def _same_bits(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_steps_match_jax_mesh_steps(worlds, jax_steps, family):
    """Steps with dropout at ratio 0.7 against JAX's step on the same
    mesh shape: StyleNet's factual and emotion steps and the paper
    regime's text-only style step (``TextStyleStep``) at DP x TP (2, 2)
    (the vocabulary split over the model axis: B's rows, C_w's columns,
    the vocab-parallel embedding, argmax and CE), NIC's and StyleNet+Att's
    factual step at DP 2; every rank's results equal."""
    _, n = FAMILIES[family]
    got = worlds[n]
    key = f"step_grads:{family}"
    want = jax_steps[family]
    tracks = (("factual", "emotion", "text_style") if family == "factored"
              else ("factual",))
    for track in tracks:
        loss, grads = got[0][key][track][:2]
        np.testing.assert_allclose(loss, want[track][0], rtol=1e-5)
        _close_grads(grads, want[track][1])
    if family != "factored_att":
        head = got[0][key]["factual"][2]
        _close_grads({k: head[k] for k in ("linear_w", "linear_b")},
                     want["factual"][2])
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[0][key]["bn"][k], want["bn"][k],
                                       rtol=1e-6, atol=1e-6)
    for r in range(1, n):
        assert _same_bits(got[r][key], got[0][key])


def _single_run(case):
    """The same trainer in this process, without a mesh."""
    return programs.trainer(None, case)


def _log_numbers(path):
    with open(path) as f:
        text = re.sub(r"Batch Time: [\d.]+, ", "", f.read())
    return (re.sub(r"\d+\.\d+(e-?\d+)?", "#", text),
            [float(x) for x in re.findall(r"\d+\.\d+(?:e-?\d+)?", text)])


@pytest.mark.parametrize("kind", TRAINERS + ["seq2seq", RESIDENT])
def test_trainers_on_a_mesh_equal_one_process(worlds, corpus, kind):
    """Two epochs of the multitask, transfer and paper-regime trainers at
    DP x TP (2, 2), and at DP 2 of the seq2seq trainer and of the
    multitask trainer on pinned splits writing a progress record every
    batch (dropout 0.5, scheduled sampling at 0.8): every rank ends with
    rank 0's parameters bit for bit, the single-process run's within 2 x
    lr x steps; every training step's loss (the paper regime's text-only
    style steps included) is the same on every rank and the
    single-process run's within rtol 1e-5, and rank 0's log is the
    single-process log (numbers rtol 1e-5); the finished run leaves no
    progress record."""
    tmp = worlds["tmp"]
    n = 4 if kind in TRAINERS else 2
    got = [w[f"trainer:{kind}"] for w in worlds[n]]
    single = _single_run(_trainer_case(corpus, kind, tmp, "single"))
    for r in range(1, n):
        assert _same_bits(got[r]["dec"], got[0]["dec"])
        assert _same_bits(got[r]["head"], got[0]["head"])
    steps = EPOCHS * 8
    for a, b in zip(jax.tree.leaves(got[0]["dec"]),
                    jax.tree.leaves(single["dec"])):
        assert np.abs(a - b).max() <= 2 * LR * steps
    for r in range(1, n):
        np.testing.assert_array_equal(got[r]["losses"], got[0]["losses"])
    assert len(got[0]["losses"]) == len(single["losses"]) > 0
    np.testing.assert_allclose(got[0]["losses"], single["losses"],
                               rtol=1e-5)
    if kind == "paper":
        return                         # the paper regime logs nothing
    name = kind.replace(":", "_")
    if kind == RESIDENT:
        assert os.listdir(tmp / f"{name}_mesh") == ["HAP_checkpoint_demo"]
    text, nums = _log_numbers(tmp / f"{name}_mesh.log")
    want_text, want_nums = _log_numbers(tmp / f"{name}_single.log")
    assert text == want_text
    np.testing.assert_allclose(nums, want_nums, rtol=1e-5)


def test_multitask_checkpoint_is_rank_0s_whole_params(worlds):
    """Rank 0 alone wrote the (2, 2) run's checkpoint, in the
    single-process format, from the gathered parameters: the serving
    engine's loader (``ckpt.load_params``) reads the whole vocabulary
    back, equal to the trainer's final parameters; each rank held half of
    B's rows and C_w's columns."""
    d = worlds["tmp"] / "multitask_mesh"
    path = str(d / "HAP_checkpoint_demo")
    assert sorted(p.name for p in d.iterdir()) == ["HAP_checkpoint_demo"]
    assert ckpt.is_port_checkpoint(path)
    params = ckpt.load_params(path)
    got = worlds[4][0]["trainer:multitask"]
    for k, v in got["dec"].items():
        np.testing.assert_array_equal(params["decoder"][k].numpy(), v)
    np.testing.assert_array_equal(params["head"]["linear_w"].numpy(),
                                  got["head"]["linear_w"])
    v = got["dec"]["C_b"].shape[0]
    assert got["slices"]["C_w"].shape == (HD, v // 2)
    assert got["slices"]["B"].shape == (v // 2, E)


def test_senticap_base_and_switch_training_data_parallel(worlds):
    """SentiCap base then switch training, two epochs each at DP 2 (the
    masked-SUM loss's gradients summed over the ranks, the L2 and
    similarity terms divided by the data axis): both ranks end with the
    same parameters, the single-process run's within 1e-4."""
    from icee_tpu_torch.senticap.train import train_base, train_switched

    case = _senticap_case()
    base, _ = train_base(case["ds"], case["V"], case["conf"], num_epochs=2,
                         seed=1, device="cpu")
    sw, _ = train_switched(case["sw_ds"], base, case["V"], case["conf"],
                           num_epochs=2, seed=1, device="cpu")
    got = [w["senticap"] for w in worlds[2]]
    assert _same_bits(got[1], got[0])
    for name, want in (("base", base), ("switched", sw)):
        for k, v in want.items():
            np.testing.assert_allclose(got[0][name][k], v.numpy(),
                                       atol=1e-4, err_msg=f"{name}.{k}")
