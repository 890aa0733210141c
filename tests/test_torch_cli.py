"""The port's CLIs (``icee_tpu_torch/cli``) against the JAX package's on the
CPU, run in process on ``examples/data`` at the demo's widths (E = 32,
H = F = 48, 12 steps): the port's through ``main(parser().parse_args(argv))``
with ``--device cpu``, JAX's through ``runpy`` with ``sys.argv`` set.

Both CLIs draw their initial weights from their own generators, which
cannot agree, so the port's ``cli.train.init_weights`` is replaced by JAX's
initial weights (``bridge.to_torch``); the CLIs gain no flag for it.  The
run trains at dropout 0 and, through both packages' ``train_config``,
teacher-forcing ratio 1.0 (no flag sets it), so that no random draw enters
the losses.  The port trains with ``--fused_scan on --chunked_ce on``: the
kernels' plain versions, as on the card.  Held: the epoch losses (rtol
1e-5), BLEU-4, top-5 (1e-4), the JSONL events' kinds and order, and the
checkpoint names.

The decode CLIs then read the JAX run's final weights in both packages:
written as reference torch state dicts, each package's ``export`` CLI turns
them into its own checkpoint (their params equal), and ``evaluate`` (both
semantics), ``caption_batch`` (both semantics, the last batch padded) and
``sample`` read them with the same feature cache.  Their printed captions
and BLEU-1..4 are held equal, without tolerance; ``validate``'s loss to
rtol 1e-5, its top-5 and BLEU-4 lines equal.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import runpy
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from icee_tpu.checkpoint.ckpt import load_params as jload_params
from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.core.config import EncoderConfig as JEncoderConfig
from icee_tpu.models import encoder as jenc
from icee_tpu.models import factored_lstm as jfl
from icee_tpu_torch import bridge
from icee_tpu_torch.cli import (build_vocab, caption_batch, common, evaluate,
                                export, inspect_ckpt, sample, train,
                                validate)
from icee_tpu_torch.data.vocab import load_vocab

DATA = "examples/data"
E, H, MAX_SEQ = 32, 48, 12
MODEL = ["--embed_size", str(E), "--hidden_size", str(H), "--factored_size",
         str(H), "--max_seq_length", str(MAX_SEQ)]
GATES = ("i", "f", "o", "c")
STYLES = ("f", "happy_", "sad_", "angry_")


def run_jax(module: str, argv, monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", [module, *argv])
    runpy.run_module(module, run_name="__main__")


def run_port(mod, argv) -> None:
    mod.main(mod.parser().parse_args(argv))


def ratio_one(monkeypatch, mod):
    """``mod.train_config`` with teacher-forcing ratio 1.0."""
    make = mod.train_config
    monkeypatch.setattr(mod, "train_config", lambda args: dataclasses.replace(
        make(args), teacher_forcing_ratio=1.0))


def decoder_state_dict(dec):
    """A numpy FactoredLSTM tree -> the reference ``DecoderFactoredLSTM``
    state dict (the inverse of both packages' importers)."""
    f, h = dec["U_w"].shape[1], dec["W_w"].shape[0]
    sd = {"B.weight": dec["B"], "C.weight": dec["C_w"].T,
          "C.bias": dec["C_b"]}
    for g, name in enumerate(GATES):
        sd[f"V_{name}.weight"] = dec["V_w"][:, g * f:(g + 1) * f].T
        sd[f"V_{name}.bias"] = dec["V_b"][g]
        sd[f"U_{name}.weight"] = dec["U_w"][g].T
        sd[f"U_{name}.bias"] = dec["U_b"][g]
        sd[f"W_{name}.weight"] = dec["W_w"][:, g * h:(g + 1) * h].T
        sd[f"W_{name}.bias"] = dec["W_b"][g]
        for s, sp in enumerate(STYLES):
            sd[f"S_{sp}{name}.weight"] = dec["S_w"][s, g].T
            sd[f"S_{sp}{name}.bias"] = dec["S_b"][s, g]
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def head_state_dict(head):
    sd = {"linear.weight": head["linear_w"].T, "linear.bias": head["linear_b"]}
    sd.update({f"bn.{k}": v for k, v in head["bn"].items()})
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def events(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("t")
    return recs


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One CPU thread, as ``tests/test_torch_trainer.py`` (a pool thread
    can compute a float32 exp off by many ulps in a few processes in a
    hundred, and these tests compare float32 losses across packages)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """build_vocab, then ``train`` 2 epochs in both packages from JAX's
    initial weights; the JAX run's final weights exported by both
    packages' ``export``; a feature cache of every image."""
    tmp = tmp_path_factory.mktemp("cli")
    out = {"tmp": tmp}
    with pytest.MonkeyPatch.context() as mp:
        vocab_argv = ["--caption_path", f"{DATA}/train.txt", "--threshold",
                      "1"]
        run_port(build_vocab, vocab_argv + ["--vocab_path",
                                            str(tmp / "vocab.pkl")])
        run_jax("icee_tpu.cli.build_vocab",
                vocab_argv + ["--vocab_path", str(tmp / "jvocab.pkl")], mp)
        vocab = load_vocab(str(tmp / "vocab.pkl"))
        jcfg = JDecoderConfig(vocab_size=len(vocab), embed_size=E,
                              hidden_size=H, factored_size=H,
                              max_seq_length=MAX_SEQ)
        jdec = jax.tree.map(np.asarray, jfl.init_params(
            jax.random.PRNGKey(0), jcfg))
        jhead = jax.tree.map(np.asarray, jenc.init_head_params(
            jax.random.PRNGKey(1), JEncoderConfig(embed_size=E)))
        mp.setattr(train, "init_weights",
                   lambda family, cfg, ecfg, seed, device: (
                       bridge.to_torch(jdec, device),
                       bridge.to_torch(jhead, device)))
        from icee_tpu.cli import common as jcommon

        ratio_one(mp, jcommon)
        ratio_one(mp, common)
        paths = ["--caption_path", f"{DATA}/train.txt", "--val_caption_path",
                 f"{DATA}/train.txt"]
        for key in ("happy", "sad", "angry"):
            paths += [f"--{key}_path", f"{DATA}/happy.txt",
                      f"--val_{key}_path", f"{DATA}/happy.txt"]
        for side in ("port", "jax"):
            argv = ["--trainer", "multitask", "--family", "stylenet",
                    "--mode", "happy", "--vocab_path", str(tmp / "vocab.pkl"),
                    *paths, *MODEL, "--dropout", "0.0", "--num_epochs", "2",
                    "--caption_batch_size", "8", "--language_batch_size",
                    "4", "--lr_caption", "5e-3", "--lr_language", "5e-3",
                    "--model_path", str(tmp / side),
                    "--log_path", str(tmp / f"{side}.log"),
                    "--metrics_path", str(tmp / f"{side}.jsonl"),
                    "--data_name", "demo"]
            if side == "port":
                run_port(train, argv + ["--device", "cpu", "--fused_scan",
                                        "on", "--chunked_ce", "on"])
            else:
                run_jax("icee_tpu.cli.train", argv, mp)

    # the JAX run's final weights as reference state dicts, exported by both
    jparams = jax.tree.map(np.asarray, jload_params(
        str(tmp / "jax" / "HAP_checkpoint_demo")))
    dec_pth, enc_pth = str(tmp / "decoder.pth"), str(tmp / "encoder.pth")
    torch.save(decoder_state_dict(jparams["decoder"]), dec_pth)
    torch.save(head_state_dict(jparams["head"]), enc_pth)
    with pytest.MonkeyPatch.context() as mp:
        argv = ["--decoder_path", dec_pth, "--encoder_path", enc_pth,
                "--vocab_path", str(tmp / "vocab.pkl"), "--data_name",
                "demo", "--mode", "happy", "--epoch", "1", "--best", *MODEL]
        run_port(export, argv + ["--out_dir", str(tmp / "port_export"),
                                 "--device", "cpu"])
        run_jax("icee_tpu.cli.export",
                argv + ["--out_dir", str(tmp / "jax_export")], mp)
    out["jparams"] = jparams
    out["ckpt"] = {"port": str(tmp / "port_export" / "HAP_checkpoint_demo"),
                   "jax": str(tmp / "jax_export" / "HAP_checkpoint_demo")}
    out["pth"] = (dec_pth, enc_pth)
    names = sorted(os.listdir(f"{DATA}/img"))
    feats = {}
    for n in names:
        rng = np.random.default_rng(zlib.crc32(n.encode()) & 0xFFFFFFFF)
        feats[n] = rng.standard_normal((2048,)).astype(np.float32)
    np.savez(tmp / "features.npz", **feats)
    out["cache"] = str(tmp / "features.npz")
    return out


def test_build_vocab_pickles_load_in_both_packages(run):
    from icee_tpu.data.vocab import load_vocab as jload_vocab

    tmp = run["tmp"]
    port, jax_made = str(tmp / "vocab.pkl"), str(tmp / "jvocab.pkl")
    want = jload_vocab(jax_made).word2idx
    for path in (port, jax_made):
        assert load_vocab(path).word2idx == want
        assert jload_vocab(path).word2idx == want
    assert len(want) > 4


def test_train_matches_jax(run):
    tmp = run["tmp"]
    got, want = events(tmp / "port.jsonl"), events(tmp / "jax.jsonl")
    assert [r["event"] for r in got] == [r["event"] for r in want] == [
        "epoch_factual", "epoch_emotion"] * 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            if k in ("train_loss", "val_loss"):
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)
            elif k == "top5":
                assert g[k] == pytest.approx(v, abs=1e-4)
            elif k == "lr":
                np.testing.assert_allclose(g[k], v, rtol=1e-6)
            else:
                assert g[k] == v, (k, g, w)
    # two epochs on 16 captions leave BLEU-4 at 0 in both: no BEST copy
    assert sorted(os.listdir(tmp / "port")) == sorted(
        os.listdir(tmp / "jax")) == ["HAP_checkpoint_demo"]


def test_export_gives_both_packages_the_same_params(run):
    from icee_tpu_torch.checkpoint.ckpt import load_checkpoint, load_params

    got = bridge.to_numpy(load_params(run["ckpt"]["port"]))
    want = jax.tree.map(np.asarray, jload_params(run["ckpt"]["jax"]))
    for tree in ("decoder", "head"):
        jax.tree.map(np.testing.assert_array_equal, got[tree], want[tree])
        jax.tree.map(np.testing.assert_array_equal, got[tree],
                     run["jparams"][tree])
    state = load_checkpoint(run["ckpt"]["port"])
    assert state["epoch"] == 1
    assert state["best_bleu4"] == {"factual": 0.0, "emotion": 0.0}
    assert state["opt_states"]["optimizer"]["count"] == 0
    best = os.path.join(os.path.dirname(run["ckpt"]["port"]),
                        "HAP_BEST_checkpoint_demo")
    assert os.path.isdir(best)


def test_inspect_ckpt_prints_each_leaf(run, capsys):
    run_port(inspect_ckpt, ["--checkpoint_path", run["ckpt"]["port"],
                            "--vocab_path", str(run["tmp"] / "vocab.pkl"),
                            "--device", "cpu", *MODEL])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["param", "loaded", "fresh", "init", "same?"]
    dec = run["jparams"]["decoder"]
    assert [ln.split()[0] for ln in lines[1:]] == sorted(dec)
    for ln in lines[1:]:
        name = ln.split()[0]
        assert inspect_ckpt._summ(dec[name]) in ln
        assert ln.endswith("False")


def _decode_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("ref ", "pred", "BLEU-"))]


@pytest.mark.parametrize("semantics", [[], ["--feed_feature"]])
def test_evaluate_matches_jax(run, capsys, monkeypatch, semantics):
    argv = ["--mode", "happy", "--test_path", f"{DATA}/train.txt",
            "--vocab_path", str(run["tmp"] / "vocab.pkl"), "--feature_cache",
            run["cache"], "--batch_size", "6", *semantics, *MODEL]
    run_jax("icee_tpu.cli.evaluate",
            argv + ["--checkpoint_path", run["ckpt"]["jax"]], monkeypatch)
    want = _decode_lines(capsys.readouterr().out)
    run_port(evaluate, argv + ["--checkpoint_path", run["ckpt"]["port"],
                               "--device", "cpu"])
    got = _decode_lines(capsys.readouterr().out)
    assert len(want) == 2 * 16 + 4
    assert got == want
    preds = {ln for ln in want if ln.startswith("pred")}
    if semantics:     # serving: the captions differ between images
        assert len(preds) > 1
    else:             # research: the image is never fed, one caption
        assert len(preds) == 1


@pytest.mark.parametrize("semantics", [[], ["--research_semantics"]])
def test_caption_batch_matches_jax(run, monkeypatch, semantics):
    tmp = run["tmp"]
    argv = ["--vocab_path", str(tmp / "vocab.pkl"), "--feature_cache",
            run["cache"], "--image_dir", f"{DATA}/img", "--batch_size", "3",
            "--mode", "happy", *semantics, *MODEL]
    run_jax("icee_tpu.cli.caption_batch",
            argv + ["--checkpoint_path", run["ckpt"]["jax"], "--out",
                    str(tmp / "jax_captions.json")], monkeypatch)
    run_port(caption_batch, argv + ["--checkpoint_path", run["ckpt"]["port"],
                                    "--out", str(tmp / "port_captions.json"),
                                    "--device", "cpu"])
    with open(tmp / "jax_captions.json") as f:
        want = json.load(f)
    with open(tmp / "port_captions.json") as f:
        got = json.load(f)
    assert sorted(want) == sorted(os.listdir(f"{DATA}/img"))
    assert got == want


def test_sample_matches_jax(run, capsys, monkeypatch):
    dec_pth, enc_pth = run["pth"]
    argv = ["--image", f"{DATA}/img/i3.jpg", "--vocab_path",
            str(run["tmp"] / "vocab.pkl"), "--mode", "happy",
            "--decoder_path", dec_pth, "--encoder_path", enc_pth,
            "--feature_cache", run["cache"], *MODEL]
    run_jax("icee_tpu.cli.sample", argv, monkeypatch)
    want = capsys.readouterr().out.splitlines()[-1]
    run_port(sample, argv + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == want
    # a port checkpoint directory reads the same weights
    run_port(sample, argv[:6] + ["--decoder_path", run["ckpt"]["port"],
                                 "--encoder_path", run["ckpt"]["port"],
                                 *argv[10:], "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == want


def test_validate_matches_jax(run, capsys, monkeypatch):
    """The loss through each package's ``perplexity`` (printed to 4
    places, so read where it is passed) to rtol 1e-5; the top-5 and BLEU-4
    fields as printed."""
    from icee_tpu.evaluation import metrics as jmetrics
    from icee_tpu_torch.evaluation import metrics

    losses = []
    for mod in (jmetrics, metrics):
        ppl = mod.perplexity
        monkeypatch.setattr(mod, "perplexity",
                            lambda x, _p=ppl: losses.append(x) or _p(x))
    argv = ["--mode", "happy", "--caption_path", f"{DATA}/train.txt",
            "--vocab_path", str(run["tmp"] / "vocab.pkl"), "--feature_cache",
            run["cache"], "--batch_size", "6", *MODEL]
    run_jax("icee_tpu.cli.validate",
            argv + ["--checkpoint_path", run["ckpt"]["jax"]], monkeypatch)
    want = capsys.readouterr().out.splitlines()[-1]
    run_port(validate, argv + ["--checkpoint_path", run["ckpt"]["port"],
                               "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()[-1]
    assert len(losses) == 2                  # one call in each package
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    fields = re.compile(r"Top-5 (\S+) \| BLEU-4 (\S+)$")
    assert fields.search(got).groups() == fields.search(want).groups()


def test_load_state_dict_reads_state_dicts_and_module_pickles(tmp_path):
    """A state-dict pickle, and a whole module pickled whose class is gone
    (the reference's full checkpoints): the same names and values."""
    import types

    import torch.nn as nn

    from icee_tpu_torch.checkpoint.torch_pickle import load_state_dict

    mod = types.ModuleType("gone_model")

    class EncoderCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.linear = nn.Linear(3, 2)
            self.bn = nn.BatchNorm1d(2)

    EncoderCNN.__module__ = "gone_model"
    EncoderCNN.__qualname__ = "EncoderCNN"
    mod.EncoderCNN = EncoderCNN
    sys.modules["gone_model"] = mod
    try:
        enc = EncoderCNN()
        torch.save(enc, tmp_path / "full.pth")
        torch.save(enc.state_dict(), tmp_path / "sd.pth")
    finally:
        del sys.modules["gone_model"]
    want = enc.state_dict()
    for name in ("full.pth", "sd.pth"):
        got = load_state_dict(str(tmp_path / name))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)


def test_random_backbone_and_bfloat16_convs():
    """No ``--resnet_weights``: the seeded random init, the same each
    call; ``bfloat16`` casts the conv kernels only."""
    a = common.load_resnet_params(None)
    b = common.load_resnet_params(None, "bfloat16")
    assert a["conv1"].dtype == torch.float32
    assert b["conv1"].dtype == torch.bfloat16
    assert b["bn1"]["weight"].dtype == torch.float32
    assert b["layer3"][5]["conv2"].dtype == torch.bfloat16
    assert torch.equal(b["conv1"], a["conv1"].bfloat16())


TRAIN_BASE = ["--vocab_path", "unused.pkl", "--device", "cpu"]


@pytest.mark.parametrize("extra,slice_", [
    (["--data_parallel", "--coordinator_address", "localhost:1234"],
     "--coordinator_address needs --num_processes and --process_id"),
    (["--tensor_parallel", "2"], "--tensor_parallel need --data_parallel"),
    (["--coordinator_address", "localhost:1234"],
     "--coordinator_address need --data_parallel"),
    (["--num_processes", "2", "--process_id", "0"],
     "--num_processes, --process_id need --data_parallel"),
])
def test_train_refuses_what_is_not_ported(extra, slice_):
    """The multi-process flags that cannot act are refused at start-up,
    before the vocabulary loads: the model axis and the multi-host flags
    without ``--data_parallel`` (the JAX CLI ignores them there), and a
    coordinator without the process count and id."""
    with pytest.raises(SystemExit, match=slice_):
        run_port(train, TRAIN_BASE + extra)


def train_argv(tmp, side, epochs=2, extra=()):
    """The ``run`` fixture's multitask arguments over the feature cache."""
    paths = ["--caption_path", f"{DATA}/train.txt", "--val_caption_path",
             f"{DATA}/train.txt"]
    for key in ("happy", "sad", "angry"):
        paths += [f"--{key}_path", f"{DATA}/happy.txt",
                  f"--val_{key}_path", f"{DATA}/happy.txt"]
    return ["--trainer", "multitask", "--family", "stylenet", "--mode",
            "happy", "--vocab_path", str(tmp / "vocab.pkl"), *paths, *MODEL,
            "--dropout", "0.0", "--num_epochs", str(epochs),
            "--caption_batch_size", "8", "--language_batch_size", "3",
            "--lr_caption", "5e-3", "--lr_language", "5e-3",
            "--model_path", str(tmp / side), "--log_path",
            str(tmp / f"{side}.log"), "--metrics_path",
            str(tmp / f"{side}.jsonl"), "--data_name", "demo",
            "--feature_cache", str(tmp / "features.npz"), *extra]


PORT_FLAGS = ["--device", "cpu", "--fused_scan", "on", "--chunked_ce", "on"]


@pytest.fixture(scope="module")
def resident(run):
    """``train`` over the feature cache from JAX's initial weights: the
    port on the host loader, the port with ``--device_resident``, and the
    JAX CLI with ``--device_resident``."""
    tmp = run["tmp"]
    vocab = load_vocab(str(tmp / "vocab.pkl"))
    jdec = jax.tree.map(np.asarray, jfl.init_params(
        jax.random.PRNGKey(0), JDecoderConfig(
            vocab_size=len(vocab), embed_size=E, hidden_size=H,
            factored_size=H, max_seq_length=MAX_SEQ)))
    jhead = jax.tree.map(np.asarray, jenc.init_head_params(
        jax.random.PRNGKey(1), JEncoderConfig(embed_size=E)))
    weights = (jdec, jhead)
    with pytest.MonkeyPatch.context() as mp:
        from icee_tpu.cli import common as jcommon

        mp.setattr(train, "init_weights", lambda family, cfg, ecfg, seed,
                   device: tuple(bridge.to_torch(w, device)
                                 for w in weights))
        ratio_one(mp, jcommon)
        ratio_one(mp, common)
        run_port(train, train_argv(tmp, "r_host") + PORT_FLAGS)
        run_port(train, train_argv(tmp, "r_dev", extra=[
            "--device_resident"]) + PORT_FLAGS)
        run_jax("icee_tpu.cli.train", train_argv(tmp, "r_jax", extra=[
            "--device_resident"]), mp)
    return {"tmp": tmp, "weights": weights}


def _final_params(tmp, side):
    from icee_tpu_torch.checkpoint.ckpt import load_params

    return load_params(str(tmp / side / "HAP_checkpoint_demo"))


def _trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _trees_equal(a[k], b[k])
    else:
        assert torch.equal(a, b)


def test_device_resident_train_equals_the_host_loader_and_matches_jax(
        resident):
    """``--device_resident`` (the split pinned, every batch gathered on the
    device) ends in the host-loader run's checkpoint at atol 0 with the
    same events, and matches the JAX CLI's ``--device_resident`` run at
    ``test_train_matches_jax``'s tolerances."""
    tmp = resident["tmp"]
    _trees_equal(_final_params(tmp, "r_dev"), _final_params(tmp, "r_host"))
    assert events(tmp / "r_dev.jsonl") == events(tmp / "r_host.jsonl")
    got, want = events(tmp / "r_dev.jsonl"), events(tmp / "r_jax.jsonl")
    assert [r["event"] for r in got] == [r["event"] for r in want] == [
        "epoch_factual", "epoch_emotion"] * 2
    for g, w in zip(got, want):
        for k, v in w.items():
            if k in ("train_loss", "val_loss"):
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)
            elif k == "top5":
                assert g[k] == pytest.approx(v, abs=1e-4)
            elif k == "lr":
                np.testing.assert_allclose(g[k], v, rtol=1e-6)
            else:
                assert g[k] == v, (k, g, w)
    assert sorted(os.listdir(tmp / "r_dev")) == sorted(
        os.listdir(tmp / "r_jax"))


@pytest.fixture(scope="module")
def seq2seq_runs(run):
    """``train --trainer seq2seq`` over the feature cache from JAX's initial
    weights (``s2s.init_params(PRNGKey(seed))``, the head from ``seed +
    1``), dropout 0 and ratio 1.0: the JAX CLI, the port on the host
    loader, with ``--device_resident`` (pinned), and with a feature budget
    below the split's (the WARNING fallback to the host loader)."""
    from icee_tpu.core.config import Seq2SeqConfig as JSeq2SeqConfig
    from icee_tpu.models import seq2seq as js2s

    tmp = run["tmp"]
    vocab = load_vocab(str(tmp / "vocab.pkl"))
    jparams = jax.tree.map(np.asarray, js2s.init_params(
        jax.random.PRNGKey(0), JSeq2SeqConfig(
            vocab_size=len(vocab), embed_size=E, hidden_size=H,
            dropout=0.0, max_seq_length=MAX_SEQ)))
    jhead = jax.tree.map(np.asarray, jenc.init_head_params(
        jax.random.PRNGKey(1), JEncoderConfig(embed_size=E)))
    seen = []

    def init_weights(family, cfg, ecfg, seed, device):
        seen.append((family, cfg))
        return bridge.to_torch(jparams, device), bridge.to_torch(jhead,
                                                                 device)

    def argv(side, extra=()):
        a = train_argv(tmp, side, extra=extra)
        a[a.index("multitask")] = "seq2seq"
        return a

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        from icee_tpu.cli import common as jcommon

        mp.setattr(train, "init_weights", init_weights)
        ratio_one(mp, jcommon)
        ratio_one(mp, common)
        run_jax("icee_tpu.cli.train", argv("s_jax"), mp)
        for side, extra in (("s_host", []), ("s_dev", ["--device_resident"]),
                            ("s_over", ["--device_resident",
                                        "--device_budget_gb", "1e-9"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run_port(train, argv(side, extra) + PORT_FLAGS)
            out[side] = buf.getvalue()
    assert [f for f, _ in seen] == ["seq2seq"] * 3
    assert seen[0][1].dropout == 0.0 and seen[0][1].hidden_size == H
    return {"tmp": tmp, "stdout": out}


def test_seq2seq_train_matches_jax_and_device_resident_equals_host(
        seq2seq_runs):
    """The port's ``--trainer seq2seq`` log (factual and three emotion
    passes, both validations, 2 epochs) has the JAX CLI's lines, its
    numbers rtol 1e-5 (top-5 a percentage: atol 1e-3); ``--device_resident``
    (pinned) writes the host-loader run's log exactly, and over the budget
    the CLI says so and takes the host loader, as JAX's does."""
    tmp = seq2seq_runs["tmp"]

    def log(side):
        with open(tmp / f"{side}.log") as f:
            return f.read()

    host, jlog = log("s_host"), log("s_jax")
    num = r"-?\d+\.\d+"
    assert re.sub(num, "#", host) == re.sub(num, "#", jlog)
    assert host.count("Epoch [") == 2 * 4 and host.count("Val Loss") == 8
    got = [float(x) for x in re.findall(num, host)]
    want = [float(x) for x in re.findall(num, jlog)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert log("s_dev") == host
    assert log("s_over") == host
    warn = "features exceed the device-resident budget; falling back to " \
        "the host loader"
    assert warn in seq2seq_runs["stdout"]["s_over"]
    assert warn not in seq2seq_runs["stdout"]["s_dev"]


def test_device_resident_needs_constant_features(run, monkeypatch):
    """Without ``--no_augment`` or ``--feature_cache`` both CLIs exit
    before training: augmentation would be frozen at its first draw."""
    argv = train_argv(run["tmp"], "r_refused", extra=["--device_resident"])
    argv = argv[:argv.index("--feature_cache")]
    argv += ["--device_resident"]
    with pytest.raises(SystemExit, match="--no_augment or --feature_cache"):
        run_port(train, argv + PORT_FLAGS)
    with pytest.raises(SystemExit, match="--no_augment or --feature_cache"):
        run_jax("icee_tpu.cli.train", argv, monkeypatch)
    assert not os.path.exists(run["tmp"] / "r_refused")


def test_progress_chunk_resumes_a_killed_run(resident, capsys, monkeypatch):
    """``--progress_chunk 1``: a run killed after its 2nd record of the
    second epoch's emotion pass, started again with the same arguments,
    prints ``RESUMING mid-epoch`` and ends in the uninterrupted run's
    checkpoint at atol 0, the record cleared."""
    from icee_tpu_torch.checkpoint import progress
    from icee_tpu_torch.train import loops

    tmp = resident["tmp"]
    monkeypatch.setattr(train, "init_weights", lambda family, cfg, ecfg,
                        seed, device: tuple(bridge.to_torch(w, device)
                                            for w in resident["weights"]))
    ratio_one(monkeypatch, common)
    argv = train_argv(tmp, "r_kill", extra=[
        "--device_resident", "--progress_chunk", "1"]) + PORT_FLAGS

    class Killed(RuntimeError):
        pass

    def hook(epoch, pass_idx, row):
        if (epoch, pass_idx, row) == (1, 1, 2):
            raise Killed

    with monkeypatch.context() as mp:
        mp.setattr(loops.MultitaskTrainer, "_progress_hook",
                   staticmethod(hook), raising=False)
        with pytest.raises(Killed):
            run_port(train, argv)
    assert progress.peek_progress(str(tmp / "r_kill"), "demo")["row"] == 2
    capsys.readouterr()
    run_port(train, argv)
    assert "RESUMING mid-epoch: epoch 1, pass 1, row 2/3" in \
        capsys.readouterr().out
    _trees_equal(_final_params(tmp, "r_kill"), _final_params(tmp, "r_dev"))
    assert progress.peek_progress(str(tmp / "r_kill"), "demo") is None


def test_bfloat16_features_pinned_and_streamed(resident, capsys,
                                               monkeypatch):
    """``--feature_dtype bfloat16`` trains; with a budget below the split's
    features the split streams (a NOTE line) and ends in the pinned
    bfloat16 run's checkpoint at atol 0."""
    tmp = resident["tmp"]
    monkeypatch.setattr(train, "init_weights", lambda family, cfg, ecfg,
                        seed, device: tuple(bridge.to_torch(w, device)
                                            for w in resident["weights"]))
    ratio_one(monkeypatch, common)
    flags = ["--device_resident", "--feature_dtype", "bfloat16"]
    capsys.readouterr()
    run_port(train, train_argv(tmp, "r_bf16", 1, flags) + PORT_FLAGS)
    assert "NOTE" not in capsys.readouterr().out
    # 8 images x 2048 bfloat16 = 32 KiB; 12 KiB streams 3 images a buffer
    run_port(train, train_argv(tmp, "r_bf16s", 1, flags + [
        "--device_budget_gb", str(24 / (1 << 20))]) + PORT_FLAGS)
    assert "NOTE: examples/data/train.txt features exceed" in \
        capsys.readouterr().out
    pinned, streamed = _final_params(tmp, "r_bf16"), _final_params(
        tmp, "r_bf16s")
    _trees_equal(streamed, pinned)
    assert all(torch.isfinite(v).all() for v in pinned["decoder"].values())


@pytest.mark.parametrize("mod", [evaluate, caption_batch])
def test_decoders_refuse_data_parallel(mod, run, capsys, tmp_path):
    """``--data_parallel`` in a world of one process (no torchrun, no
    coordinator) is not refused: it decodes single-device after JAX's
    WARNING, and its output is the run without the flag's."""
    argv = ["--vocab_path", str(run["tmp"] / "vocab.pkl"), "--feature_cache",
            run["cache"], "--mode", "happy", "--checkpoint_path",
            run["ckpt"]["port"], "--device", "cpu", *MODEL]
    if mod is evaluate:
        argv += ["--test_path", f"{DATA}/train.txt", "--batch_size", "6"]
    else:
        argv += ["--image_dir", f"{DATA}/img", "--batch_size", "3"]
    outs = []
    for extra in ([], ["--data_parallel"]):
        out = [] if mod is evaluate else [
            "--out", str(tmp_path / f"c{len(extra)}.json")]
        run_port(mod, argv + extra + out)
        text = capsys.readouterr().out
        assert ("WARNING: --data_parallel with a single device; decoding "
                "single-device" in text) == bool(extra)
        outs.append(_decode_lines(text) if mod is evaluate else
                    (tmp_path / f"c{len(extra)}.json").read_text())
    assert outs[0] == outs[1]
    assert outs[0]


def test_hidden_size_beyond_the_scan_plan_is_refused_at_start(run,
                                                              monkeypatch):
    """On a CUDA device (mocked here: ``common.device_of`` returns one and
    the plan's SM count is the H100's 132), H = 2049 (past the streamed
    plans' reach of 2048) is refused with the launch plan's own message
    before any data loads, at any batch; H = 512, 1024 and 2048 pass the
    check, as do batches of 2049 and 4096 (the streamed plan takes any B),
    ``--fused_scan off`` and the CPU."""
    from icee_tpu_torch.core.config import DecoderConfig, TrainConfig
    from icee_tpu_torch.ops import scan_grid

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(scan_grid, "sm_count", lambda device: 132)
    monkeypatch.setattr(common, "device_of", lambda args: cuda)
    loaded = []
    monkeypatch.setattr(common, "make_feature_provider",
                        lambda *a, **kw: loaded.append(a))
    argv = ["--vocab_path", str(run["tmp"] / "vocab.pkl"), "--hidden_size",
            "2049", "--factored_size", "2049"]
    for family, kernel in (("stylenet", "K3"), ("nic", "K4")):
        with pytest.raises(ValueError, match=f"{kernel} .*no launch plan"):
            run_port(train, argv + ["--family", family])
    with pytest.raises(ValueError, match="K3 .*B = 4096, H = 2049"):
        run_port(train, ["--vocab_path", str(run["tmp"] / "vocab.pkl"),
                         "--hidden_size", "2049", "--factored_size", "2049",
                         "--family", "stylenet", "--caption_batch_size",
                         "4096", "--language_batch_size", "4096"])
    assert loaded == []
    tcfg = TrainConfig(caption_batch_size=64, language_batch_size=96)
    for h in (512, 1024, 2048):
        train.check_scan_plan("factored", DecoderConfig(hidden_size=h), tcfg,
                              cuda)
        train.check_scan_plan("nic", DecoderConfig(hidden_size=h), tcfg,
                              cuda)
    for b in (2049, 4096):
        big = TrainConfig(caption_batch_size=b, language_batch_size=b)
        for family in ("factored", "nic"):
            train.check_scan_plan(family, DecoderConfig(hidden_size=1024),
                                  big, cuda)
    train.check_scan_plan("factored", DecoderConfig(hidden_size=2049),
                          dataclasses.replace(tcfg, fused_scan=False), cuda)
    train.check_scan_plan("factored", DecoderConfig(hidden_size=2049), tcfg,
                          torch.device("cpu"))


@pytest.mark.parametrize("mod,argv", [
    (train, ["--vocab_path", "unused.pkl"]),
    (evaluate, ["--vocab_path", "unused.pkl", "--test_path", "unused.txt"]),
    (caption_batch, ["--vocab_path", "unused.pkl"]),
    (validate, ["--vocab_path", "unused.pkl", "--caption_path", "x.txt"]),
    (sample, ["--vocab_path", "unused.pkl", "--image", "x.jpg"]),
])
def test_cuda_device_without_cuda_raises(mod, argv):
    """The default ``--device cuda`` raises where CUDA is missing: nothing
    runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    assert mod.parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_port(mod, argv)


def test_entry_points_name_the_port_modules():
    """Every ``icee-torch-*`` console script points at a shim that runs a
    port module as ``__main__``."""
    import tomllib

    from icee_tpu_torch.cli import _entry

    with open("pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    ours = {k: v for k, v in scripts.items() if k.startswith("icee-torch-")}
    assert len(ours) == 11
    assert ours["icee-torch-senticap-train"].endswith(":senticap_train")
    ran = []
    orig = _entry.runpy.run_module
    try:
        _entry.runpy.run_module = lambda m, **kw: ran.append(m)
        for target in ours.values():
            mod, _, fn = target.partition(":")
            assert mod == "icee_tpu_torch.cli._entry"
            getattr(_entry, fn)()
    finally:
        _entry.runpy.run_module = orig
    for m in ran:
        assert m.startswith("icee_tpu_torch.")
        __import__(m)
    assert len(set(ran)) == 11


def test_chip_smoke_writes_weights_the_importers_read(monkeypatch):
    """``chip_smoke.py`` hands its CLI stages a seeded decoder and head as
    the reference's torch state dicts and a ResNet-152 as a torchvision-
    named npz: each, read back by the port's importers, is the tree it was
    written from, bit for bit."""
    from icee_tpu_torch.checkpoint import torch_import as ti
    from icee_tpu_torch.core.config import DecoderConfig, EncoderConfig
    from icee_tpu_torch.models import encoder as enc_mod
    from icee_tpu_torch.models import factored_lstm as fl
    from icee_tpu_torch.models import resnet

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    def equal(a, b):
        assert cs.flat_tree(a) == cs.flat_tree(b)

    dec = fl.init_params(torch.Generator().manual_seed(1), DecoderConfig(
        vocab_size=40, embed_size=E, hidden_size=H, factored_size=H))
    head = enc_mod.init_head_params(torch.Generator().manual_seed(2),
                                    EncoderConfig(embed_size=E))
    head["bn"]["running_mean"].normal_(generator=torch.Generator()
                                       .manual_seed(3))
    equal(ti.import_factored_decoder_state_dict(
        cs.reference_decoder_state_dict(dec)), dec)
    equal(ti.import_encoder_head_state_dict(
        cs.reference_head_state_dict(head)), head)
    backbone = resnet.init_params(torch.Generator().manual_seed(0))
    equal(resnet.import_torch_state_dict(cs.resnet_state_dict(backbone)),
          backbone)
