"""The port's SentiCap CLI (``icee_tpu_torch/cli/senticap_train.py``)
against the JAX package's on the CPU, both in process on one tiny caption
JSON and ``.npz`` of features (E = H = 8, visual 12, max_len 6, batch 4, 2
epochs): the port's through ``main(parser().parse_args(argv))`` with
``--device cpu``, JAX's through ``runpy``.

Both CLIs draw their initial weights from their own generators, which
cannot agree, so the port's init seam (``init_base``, ``init_switched``)
is replaced by JAX's own initial weights for the same seed
(``bridge.to_torch``), and the port's dropout masks
(``senticap/train.py::_dropout``) by JAX's: the JAX trainers' key chain
(one split a step) split into the x and y masks' keys as JAX's steps split
it (three ways for the base step, two for the switch step).  The port runs
with ``--chunked_ce on --fused_scan on`` (the kernels' plain versions, as
on the card); JAX's ``auto`` is off on the CPU.

Held, at the CLI's default lr 1e-3: ``base``'s vocabulary and split line
equal, its printed perplexity rtol 1e-5 and its parameters atol 1e-5
(float32 sums in other orders; measured 2.4e-7; at lr 1e-2 RMSProp's
division by the root of a running mean of squared grads magnifies the
rounding of tiny grads to ~3e-3 over these 18 steps); ``train``'s added
words, closest-word lines and vocab-surgery line equal, its switched
parameters atol 1e-5; ``test`` (switched, and ``--base_only``) from a
pickle either package wrote: the printed decodes, the eval files byte for
byte and the metrics JSON equal.  ``--data_parallel`` is refused naming
slice 8.
"""

import io
import json
import os
import pickle
import runpy
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from icee_tpu.senticap import model as jmodel
from icee_tpu.senticap import switched as jswitched
from icee_tpu_torch import bridge
from icee_tpu_torch.cli import senticap_train as cli
from icee_tpu_torch.senticap import io as sio
from icee_tpu_torch.senticap import train as port_train

E, H, VIS, MAXLEN = 8, 8, 12, 6
SIZES = ["--emb_size", str(E), "--hidden_size", str(H), "--visual_size",
         str(VIS), "--max_len", str(MAXLEN), "--batch_size", "4",
         "--num_epochs", "2"]
PORT = ["--device", "cpu", "--chunked_ce", "on", "--fused_scan", "on"]
WORDS = ["a", "dog", "cat", "runs", "on", "the", "grass", "sits", "red",
         "ball"]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_jax(argv, monkeypatch) -> None:
    monkeypatch.setattr(sys, "argv", ["icee_tpu.cli.senticap_train", *argv])
    runpy.run_module("icee_tpu.cli.senticap_train", run_name="__main__")


def run_port(argv) -> None:
    cli.main(cli.parser().parse_args(argv))


def jax_dropout(n_keys: int, seed: int = 0):
    """A stand-in for the port's ``_dropout`` that returns the JAX
    trainer's masks: per step ``key, k = split(key)``, then the x mask from
    ``split(k, n_keys)[0]`` and the y mask from ``[1]``."""
    state = {"key": jax.random.PRNGKey(seed), "keys": []}

    def draw(generator, shape, frac, device):
        if not state["keys"]:
            state["key"], k = jax.random.split(state["key"])
            state["keys"] = list(jax.random.split(k, n_keys)[:2])
        key = state["keys"].pop(0)
        keep = np.asarray(jax.random.bernoulli(key, 1.0 - frac, shape))
        return torch.from_numpy(keep.astype(np.float32)).to(device) / (
            1.0 - frac)

    return draw


def _write_data(root):
    rng = np.random.default_rng(7)
    caps = []
    for i in range(12):
        for _ in range(3):
            toks = list(rng.choice(WORDS, rng.integers(3, 7)))
            caps.append({"image": f"i{i}", "caption": " ".join(toks)}
                        if len(caps) % 2 else {"image": f"i{i}",
                                               "tokens": toks})
    senti = []
    for i in range(24):
        adj = ["happy", "lovely", "sad"][i % 3]
        noun = ["dog", "cat", "ball"][i % 3 if i % 2 else (i + 1) % 3]
        toks = ["a", adj, noun] + list(rng.choice(WORDS, 2))
        rec = {"image": f"i{i % 12}", "tokens": toks,
               "switch": [0, 1, 0, 0, 0]}
        if i >= 16:
            rec["sentiment"] = -1.0
        senti.append(rec)
    feats = {f"i{i}": rng.standard_normal(VIS).astype(np.float32)
             for i in range(12)}
    paths = {}
    for name, data in (("captions", caps), ("senti", senti)):
        paths[name] = str(root / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(data, f)
    paths["features"] = str(root / "feats.npz")
    np.savez(paths["features"], **feats)
    return paths


def _capture(fn, capsys):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``base`` then ``train`` (from JAX's base pickle) in both packages."""
    tmp = tmp_path_factory.mktemp("senticap_cli")
    paths = _write_data(tmp)
    out = {"tmp": tmp, "paths": paths}
    data = ["--features", paths["features"]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "init_base", lambda vocab_size, conf, unigram, seed,
                   device: bridge.to_torch(jax.tree.map(
                       np.asarray, jmodel.init_params(
                           jax.random.PRNGKey(seed), vocab_size, conf,
                           unigram)), device))
        mp.setattr(cli, "init_switched", lambda vocab_size, conf, base,
                   seed, device: bridge.to_torch(jax.tree.map(
                       np.asarray, jswitched.init_params(
                           jax.random.PRNGKey(seed), vocab_size, conf,
                           base=bridge.to_numpy(base))), device))
        logs = {}
        for side in ("port", "jax"):
            argv = ["base", "--captions", paths["captions"], *data, *SIZES,
                    "--model_out", str(tmp / f"{side}_base.pik")]
            buf = io.StringIO()
            with redirect_stdout(buf):
                if side == "port":
                    mp.setattr(port_train, "_dropout", jax_dropout(3))
                    run_port(argv + PORT)
                else:
                    run_jax(argv, mp)
            logs[f"base_{side}"] = buf.getvalue()
        for side in ("port", "jax"):
            argv = ["train", "--captions", paths["senti"], *data, "-s",
                    "pos", "--base_model", str(tmp / "jax_base.pik"),
                    "--batch_size", "4", "--num_epochs", "2",
                    "--model_out", str(tmp / f"{side}_sw.pik")]
            buf = io.StringIO()
            with redirect_stdout(buf):
                if side == "port":
                    mp.setattr(port_train, "_dropout", jax_dropout(2))
                    run_port(argv + PORT)
                else:
                    run_jax(argv, mp)
            logs[f"train_{side}"] = buf.getvalue()
    out["logs"] = logs
    return out


def _lines(text, prefix):
    return [ln for ln in text.splitlines() if ln.startswith(prefix)]


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_params_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_base_matches_jax(runs):
    logs = runs["logs"]
    port, jx = logs["base_port"], logs["base_jax"]
    assert _lines(port, "vocab ") == _lines(jx, "vocab ")
    assert len(_lines(port, "[senticap base] epoch")) == 2
    got = float(_lines(port, "val perplexity:")[0].split()[-1])
    want = float(_lines(jx, "val perplexity:")[0].split()[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    p, j = (_pickle(runs["tmp"] / f"{s}_base.pik") for s in ("port", "jax"))
    assert p["w2i"] == j["w2i"] and len(p["w2i"]) == len(WORDS) + 1
    assert p["conf"] == {**j["conf"], "CHUNKED_CE": True, "FUSED_SCAN": True}
    _assert_params_close(p["params"], j["params"])


def test_train_vocab_surgery_and_switched_params_match_jax(runs):
    logs = runs["logs"]
    port, jx = logs["train_port"], logs["train_jax"]
    closest = _lines(port, "  ")
    assert closest == _lines(jx, "  ")
    assert [ln.split()[0] for ln in closest] == ["happy", "lovely", "sad"]
    assert _lines(port, "vocab surgery") == _lines(jx, "vocab surgery") == [
        "vocab surgery: +3 sentiment words"]
    assert _lines(port, "vocab ") == _lines(jx, "vocab ")
    assert len(_lines(port, "[senticap switch] epoch")) == 2
    p, j = (_pickle(runs["tmp"] / f"{s}_sw.pik") for s in ("port", "jax"))
    assert p["w2i"] == j["w2i"]
    _assert_params_close(p["params"], j["params"])
    base = _pickle(runs["tmp"] / "jax_base.pik")["params"]
    assert not np.array_equal(p["params"]["w_sw"][:, :len(base["b"])],
                              base["w"])
    assert np.array_equal(p["params"]["w"][:, :len(base["b"])], base["w"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_test_decodes_and_eval_files_match_jax(runs, writer, capsys,
                                               monkeypatch):
    """``test`` on the switched pickle ``writer`` wrote (styled and
    descriptive decodes, the eval files, the metrics JSON), and
    ``--base_only`` on its base pickle, in both packages: equal."""
    tmp, paths = runs["tmp"], runs["paths"]
    for what, model, extra in (("sw", f"{writer}_sw.pik", []),
                               ("base", f"{writer}_base.pik" if writer ==
                                "port" else "jax_base.pik", ["--base_only"])):
        outs = {}
        for side in ("port", "jax"):
            out_dir = tmp / f"eval_{writer}_{what}_{side}"
            argv = ["test", "--captions", paths["captions"], "--features",
                    paths["features"], "--model_in", str(tmp / model),
                    "--beam_size", "4", "--print_n", "20", "--out_dir",
                    str(out_dir), *extra]
            outs[side] = _capture(
                (lambda: run_port(argv + ["--device", "cpu"])) if side ==
                "port" else (lambda: run_jax(argv, monkeypatch)), capsys)
        assert outs["port"] == outs["jax"]
        lines = outs["port"].splitlines()
        assert len(lines) == (24 if what == "sw" else 12) + 1
        metrics = json.loads(lines[-1])
        assert 0.0 <= metrics["Bleu_1"] <= 1.0
        port_dir = tmp / f"eval_{writer}_{what}_port"
        jax_dir = tmp / f"eval_{writer}_{what}_jax"
        names = sorted(os.listdir(jax_dir))
        assert sorted(os.listdir(port_dir)) == names
        assert {"output_pos", "output_des", "reference0", "reference2",
                "highlight.html"} <= set(names)
        for n in names:
            assert (port_dir / n).read_bytes() == (jax_dir / n).read_bytes()


def test_data_parallel_is_refused(runs, capsys):
    """``--data_parallel`` in a world of one process is not refused: it
    trains single-device after a WARNING, the pickle the run without
    the flag's (the same seeded weights and draws)."""
    tmp, data = runs["tmp"], ["--features", runs["paths"]["features"]]
    pickles = []
    for extra in ([], ["--data_parallel"]):
        out = tmp / f"dp{len(extra)}_base.pik"
        run_port(["base", "--captions", runs["paths"]["captions"], *data,
                  *SIZES, "--num_epochs", "1", "--model_out", str(out),
                  *extra, *PORT])
        text = capsys.readouterr().out
        assert ("WARNING: --data_parallel with a single device; training "
                "single-device" in text) == bool(extra)
        pickles.append(sio.load_model(str(out), "cpu")[0])
    for k in pickles[0]:
        assert torch.equal(pickles[0][k], pickles[1][k]), k


def test_hidden_size_past_the_scan_plan_is_refused_at_start(monkeypatch):
    """On a CUDA device (mocked here: ``common.device_of`` returns one and
    the plan's SM count is the H100's 132), ``base`` refuses H = 2049 with
    K8's launch plan's own message before any data loads; H = 1024 and
    2048 pass the check at the default batch of 128 (streamed plans), H =
    512 at batches of 2049 to 8192, as do ``--fused_scan off`` and the CPU
    at any width."""
    from icee_tpu_torch.cli import common
    from icee_tpu_torch.ops import scan_grid

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(scan_grid, "sm_count", lambda device: 132)
    monkeypatch.setattr(common, "device_of", lambda args: cuda)
    loaded = []
    monkeypatch.setattr(sio, "load_captions_json",
                        lambda path: loaded.append(path))
    with pytest.raises(ValueError, match="K8 .*no launch plan.*H = 2049"):
        run_port(["base", "--captions", "unused.json", "--hidden_size",
                  "2049"])
    assert loaded == []
    for h in (1024, 2048):
        cli.check_scan_plan(h, 128, None, cuda)
    # past B = 2048 too (the streamed plan takes any B)
    for b in (2049, 4096, 8192):
        cli.check_scan_plan(512, b, None, cuda)
    cli.check_scan_plan(2049, 128, False, cuda)
    cli.check_scan_plan(2049, 128, None, torch.device("cpu"))


@pytest.mark.parametrize("switched", [False, True])
def test_validation_perplexity_runs_in_training_batches(switched,
                                                        monkeypatch):
    """``base`` ends with ``validation_perplexity`` over the whole training
    split.  The port evaluates the split in blocks of ``batch_size_val``
    rows (K8's plan takes any batch now, 2,560 rows at H = 512 streamed,
    but a block bounds the device memory a whole split would take): every
    forward sees at most that many, and the perplexity equals JAX's one
    pass (rtol 1e-5, the sum's order apart), chunked and materialized,
    base and switched."""
    from icee_tpu.senticap import io as jio
    from icee_tpu.senticap.train import validation_perplexity as jvp
    from icee_tpu_torch.ops.scan_grid import STREAMED, scan_plan
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model, switched as sw
    from icee_tpu_torch.senticap.config import senticap_conf

    assert scan_plan("K8", 2560, 512).b_kind == STREAMED
    scan_plan("K8", 128, 512)
    rng = np.random.default_rng(3)
    w2i = {".": 0, **{w: i + 1 for i, w in enumerate(WORDS)}}
    records = [{"image": f"i{i}", "tokens": list(rng.choice(WORDS, 5)),
                "sentiment": 1.0} for i in range(10)]
    feats = {f"i{i}": rng.standard_normal(VIS).astype(np.float32)
             for i in range(10)}
    ds = sio.make_split(records, feats, w2i, MAXLEN, VIS)
    jds = jio.make_split(records, feats, w2i, MAXLEN, VIS)
    kw = dict(emb_size=E, lstm_hidden_size=H, visual_size=VIS,
              MAX_SENTENCE_LEN=MAXLEN, batch_size_val=4)
    base = jmodel.init_params(jax.random.PRNGKey(5), len(w2i),
                              senticap_conf(**kw))
    p = jax.tree.map(np.asarray, base if not switched else
                     jswitched.init_params(jax.random.PRNGKey(6), len(w2i),
                                           senticap_conf(**kw), base=base))
    seen = []
    for mod in (model, sw):
        fwd = mod.forward
        monkeypatch.setattr(mod, "forward", lambda q, c, x, *a, _f=fwd,
                            **k: seen.append(x.shape[0]) or _f(q, c, x, *a,
                                                               **k))
    for chunked in (True, False):
        conf = senticap_conf(CHUNKED_CE=chunked, **kw)
        want = jvp(jax.tree.map(jax.numpy.asarray, p), dict(conf), jds,
                   switched=switched)
        seen.clear()
        got = port_train.validation_perplexity(bridge.to_torch(p), conf, ds,
                                               switched=switched,
                                               device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert seen == [4, 4, 2]
