"""The port's device-resident epochs (``icee_tpu_torch/data/device.py`` and
the device tiers of ``train/loops.py``) on the CPU.

A split held on the device trains the host loop's steps in the host loop's
order with the same randomness, so against the port's own host-loader
epoch everything is held at atol 0: the parameters, the optimizer states,
the generator, the epoch loss, BLEU, top-5 and the samples.  Against the
JAX package's device epoch (its one-dispatch ``lax.scan``, with its draws
injected as ``tests/test_torch_trainer.py`` injects them) the tolerances
are that file's.  Tiny widths on ``examples/data`` (8 images x 2 captions:
the split stores each feature once), one CPU thread.
"""

import jax
import numpy as np
import pytest
import torch

from icee_tpu.data import device as jdevice
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import TrainConfig
from icee_tpu_torch.data import device as dd
from icee_tpu_torch.data import pipeline as pipe
from icee_tpu_torch.train import loops
from tests.test_torch_trainer import (LR, MAX_LEN, PARAM_ATOL,  # noqa: F401
                                      _assert_params_close, _configs,
                                      _head_noise, _jax_draws, _weights,
                                      data)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One CPU thread (see ``tests/test_torch_trainer.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def trees_equal(a, b) -> bool:
    """Two tensor trees (dicts, lists, AdamStates) equal at atol 0."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if hasattr(a, "mu"):
        return (a.count == b.count and a.hyperparams == b.hyperparams
                and trees_equal(a.mu, b.mu) and trees_equal(a.nu, b.nu))
    return a == b


def assert_same_state(got, want):
    """Two port trainers ended in the same state, bit for bit."""
    assert trees_equal(got.dec, want.dec)
    assert trees_equal(got.head, want.head)
    assert trees_equal(got.opt_state, want.opt_state)
    assert trees_equal(got.lang_opt_state, want.lang_opt_state)
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def trainer(data, tmp_path, family="factored", ratio=1.0, tag="t",
            cls="MultitaskTrainer", **tkw):
    """A port trainer from the JAX trainer tests' weights, on the CPU with
    its own generator (no injected draws)."""
    jcfg, cfg, _, tcfg = _configs(data["vocab"], family, ratio, **tkw)
    dec, head = _weights(jcfg, family)
    return getattr(loops, cls)(
        cfg, tcfg, data["vocab"], bridge.to_torch(dec),
        None if head is None else bridge.to_torch(head), family=family,
        device="cpu", model_dir=str(tmp_path / tag), data_name="toy")


def host(data, which, batch, shuffle=True, spatial=False):
    feats = data["spatial" if spatial else "pooled"]
    return pipe.caption_dataset_loader(
        data[which][0], batch, MAX_LEN, feats.__getitem__, shuffle=shuffle,
        seed=0, prefetch=0)


def pinned(data, which, batch, shuffle=True, spatial=False, **kw):
    feats = data["spatial" if spatial else "pooled"]
    return dd.from_examples(data[which][0], batch, MAX_LEN,
                            feats.__getitem__, shuffle=shuffle, seed=0,
                            device="cpu", **kw)


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_indices_match_the_batch_loader_and_jax(data, shuffle):
    """Three epochs: the same batches as the port's ``BatchLoader`` and
    JAX's ``DeviceCaptionData`` from the same seed, the last one partial."""
    feats = data["pooled"]
    loader = pipe.caption_dataset_loader(
        data["ds"][0], 5, MAX_LEN, feats.__getitem__, shuffle=shuffle,
        seed=7, prefetch=0)
    port = dd.from_examples(data["ds"][0], 5, MAX_LEN, feats.__getitem__,
                            shuffle=shuffle, seed=7, device="cpu")
    jax_data = jdevice.from_examples(data["ds"][1], 5, MAX_LEN,
                                     feats.__getitem__, shuffle=shuffle,
                                     seed=7)
    assert len(port) == len(loader) == len(jax_data) == 4   # 16 = 5+5+5+1
    for _ in range(3):
        batches = loader._index_batches()
        idx, valid = port.epoch_indices()
        jidx, jvalid = jax_data.epoch_indices()
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)
        for b, hb in enumerate(batches):
            np.testing.assert_array_equal(idx[b, : len(hb)], hb)
            assert valid[b].sum() == len(hb) and not valid[b, len(hb):].any()


@pytest.mark.parametrize("style", [0, 1])
@pytest.mark.parametrize("family", ["factored", "nic"])
def test_device_epoch_equals_the_host_epoch(data, tmp_path, family, style):
    """One training epoch (factual: 4 batches of 4; emotion: 3 of 3, the
    last padded) from the same weights and seed: the same state and epoch
    loss at atol 0."""
    which, batch = ("ds", 4) if style == 0 else ("emo", 3)
    a = trainer(data, tmp_path, family, tag="host")
    b = trainer(data, tmp_path, family, tag="dev")
    ha = a._run_train(host(data, which, batch), style, 1, "T")
    hb = b._run_train(pinned(data, which, batch), style, 1, "T")
    assert hb.loss == ha.loss
    assert_same_state(b, a)


def test_multiref_split_stores_each_feature_once_and_trains_as_the_host(
        data, tmp_path):
    """16 captions of 8 images hold 8 features; two whole regime epochs
    (training, validation with BLEU and the K2 sample's plain search,
    checkpoints) equal the host loaders' run."""
    split = pinned(data, "ds", 4)
    assert tuple(split.images.shape) == (8, 32) and split.num_examples == 16
    feats = data["pooled"]
    for i, e in enumerate(data["ds"][0]):
        assert torch.equal(split.images[split.image_index[i]],
                           torch.from_numpy(feats[e.image]))
    runs = []
    for tag, make in (("host", host), ("dev", pinned)):
        tr = trainer(data, tmp_path, tag=tag)
        samples = []
        sample_fn = tr.sample_fn
        tr.sample_fn = lambda *a: samples.append(sample_fn(*a)) or samples[-1]
        out = tr.train(make(data, "ds", 4), make(data, "ds", 4, False),
                       make(data, "emo", 3), make(data, "emo", 3, False),
                       num_epochs=2)
        runs.append((tr, out, samples))
    (a, oa, sa), (b, ob, sb) = runs
    assert ob == oa and sb == sa and len(sa) == 4
    assert b.epochs_since_improvement == a.epochs_since_improvement
    assert_same_state(b, a)


def test_attention_device_epoch_equals_the_host_epoch(data, tmp_path):
    """StyleNet+Att at ratio 0.8 (K5's sampled path, coins drawn from the
    generator) on spatial features: both tracks of one epoch equal."""
    runs = []
    for tag, make in (("host", host), ("dev", pinned)):
        tr = trainer(data, tmp_path, "factored_att", 0.8, tag=tag)
        tr.train(make(data, "ds", 8, spatial=True),
                 make(data, "ds", 8, False, spatial=True),
                 make(data, "emo", 8, spatial=True),
                 make(data, "emo", 8, False, spatial=True), num_epochs=1)
        runs.append(tr)
    assert_same_state(runs[1], runs[0])


@pytest.mark.parametrize("family", ["factored", "nic"])
def test_device_validation_equals_the_host_validation(data, tmp_path, family):
    """After a training epoch: loss, top-5, BLEU-4 and the sample equal,
    at style 0 over 4 batches of 5 (the last partial)."""
    tr = trainer(data, tmp_path, family)
    tr._run_train(host(data, "ds", 4), 0, 1, "T")
    got_samples, want_samples = [], []
    fn = tr.sample_fn
    tr.sample_fn = lambda *a: want_samples.append(fn(*a))
    want = tr._run_val(host(data, "ds", 5, False), 0)
    tr.sample_fn = lambda *a: got_samples.append(fn(*a))
    got = tr._run_val(pinned(data, "ds", 5, False), 0)
    assert (got.loss, got.top5, got.bleu4) == (want.loss, want.top5,
                                               want.bleu4)
    assert got_samples == want_samples and len(got_samples) == 1


def test_paper_regime_style_epochs_equal_the_host_loop(data, tmp_path):
    """The factual epoch on a pinned split and a text-only style epoch on
    ``from_styled``: the decoder and the style optimizer equal."""
    ids = [e.caption_ids for e in data["emo"][0]]
    runs = []
    for tag in ("host", "dev"):
        tr = trainer(data, tmp_path, tag=tag, cls="PaperRegimeTrainer")
        if tag == "host":
            fac = host(data, "ds", 4)
            style = pipe.styled_caption_loader(ids, 3, MAX_LEN, seed=0,
                                               prefetch=0)
        else:
            fac = pinned(data, "ds", 4)
            style = dd.from_styled(ids, 3, MAX_LEN, seed=0, device="cpu")
            assert style.images is None and len(style) == 3
        tr.train(fac, {"happy": style}, num_epochs=2)
        runs.append(tr)
    assert_same_state(runs[1], runs[0])
    assert trees_equal(runs[1].style_opt_states, runs[0].style_opt_states)


def test_bf16_storage_equals_f32_storage_of_the_rounded_features(
        data, tmp_path):
    """bfloat16 storage halves the bytes; each gathered batch is cast back
    to float32, so an epoch equals one over the same features rounded to
    bfloat16 and stored as float32, at atol 0."""
    rounded = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
               for k, v in data["pooled"].items()}
    narrow = pinned(data, "ds", 4, feature_dtype=torch.bfloat16)
    assert narrow.images.dtype == torch.bfloat16
    wide = dd.from_examples(data["ds"][0], 4, MAX_LEN, rounded.__getitem__,
                            seed=0, device="cpu")
    a, b = trainer(data, tmp_path, tag="a"), trainer(data, tmp_path, tag="b")
    assert a._run_train(narrow, 0, 1, "T").loss == \
        b._run_train(wide, 0, 1, "T").loss
    assert_same_state(a, b)
    assert not trees_equal(a.dec, trainer(data, tmp_path).dec)   # it trained


def test_pin_plan_has_two_tiers():
    shape = (196, 2048)
    per = 196 * 2048 * 4
    assert dd.pin_plan(10, shape, budget_bytes=10 * per) == "pin"
    assert dd.pin_plan(11, shape, budget_bytes=10 * per) == "stream"
    # bfloat16 storage halves the bytes: twice the images pin
    assert dd.pin_plan(20, shape, budget_bytes=10 * per,
                       bytes_per_feature=2) == "pin"
    assert dd.pin_plan(21, shape, budget_bytes=10 * per,
                       bytes_per_feature=2) == "stream"
    # no 2x factor: a split of exactly the budget pins (JAX's "per_batch")
    assert dd.pin_plan(6000, (2048,), budget_bytes=6000 * 2048 * 4) == "pin"


@pytest.mark.parametrize("switched", [False, True])
def test_senticap_epoch_equals_the_step_loop(switched):
    """``make_base_epoch`` / ``make_switched_epoch`` over an epoch's index
    rows equal the step called row by row from the same generator, and
    return the losses read once."""
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import model, switched as sw
    from icee_tpu_torch.senticap.config import senticap_conf
    from icee_tpu_torch.senticap.solver import make_solver
    from icee_tpu_torch.senticap import train as st
    from tests.test_torch_senticap_switched import (MAXLEN, SMALL, V, VIS,
                                                    _records)

    recs = _records(60, 24)
    feats = {r["image"]: np.random.default_rng(i).standard_normal(
        VIS).astype(np.float32) for i, r in enumerate(recs)}
    w2i, _ = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    ds = sio.make_split(recs, feats, w2i, MAXLEN, VIS)
    conf = senticap_conf(batch_size_val=4, learning_rate=0.01, **SMALL)
    base = model.init_params(torch.Generator().manual_seed(2), V, conf)
    rng = np.random.default_rng(5)
    if switched:
        rows = torch.as_tensor(np.stack(st._epoch_indices_by_sentiment(
            ds.senti, 4, rng)))
    else:
        rows = torch.as_tensor(st._epoch_indices(len(ds.senti), 4, rng))
    data_t = sio.device_dataset(ds, "cpu")
    results = []
    for whole in (True, False):
        params = (sw.init_params(torch.Generator().manual_seed(1), V, conf,
                                 base=base) if switched
                  else {k: v.clone() for k, v in base.items()})
        solver = make_solver(conf, sw.switch_param_mask(params)
                             if switched else None)
        opt = solver.init(params)
        gen = torch.Generator().manual_seed(3)
        if whole:
            make = st.make_switched_epoch if switched else st.make_base_epoch
            params, opt, gen, losses = make(conf, solver, device="cpu")(
                params, opt, data_t, rows, gen)
            assert losses.device.type == "cpu" and len(losses) == len(rows)
            losses = losses.tolist()
        else:
            make = st.make_switched_step if switched else st.make_base_step
            step = make(conf, solver, device="cpu")
            losses = []
            for idx in rows:
                params, opt, loss = step(params, opt, data_t, idx, gen)
                losses.append(float(loss))
        results.append((params, opt, gen.get_state(), losses))
    (p1, o1, g1, l1), (p2, o2, g2, l2) = results
    assert trees_equal(p1, p2) and trees_equal(o1, o2)
    assert torch.equal(g1, g2) and l1 == l2


@pytest.mark.parametrize("style", [0, 1])
def test_device_epoch_matches_the_jax_device_epoch(data, tmp_path, style):
    """One StyleNet epoch on a pinned split in both packages, JAX's
    one-dispatch ``lax.scan`` epoch against the port's, JAX's draws
    injected: the epoch loss to rtol 1e-5 and the parameters to
    ``tests/test_torch_trainer.py``'s ``PARAM_P99`` / ``PARAM_ATOL``."""
    from icee_tpu.train import loops as jloops

    jcfg, cfg, jtcfg, tcfg = _configs(data["vocab"], "factored", 1.0)
    dec, head = _weights(jcfg, "factored")
    port = loops.MultitaskTrainer(
        cfg, tcfg, data["vocab"], bridge.to_torch(dec), bridge.to_torch(head),
        device="cpu", model_dir=str(tmp_path / "p"), data_name="toy",
        draws=_jax_draws(0, 0.5, 1.0))
    jt = jloops.MultitaskTrainer(jcfg, jtcfg, data["jvocab"], dec, head,
                                 model_dir=str(tmp_path / "j"),
                                 data_name="toy")
    which, batch = ("ds", 4) if style == 0 else ("emo", 3)
    feats = data["pooled"]
    got = port._run_train(pinned(data, which, batch), style, 1, "T")
    want = jt._run_train(jdevice.from_examples(
        data[which][1], batch, MAX_LEN, feats.__getitem__, seed=0),
        style, 1, "T")
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
    _assert_params_close(port.dec, jax.tree.map(np.asarray, jt.dec))
    jhead = jax.tree.map(np.asarray, jt.head)
    _assert_params_close(port.head, jhead, quantile=False)
    _assert_params_close(_head_noise(port.head), _head_noise(jhead))
    assert PARAM_ATOL == 2 * LR * 14


def test_device_data_needs_no_card():
    """The split builders take an explicit device; on CUDA they would pin
    there (``device`` defaults to CUDA, which raises where there is none)."""
    split = dd.from_styled([[1, 4, 2], [1, 5, 6, 2]], 2, 6, device="cpu")
    assert split.device.type == "cpu" and split.captions.dtype == torch.int64
    assert split.lengths.tolist() == [3, 4]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dd.from_styled([[1, 2]], 1, 4)
    captions = torch.tensor([[1, 4, 2], [1, 5, 2]])
    lengths = torch.tensor([3, 3])
    feats, caps, lens = dd.gather_batch(
        torch.ones(2, 3), captions, lengths, torch.tensor([1, 0]),
        torch.tensor([1, 0]), torch.tensor([True, False]))
    assert feats.tolist() == [[1.0] * 3, [0.0] * 3]
    assert caps.tolist() == [[1, 5, 2], [0, 0, 0]] and lens.tolist() == [3, 0]
    assert TrainConfig().progress_chunk == 0
