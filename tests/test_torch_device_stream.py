"""The port's streamed device epochs (``data/device.py::StreamedCaptionData``
and ``from_examples_streamed``) on the CPU.

A streamed split keeps its features on the host and moves one chunk of
batch rows at a time; each chunk's unique features are compacted into a
``capacity``-row buffer and gathered through a remap, so a streamed epoch
equals the pinned epoch (and so the host-loader epoch) at atol 0.  On the
CPU the stream yields the chunk's host buffer; the side-stream copy runs
only on CUDA (``chip_smoke.py`` phase 20 holds it to the pinned epoch).
"""

import numpy as np
import pytest
import torch

from icee_tpu_torch.checkpoint import progress
from icee_tpu_torch.data import device as dd
from tests.test_torch_device_epoch import (MAX_LEN, _one_cpu_thread,  # noqa: F401
                                           assert_same_state, data, host,
                                           pinned, trainer)

PER = 32 * 4          # bytes of one pooled test feature (FEAT = 32, float32)


def streamed(data, which, batch, capacity_rows, shuffle=True, spatial=False,
             **kw):
    """A streamed split whose buffers hold ``capacity_rows`` features."""
    feats = data["spatial" if spatial else "pooled"]
    per = PER * (4 if spatial else 1)
    return dd.from_examples_streamed(
        data[which][0], batch, MAX_LEN, feats.__getitem__, shuffle=shuffle,
        seed=0, budget_bytes=2 * capacity_rows * per, device="cpu", **kw)


def test_chunk_features_remap_exact(data):
    """Compacted features gathered through the remap are the pinned
    gather's rows, every padding row repeats host row 0, and a chunk over
    capacity raises."""
    split = streamed(data, "ds", 4, capacity_rows=6)
    full = pinned(data, "ds", 4)
    assert split.capacity == 6 and split.rows_per_chunk == 1
    idx, _ = split.epoch_indices()
    rows = split.image_rows(idx)
    for r in range(idx.shape[0]):
        feats, remap = split.chunk_features(rows[r:r + 1])
        assert feats.shape == (6, 32) and remap.dtype == np.int32
        got = feats.index_select(0, torch.from_numpy(remap[0]).long())
        assert torch.equal(got, full.images.index_select(
            0, torch.from_numpy(rows[r]).long()))
        n = len(np.unique(rows[r]))
        assert all(torch.equal(feats[j], split.host_features[0])
                   for j in range(n, 6))
    with pytest.raises(ValueError, match="capacity"):
        split.chunk_features(np.arange(8)[None])


@pytest.mark.parametrize("style", [0, 1])
def test_streamed_epoch_equals_the_pinned_epoch(data, tmp_path, style):
    """Chunks of one batch row (capacity 4 < 8 unique images) against the
    pinned split and the host loader: the same state and epoch loss."""
    which, batch = ("ds", 4) if style == 0 else ("emo", 3)
    trainers, stats = [], []
    for tag, split in (("host", host(data, which, batch)),
                       ("pin", pinned(data, which, batch)),
                       ("stream", streamed(data, which, batch, 4))):
        tr = trainer(data, tmp_path, tag=tag)
        stats.append(tr._run_train(split, style, 1, "T").loss)
        trainers.append(tr)
    assert stats[0] == stats[1] == stats[2]
    assert_same_state(trainers[2], trainers[1])
    assert_same_state(trainers[2], trainers[0])


def test_streamed_validation_equals_the_pinned_validation(data, tmp_path):
    tr = trainer(data, tmp_path)
    want = tr._run_val(pinned(data, "ds", 5, False), 0)
    got = tr._run_val(streamed(data, "ds", 5, 10, False), 0)
    assert (got.loss, got.top5, got.bleu4) == (want.loss, want.top5,
                                               want.bleu4)


def test_streamed_attention_family(data, tmp_path):
    """StyleNet+Att at ratio 0.8 on spatial features streamed in chunks of
    two batches: the whole regime epoch equals the pinned one."""
    runs = []
    for tag, make in (("pin", lambda w, b, s=True: pinned(
            data, w, b, s, spatial=True)),
            ("stream", lambda w, b, s=True: streamed(
                data, w, b, 2 * b, s, spatial=True))):
        tr = trainer(data, tmp_path, "factored_att", 0.8, tag=tag)
        tr.train(make("ds", 4), make("ds", 4, False), make("emo", 3),
                 make("emo", 3, False), num_epochs=1)
        runs.append(tr)
    assert_same_state(runs[1], runs[0])


def test_streamed_progress_records(data, tmp_path):
    """With ``progress_chunk = 3`` over streamed chunks of 2 rows the
    records land every 3 rows and at the end, as on a pinned split, and
    the last record holds the epoch's loss trace."""
    rows = []
    tr = trainer(data, tmp_path, progress_chunk=3)
    tr._progress_hook = lambda e, p, r: rows.append((e, p, r))
    split = streamed(data, "ds", 2, 4)
    assert split.rows_per_chunk == 2 and len(split) == 8
    st = tr._run_train(split, 0, 1, "T", epoch=0, pass_idx=0)
    assert rows == [(0, 0, 3), (0, 0, 6), (0, 0, 8)]
    rec = progress.peek_progress(tr.model_dir, tr.data_name)
    assert rec["row"] == 8 and len(rec["losses"]) == 8
    assert (rec["losses"] > 0).all() and rec["ntoks"].sum() > 0
    ref = trainer(data, tmp_path, tag="ref")
    assert ref._run_train(pinned(data, "ds", 2), 0, 1, "T").loss == st.loss
    assert_same_state(tr, ref)


def test_streamed_builder_capacity_is_half_the_budget(data):
    """The stream double-buffers, so each buffer holds half the budget's
    features (at least one batch, at most the split's unique images);
    bfloat16 storage doubles the rows."""
    budget = 10 * PER
    split = dd.from_examples_streamed(
        data["ds"][0], 2, MAX_LEN, data["pooled"].__getitem__,
        budget_bytes=budget, device="cpu")
    assert split.capacity == 5 and split.rows_per_chunk == 2
    assert split.images is None and split.host_features.shape == (8, 32)
    narrow = dd.from_examples_streamed(
        data["ds"][0], 2, MAX_LEN, data["pooled"].__getitem__,
        budget_bytes=budget, feature_dtype=torch.bfloat16, device="cpu")
    assert narrow.capacity == 8          # 10 rows fit, the split has 8
    assert narrow.host_features.dtype == torch.bfloat16
    assert dd.from_examples_streamed(
        data["ds"][0], 4, MAX_LEN, data["pooled"].__getitem__,
        budget_bytes=2 * PER, device="cpu").capacity == 4   # one batch
    with pytest.raises(ValueError, match="host"):
        dd.StreamedCaptionData(images=torch.zeros(1), captions=None,
                               lengths=None, num_examples=1, batch_size=1)
