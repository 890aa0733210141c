"""Mid-epoch progress records and kill/resume in the port
(``icee_tpu_torch/checkpoint/progress.py`` and ``TrainConfig.progress_chunk``
in ``train/loops.py``) on the CPU, the cases of the JAX package's
``tests/test_progress_resume.py``.

A run is killed at an exact (epoch, pass, row) by raising in the trainer's
``_progress_hook``; a FRESH trainer over fresh splits in the same
``model_dir`` resumes from the record and must end in the uninterrupted
run's state at atol 0: parameters, optimizer states, the generator, the
plateau counters and best BLEU.
"""

import os

import jax
import numpy as np
import pytest
import torch

from icee_tpu_torch.checkpoint import progress
from tests.test_torch_device_epoch import (_one_cpu_thread,  # noqa: F401
                                           assert_same_state, data, pinned,
                                           trainer, trees_equal)


class Killed(RuntimeError):
    """Raised by the progress hook to stand for a preemption."""


def splits(data):
    """Fresh multitask splits: factual 4 x 4 rows, emotion 3 x 3 rows."""
    return (pinned(data, "ds", 4), pinned(data, "ds", 4, False),
            pinned(data, "emo", 3), pinned(data, "emo", 3, False))


def kill_at(tr, where):
    def hook(epoch, pass_idx, row):
        if (epoch, pass_idx, row) == where:
            raise Killed
    tr._progress_hook = hook


def test_chunked_epoch_equals_the_whole_epoch(data, tmp_path):
    """``progress_chunk = 3`` over 4 rows: records at rows 3 and 4, and the
    epoch equals the one without records at atol 0."""
    whole = trainer(data, tmp_path, tag="whole")
    chunked = trainer(data, tmp_path, tag="chunked", progress_chunk=3)
    rows = []
    chunked._progress_hook = lambda e, p, r: rows.append(r)
    a = whole._run_train(pinned(data, "ds", 4), 0, 1, "T", epoch=0)
    b = chunked._run_train(pinned(data, "ds", 4), 0, 1, "T", epoch=0)
    assert rows == [3, 4] and a.loss == b.loss
    assert_same_state(chunked, whole)
    rec = progress.peek_progress(chunked.model_dir, "toy")
    assert rec["row"] == 4 and rec["epoch"] == 0 and rec["pass_idx"] == 0
    assert torch.equal(rec["rng"], whole.generator.get_state())
    assert progress.peek_progress(whole.model_dir, "toy") is None


@pytest.mark.parametrize("where", [(1, 0, 2), (1, 1, 1), (0, 0, 1)],
                         ids=["epoch1-fac-row2", "epoch1-emo-row1",
                              "epoch0-fac-row1"])
def test_multitask_kill_and_resume_equal_the_uninterrupted_run(
        data, tmp_path, where):
    ref = trainer(data, tmp_path, tag="ref", progress_chunk=1)
    want = ref.train(*splits(data), num_epochs=2)
    victim = trainer(data, tmp_path, tag="run", progress_chunk=1)
    kill_at(victim, where)
    with pytest.raises(Killed):
        victim.train(*splits(data), num_epochs=2)
    assert progress.peek_progress(victim.model_dir, "toy")["row"] == where[2]
    resumed = trainer(data, tmp_path, tag="run", progress_chunk=1)
    got = resumed.train(*splits(data), num_epochs=2)
    assert got == want
    assert resumed.epochs_since_improvement == ref.epochs_since_improvement
    assert_same_state(resumed, ref)
    assert progress.peek_progress(resumed.model_dir, "toy") is None
    assert sorted(os.listdir(resumed.model_dir)) == \
        sorted(os.listdir(ref.model_dir))


def test_factual_only_and_transfer_kill_and_resume(data, tmp_path):
    ref = trainer(data, tmp_path, tag="fref", progress_chunk=1)
    ref.train_factual_only(pinned(data, "ds", 4), pinned(data, "ds", 4, False),
                           num_epochs=2)
    victim = trainer(data, tmp_path, tag="fac", progress_chunk=1)
    kill_at(victim, (1, 0, 2))
    with pytest.raises(Killed):
        victim.train_factual_only(pinned(data, "ds", 4),
                                  pinned(data, "ds", 4, False), num_epochs=2)
    resumed = trainer(data, tmp_path, tag="fac", progress_chunk=1)
    resumed.train_factual_only(pinned(data, "ds", 4),
                               pinned(data, "ds", 4, False), num_epochs=2)
    assert_same_state(resumed, ref)
    assert resumed.best_bleu4 == ref.best_bleu4

    kw = dict(cls="TransferTrainer", progress_chunk=2)
    tref = trainer(data, tmp_path, tag="tref", **kw)
    tref.train_transfer(pinned(data, "emo", 3), pinned(data, "emo", 3, False),
                        num_epochs=2)
    victim = trainer(data, tmp_path, tag="tr", **kw)
    kill_at(victim, (1, 0, 2))
    with pytest.raises(Killed):
        victim.train_transfer(pinned(data, "emo", 3),
                              pinned(data, "emo", 3, False), num_epochs=2)
    resumed = trainer(data, tmp_path, tag="tr", **kw)
    resumed.train_transfer(pinned(data, "emo", 3),
                           pinned(data, "emo", 3, False), num_epochs=2)
    assert_same_state(resumed, tref)
    assert progress.peek_progress(resumed.model_dir, "toy") is None


def _record(row, value):
    return progress.make_record(
        epoch=0, pass_idx=0, row=row, rng=torch.zeros(4, dtype=torch.uint8),
        params={"decoder": {"w": torch.full((2,), value)}, "head": None},
        opt_states={}, losses=np.zeros(3), ntoks=np.zeros(3),
        epochs_since_improvement={"factual": 1}, best_bleu4={"factual": .5})


def test_a_kill_between_the_renames_leaves_a_readable_record(tmp_path,
                                                             monkeypatch):
    """``save_progress`` moves the live record to ``.old`` before the new
    one to live: killed between the two renames, the ``.old`` survivor is
    read; a later save replaces it and leaves no remnant."""
    folder = str(tmp_path)
    progress.save_progress(folder, "toy", _record(1, 1.0))
    renames = []
    real = os.rename

    def rename(src, dst):
        renames.append(dst)
        real(src, dst)
        if dst.endswith(".old"):
            raise Killed

    monkeypatch.setattr(os, "rename", rename)
    with pytest.raises(Killed):
        progress.save_progress(folder, "toy", _record(2, 2.0))
    monkeypatch.setattr(os, "rename", real)
    path = progress.progress_path(folder, "toy")
    assert not os.path.exists(path) and os.path.isdir(path + ".old")
    assert os.path.isdir(path + ".new")
    rec = progress.peek_progress(folder, "toy")
    assert rec["row"] == 1
    assert torch.equal(rec["params"]["decoder"]["w"], torch.ones(2))
    assert rec["epochs_since_improvement"] == {"factual": 1}
    progress.save_progress(folder, "toy", _record(3, 3.0))
    assert sorted(os.listdir(folder)) == ["progress_checkpoint_toy"]
    assert progress.peek_progress(folder, "toy")["row"] == 3


def test_completion_clears_the_record(data, tmp_path):
    """A loop that runs to its end removes the record and any remnant, so
    a later fresh run in the same directory starts from scratch; without
    progress_chunk nothing is written."""
    tr = trainer(data, tmp_path, tag="run", progress_chunk=2)
    path = progress.progress_path(tr.model_dir, "toy")
    os.makedirs(path + ".new")
    tr.train_factual_only(pinned(data, "ds", 4), pinned(data, "ds", 4, False),
                          num_epochs=1)
    assert not any(n.startswith("progress_checkpoint")
                   for n in os.listdir(tr.model_dir))
    off = trainer(data, tmp_path, tag="off")
    rows = []
    off._progress_hook = lambda *a: rows.append(a)
    off.train_factual_only(pinned(data, "ds", 4), pinned(data, "ds", 4, False),
                           num_epochs=1)
    assert rows == [] and progress.peek_progress(off.model_dir, "toy") is None
    progress.clear_progress(str(tmp_path / "nothing"), "toy")    # no error


def test_a_jax_orbax_progress_directory_raises(tmp_path):
    """The JAX package's orbax record is not read by the port: the trainer
    would resume from it, so the read raises and says why."""
    from icee_tpu.checkpoint import progress as jprogress

    record = jprogress.make_record(
        epoch=0, pass_idx=0, row=1, rng=jax.random.PRNGKey(0),
        params={"decoder": {"w": np.ones(2, np.float32)}},
        opt_states={"o": np.zeros(1, np.float32)},
        losses=np.zeros(3), ntoks=np.zeros(3),
        epochs_since_improvement={"factual": 0}, best_bleu4={"factual": 0.0})
    jprogress.save_progress(str(tmp_path), "toy", record)
    assert os.path.isdir(progress.progress_path(str(tmp_path), "toy"))
    with pytest.raises(ValueError, match="orbax"):
        progress.peek_progress(str(tmp_path), "toy")
    with pytest.raises(ValueError, match="orbax"):
        progress.load_progress(str(tmp_path), "toy",
                               {"params": {}, "opt_states": {}})


def test_records_restore_on_the_trainers_device(data, tmp_path):
    """A record's tensors come back shaped and placed as the trainer's own
    (``_like``), Adam states as AdamState, scalars as Python numbers."""
    tr = trainer(data, tmp_path, progress_chunk=4)
    tr._run_train(pinned(data, "ds", 4), 0, 1, "T", epoch=3, pass_idx=1)
    rec = progress.load_progress(
        tr.model_dir, "toy",
        {"params": {"decoder": tr.dec, "head": tr.head},
         "opt_states": {"optimizer": tr.opt_state,
                        "lang_optimizer": tr.lang_opt_state}})
    assert (rec["epoch"], rec["pass_idx"], rec["row"]) == (3, 1, 4)
    assert type(rec["opt_states"]["optimizer"]) is type(tr.opt_state)
    assert trees_equal(rec["params"]["decoder"], tr.dec)
    assert trees_equal(rec["opt_states"]["optimizer"], tr.opt_state)
    assert rec["losses"].dtype == torch.float64
