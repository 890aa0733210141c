"""Multi-process start-up of the port (``icee_tpu_torch/parallel``), the
counterpart of ``tests/test_multihost.py``: a training run brought up by
JAX's multi-host flags, the refusals, and the dry run.

``python -m icee_tpu_torch.cli.train --data_parallel --tensor_parallel 2
--coordinator_address localhost:<port> --num_processes 4 --process_id r``
runs as four spawned processes (gloo over ``tcp://``, one CPU thread
each) on a (2, 2) mesh: rank 0's log and checkpoint are held against the
same CLI run in this process without the flags (log numbers rtol 1e-5,
parameters within 2 x lr x steps: Adam turns rounding-sized gradient
differences into steps of about lr, ``tests/test_torch_trainer.py``).
"""

import os
import re
import socket
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from icee_tpu_torch.checkpoint import ckpt
from icee_tpu_torch.cli import train
from icee_tpu_torch.core.config import TrainConfig
from icee_tpu_torch.data.vocab import build_vocab
from icee_tpu_torch.parallel import programs
from icee_tpu_torch.parallel.data import check_batch_sizes
from icee_tpu_torch.parallel.dryrun import dryrun_multichip
from icee_tpu_torch.parallel.mesh import Mesh, init_distributed
from icee_tpu_torch.train.optim import tree_leaves

DATA = "examples/data"
LR, EPOCHS, STEPS = 5e-3, 2, 2 * (2 + 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _argv(tmp, side):
    paths = ["--caption_path", f"{DATA}/train.txt", "--val_caption_path",
             f"{DATA}/train.txt"]
    for key in ("happy", "sad", "angry"):
        paths += [f"--{key}_path", f"{DATA}/happy.txt",
                  f"--val_{key}_path", f"{DATA}/happy.txt"]
    return ["--trainer", "multitask", "--family", "stylenet", "--mode",
            "happy", "--vocab_path", str(tmp / "vocab.pkl"), *paths,
            "--embed_size", "16", "--hidden_size", "24", "--factored_size",
            "24", "--max_seq_length", "8", "--dropout", "0.5",
            "--num_epochs", str(EPOCHS), "--caption_batch_size", "8",
            "--language_batch_size", "4", "--lr_caption", str(LR),
            "--lr_language", str(LR), "--model_path", str(tmp / side),
            "--log_path", str(tmp / f"{side}.log"), "--data_name", "demo",
            "--feature_cache", str(tmp / "features.npz"), "--device", "cpu",
            "--fused_scan", "on", "--chunked_ce", "on"]


def _log_numbers(path):
    with open(path) as f:
        text = re.sub(r"Batch Time: [\d.]+, ", "", f.read())
    return (re.sub(r"\d+\.\d+(e-?\d+)?", "#", text),
            [float(x) for x in re.findall(r"\d+\.\d+(?:e-?\d+)?", text)])


@pytest.fixture(scope="module", autouse=True)
def _dryrun():
    """``dryrun_multichip(4, "cpu")``, run in the background from the
    module's start."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(dryrun_multichip, 4, "cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    vocab = build_vocab(f"{DATA}/train.txt", 1)
    if len(vocab) % 2:
        vocab.add_word("<extra>")      # a vocabulary the model axis splits
    vocab.save(str(tmp / "vocab.pkl"))
    rng = np.random.default_rng(0)
    np.savez(tmp / "features.npz", **{
        n: rng.standard_normal(2048).astype(np.float32)
        for n in sorted(os.listdir(f"{DATA}/img"))})
    argv = _argv(tmp, "mesh") + [
        "--data_parallel", "--tensor_parallel", "2", "--coordinator_address",
        f"localhost:{_free_port()}", "--num_processes", "4"]
    ranks = mp.start_processes(programs.multihost_cli, args=(argv,),
                               nprocs=4, join=False, start_method="spawn")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:           # the one-process run while the four ranks run
        train.main(train.parser().parse_args(_argv(tmp, "single")))
    finally:
        torch.set_num_threads(threads)
        while not ranks.join():
            pass
    return tmp


def test_multihost_flags_train_like_one_process(runs):
    """Four processes joined by ``--coordinator_address`` /
    ``--num_processes`` / ``--process_id`` train StyleNet at DP x TP (2, 2)
    (the vocabulary of 48 split in two, dropout 0.5, the host loader):
    rank 0 alone wrote the log and the checkpoint, and they are the
    one-process run's."""
    text, nums = _log_numbers(runs / "mesh.log")
    want_text, want_nums = _log_numbers(runs / "single.log")
    assert text == want_text
    np.testing.assert_allclose(nums, want_nums, rtol=1e-5)
    assert os.listdir(runs / "mesh") == os.listdir(runs / "single") == [
        "HAP_checkpoint_demo"]
    got = ckpt.load_params(str(runs / "mesh" / "HAP_checkpoint_demo"))
    want = ckpt.load_params(str(runs / "single" / "HAP_checkpoint_demo"))
    for tree in ("decoder", "head"):
        for a, b in zip(tree_leaves(got[tree]), tree_leaves(want[tree])):
            assert a.shape == b.shape
            assert (a - b).abs().max() <= 2 * LR * STEPS


def test_batch_sizes_must_divide_the_data_axis():
    """The train CLI's refusal, with the JAX CLI's message, before any
    collective."""
    mesh = Mesh((3, 1), 0, None, None, torch.device("cpu"), "gloo")
    tcfg = TrainConfig(caption_batch_size=8, language_batch_size=6)
    with pytest.raises(SystemExit, match="--caption_batch_size 8 must "
                                         "divide by the data-axis size 3"):
        check_batch_sizes(tcfg, mesh, SystemExit)
    check_batch_sizes(TrainConfig(caption_batch_size=9,
                                  language_batch_size=6), mesh, SystemExit)


def test_init_distributed_without_a_coordinator_is_a_no_op(monkeypatch):
    """No flags and no torchrun environment: nothing starts (JAX's
    ``init_distributed`` is a no-op there too)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_four_ranks(_dryrun):
    """``dryrun_multichip(4, "cpu")``: a StyleNet and a StyleNet+Att
    trainer epoch on the (2, 2) mesh, a SentiCap base epoch at DP 4, the
    sharded K2 and K7 searches; each rank checks that its parameters are
    rank 0's."""
    line = _dryrun.result()
    assert line.startswith("dryrun_multichip OK: 4 ranks, mesh (2, 2)")
    assert "sharded K2 (8, " in line and "sharded K7 (8, " in line
