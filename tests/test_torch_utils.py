"""The port's utilities (``icee_tpu_torch/utils/{embeddings,profiling}.py``)
on the CPU: ``load_embeddings`` equals the JAX package's exactly (the same
NumPy generator, the same file); ``StepTimer``'s summary; ``trace`` writes
a Chrome trace that names the ops it ran, and nothing when disabled."""

import json
import os

import numpy as np
import pytest
import torch

from icee_tpu.utils import embeddings as jemb
from icee_tpu.utils import profiling as jprof
from icee_tpu_torch.utils import embeddings, profiling


@pytest.mark.parametrize("seed", [0, 7])
def test_load_embeddings_matches_jax(tmp_path, seed):
    path = tmp_path / "glove.txt"
    path.write_text("dog 0.5 -1.25 2.0\ncat 1 2 3\nunknown 9 9 9\n"
                    "bird  0.1 0.2 0.3 \n")
    word_map = {"<pad>": 0, "dog": 1, "cat": 2, "fish": 3, "bird": 4}
    got, dim = embeddings.load_embeddings(str(path), word_map, seed)
    want, jdim = jemb.load_embeddings(str(path), word_map, seed)
    assert dim == jdim == 3
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(got[1], [0.5, -1.25, 2.0])
    bound = np.sqrt(3.0 / 3)
    assert np.all(np.abs(got[[0, 3]]) <= bound)
    rng = np.random.default_rng(seed)
    assert np.array_equal(embeddings.init_embedding((5, 3), rng),
                          jemb.init_embedding((5, 3),
                                              np.random.default_rng(seed)))


def test_step_timer_summary_discards_warmup(monkeypatch):
    jt = jprof.StepTimer(warmup=0)     # the JAX package's timer
    with jt:
        pass
    clock = iter([0.0, 1.0, 1.0, 1.5, 2.0, 2.002, 3.0, 3.004, 4.0, 4.010])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(warmup=2)
    assert timer.summary() == {"steps": 0}
    for _ in range(5):
        with timer:
            pass
    s = timer.summary()
    assert s["steps"] == 3
    assert s["p50_ms"] == pytest.approx(4.0)
    assert s["mean_ms"] == pytest.approx((2 + 4 + 10) / 3)
    assert s["p95_ms"] == pytest.approx(np.percentile([2, 4, 10], 95))
    assert set(jt.summary()) == set(s)     # the same keys


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path / "t")):
        torch.mm(x, x).sum()
    path = tmp_path / "t" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with profiling.trace(str(tmp_path / "off"), enabled=False):
        torch.mm(x, x)
    assert not os.path.exists(tmp_path / "off")
