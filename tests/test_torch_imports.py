"""The port stands alone: importing every ``icee_tpu_torch`` module, and
everything ``chip_smoke.py`` imports, loads neither JAX nor the JAX package;
nor does loading a vocabulary pickled by the JAX package.

The check runs in a fresh interpreter, since this test process has both
loaded.  ``icee_tpu`` is a prefix of ``icee_tpu_torch``, so the JAX package is
matched as the module ``icee_tpu`` or the prefix ``icee_tpu.`` exactly.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import icee_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, sys
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
from icee_tpu_torch.data.vocab import load_vocab
vocab = load_vocab(sys.argv[2])
print(json.dumps([len(vocab), sorted(sys.modules)]))
"""


def _port_modules():
    return ["icee_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(icee_tpu_torch.__path__,
                                              "icee_tpu_torch.")]


def _chip_smoke_imports():
    """Every module ``chip_smoke.py`` imports, at top level or inside a
    function."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return sorted(n for n in names if n != "__future__")


def _is_forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib", "jax_"))
            or name == "icee_tpu" or name.startswith("icee_tpu."))


def test_port_and_chip_smoke_import_no_jax(tmp_path, tiny_vocab):
    modules = _port_modules() + _chip_smoke_imports()
    assert "icee_tpu_torch.ops.decode_step" in modules
    assert "icee_tpu_torch.serve.app" in modules
    assert "icee_tpu_torch.ops.lstm_scan" in modules
    assert "icee_tpu_torch.train.steps" in modules
    for name in ("ops.nic_scan", "models.lstm", "checkpoint.torch_import",
                 "checkpoint.torch_pickle", "models.attention",
                 "ops.att_decode_step", "ops.att_beam", "ops.att_scan",
                 "ops.senticap_scan", "ops.senticap_decode",
                 "senticap.config", "senticap.io", "senticap.model",
                 "senticap.solver", "senticap.train", "senticap.beam",
                 "senticap.switched", "ops.senticap_switched_decode",
                 "train.loops", "checkpoint.ckpt", "data.captions",
                 "data.pipeline", "native", "evaluation.bleu",
                 "evaluation.coco_metrics", "utils.logging",
                 "native.imagedec", "decode.greedy", "serve.__main__",
                 "cli._entry", "cli.common", "cli.build_vocab",
                 "cli.precompute_features", "cli.train", "cli.validate",
                 "cli.evaluate", "cli.sample", "cli.caption_batch",
                 "cli.export", "cli.inspect_ckpt", "data.device",
                 "checkpoint.progress", "senticap.sentiment",
                 "senticap.eval_out", "senticap.adversarial",
                 "senticap.encode_decode", "cli.senticap_train",
                 "models.seq2seq", "utils.profiling", "utils.embeddings",
                 "parallel", "parallel.mesh", "parallel.collectives",
                 "parallel.train", "parallel.data", "parallel.launch",
                 "parallel.programs", "parallel.dryrun"):
        assert f"icee_tpu_torch.{name}" in modules
    pickled = str(tmp_path / "vocab.pkl")
    tiny_vocab.save(pickled)   # an icee_tpu.data.vocab.Vocabulary
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(modules), pickled],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    n_words, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert n_words == len(tiny_vocab)
    assert "icee_tpu_torch.serve.batching" in loaded
    assert [m for m in loaded if _is_forbidden(m)] == []


def test_forbidden_match_is_exact():
    assert _is_forbidden("icee_tpu") and _is_forbidden("icee_tpu.ops.cells")
    assert _is_forbidden("jax") and _is_forbidden("jaxlib.xla_client")
    assert not _is_forbidden("icee_tpu_torch")
    assert not _is_forbidden("icee_tpu_torch.ops.cells")


def test_kernel_wrappers_reach_no_training_layer():
    """The kernel wrappers (``ops``) and the collectives they use
    (``parallel.collectives``) load nothing of the training layer
    (``icee_tpu_torch.train``)."""
    probe = ("import sys, icee_tpu_torch.ops.chunked_loss, "
             "icee_tpu_torch.parallel.collectives; "
             "print([m for m in sys.modules "
             "if m.startswith('icee_tpu_torch.train')])")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT),
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
