"""Console-script entry points (``pyproject.toml [project.scripts]``, the
``icee-torch-*`` commands); port of ``icee_tpu/cli/_entry.py``.

Each CLI module keeps its argparse setup under ``if __name__ ==
"__main__"``; these shims re-run the module as a main program, so that
``icee-torch-train ...`` behaves exactly like ``python -m
icee_tpu_torch.cli.train ...``.
"""

import runpy


def _run(module: str) -> None:
    runpy.run_module(module, run_name="__main__")


def build_vocab() -> None:
    _run("icee_tpu_torch.cli.build_vocab")


def train() -> None:
    _run("icee_tpu_torch.cli.train")


def evaluate() -> None:
    _run("icee_tpu_torch.cli.evaluate")


def validate() -> None:
    _run("icee_tpu_torch.cli.validate")


def sample() -> None:
    _run("icee_tpu_torch.cli.sample")


def export() -> None:
    _run("icee_tpu_torch.cli.export")


def inspect_ckpt() -> None:
    _run("icee_tpu_torch.cli.inspect_ckpt")


def precompute_features() -> None:
    _run("icee_tpu_torch.cli.precompute_features")


def senticap_train() -> None:
    _run("icee_tpu_torch.cli.senticap_train")


def caption_batch() -> None:
    _run("icee_tpu_torch.cli.caption_batch")


def serve() -> None:
    _run("icee_tpu_torch.serve")
