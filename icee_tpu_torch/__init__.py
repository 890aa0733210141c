"""icee_tpu_torch — the PyTorch/CUDA port of ``icee_tpu`` for NVIDIA Hopper.

The JAX package ``icee_tpu`` stays the reference: every module here keeps the
counterpart's name and place, and the tests hold each one against its JAX twin
on the CPU with the same weights (moved through :mod:`icee_tpu_torch.bridge`).
This package imports ``torch`` and never ``jax`` or ``icee_tpu``.

Package map:

- :mod:`icee_tpu_torch.core`     — configs, initializers, device resolution
- :mod:`icee_tpu_torch.data`     — tokenizer, vocabulary, image transforms,
  caption files and the host loaders (``pipeline``)
- :mod:`icee_tpu_torch.native`   — flat ragged caption storage
- :mod:`icee_tpu_torch.ops`      — the cell, the hand-written CUDA kernels
  (``csrc/``: decode step, beam search, training scan, chunked CE) and
  their plain PyTorch versions
- :mod:`icee_tpu_torch.models`   — ResNet-152, encoder head, FactoredLSTM
- :mod:`icee_tpu_torch.train`    — Adam with the reference's clamp, the
  factual / emotion / validation steps, the trainers (``loops``)
- :mod:`icee_tpu_torch.checkpoint` — the trainers' checkpoints, the
  reference torch checkpoints' importers
- :mod:`icee_tpu_torch.evaluation` — masked CE, top-k accuracy, BLEU and
  the COCO caption metrics
- :mod:`icee_tpu_torch.utils`    — the JSONL metrics writer
- :mod:`icee_tpu_torch.decode`   — masked beam search and the decode paths
- :mod:`icee_tpu_torch.serve`    — caption engine, batching, HTTP service
- :mod:`icee_tpu_torch.bridge`   — numpy <-> torch parameter trees
"""

__version__ = "0.1.0"
