"""icee_tpu_torch — the PyTorch/CUDA port of ``icee_tpu`` for NVIDIA Hopper.

The JAX package ``icee_tpu`` stays the reference: every module here keeps the
counterpart's name and place, and the tests hold each one against its JAX twin
on the CPU with the same weights (moved through :mod:`icee_tpu_torch.bridge`).
This package imports ``torch`` and never ``jax`` or ``icee_tpu``.

Package map (the serving slice of the StyleNet FactoredLSTM):

- :mod:`icee_tpu_torch.core`     — configs, initializers, device resolution
- :mod:`icee_tpu_torch.data`     — tokenizer, vocabulary, image transforms
- :mod:`icee_tpu_torch.ops`      — the cell, the hand-written CUDA decode
  kernels (``csrc/``) and their plain PyTorch versions
- :mod:`icee_tpu_torch.models`   — ResNet-152, encoder head, FactoredLSTM
- :mod:`icee_tpu_torch.decode`   — masked beam search and the decode paths
- :mod:`icee_tpu_torch.serve`    — caption engine, batching, HTTP service
- :mod:`icee_tpu_torch.bridge`   — numpy <-> torch parameter trees
"""

__version__ = "0.1.0"
