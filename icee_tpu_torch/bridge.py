"""Parameter trees between the JAX package and the port, as numpy.

Both packages use the same tree structure and layout (dicts of arrays, lists
of ResNet blocks; linear weights ``(in, out)``, stacked ``S_w`` ``(styles,
4, F, F)``, gate order ``[i, f, o, c]``, HWIO conv weights), so the bridge is
a plain walk over the tree.  It takes numpy, e.g. ``jax.tree.map(np.asarray,
params)`` on the JAX side, and imports no JAX.  Decoder, encoder head and
ResNet backbone all move with the same two functions.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """numpy tree -> tensor tree on ``device`` (copies; keeps dtypes)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device).contiguous()


def to_numpy(tree):
    """tensor tree -> numpy tree (host copies)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
