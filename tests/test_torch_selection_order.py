"""The order of the wide selection's survivors (``csrc/wide_topk.cuh``),
without JAX: above ``K_WIDE`` = 256 the kernels sort the K survivors in
shared memory (``block_sort_pairs``, a bitonic sort) where they fit, and a
grid's wide tail spreads an image's k x k candidates over several blocks
(``csrc/grid_beam.cuh`` ``spread_select``: each block's histogram of its
share, the histograms added in part order, the survivors gathered share by
share).  The CPU models of both (``decode_step.bitonic_sort_plain``,
``decode_step.block_select_plain(order="sort", parts=...)``) must give
exactly the order of the rank count (the survivors are distinct (key,
index) pairs) and of a stable sort of the values, ties to the lowest
index, -0 as +0.  Also: the dry run defaults to the card."""

import inspect

import numpy as np
import pytest
import torch

from icee_tpu_torch.ops import decode_step
from icee_tpu_torch.parallel import dryrun


def _stable_order(v: torch.Tensor, k: int) -> np.ndarray:
    """Indices of the k greatest of each row, ties to the lowest index (-0
    and +0 equal)."""
    a = v.numpy().astype(np.float64) + 0.0
    return np.stack([np.lexsort((np.arange(a.shape[1]), -row))[:k]
                     for row in a])


def _rows(seed: int, n: int, kind: str) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "ties":            # few distinct values: long plateaus
        v = rng.integers(-4, 5, (2, n)).astype(np.float32)
    elif kind == "zeros":         # -0 and +0 among them
        v = rng.integers(-1, 2, (2, n)).astype(np.float32)
        v[v == 0] = np.where(rng.random((v == 0).sum()) < 0.5, -0.0, 0.0)
    else:                         # log-probs, a few copied: ties too
        v = rng.standard_normal((2, n)).astype(np.float32) - 9.0
        v[:, 1::97] = v[:, ::97][:, :v[:, 1::97].shape[1]]
    return torch.from_numpy(v)


@pytest.mark.parametrize("k", [257, 300, 512, 1000, 2048, 4096])
@pytest.mark.parametrize("kind", ["ties", "zeros", "logp"])
def test_the_sorted_selection_is_the_rank_count(k, kind):
    v = _rows(k, 5000 if k < 4096 else 9000, kind)
    keys = decode_step.desc_keys(v)
    ranked = decode_step.block_select_plain(keys, k)
    sorted_ = decode_step.block_select_plain(keys, k, "sort")
    assert torch.equal(ranked, sorted_)
    np.testing.assert_array_equal(sorted_.numpy(), _stable_order(v, k))


@pytest.mark.parametrize("parts", [2, 7, 44, 132])
@pytest.mark.parametrize("k", [257, 300, 2048])
def test_a_spread_selection_is_the_one_block_selection(parts, k):
    """An image's candidates cut into ``parts`` contiguous shares, each
    share's histogram counted alone and the counts added in part order:
    the same threshold, the same survivors, the same order."""
    v = _rows(parts + k, 6000, "ties")
    keys = decode_step.desc_keys(v)
    one = decode_step.block_select_plain(keys, k)
    spread = decode_step.block_select_plain(keys, k, "sort", parts=parts)
    assert torch.equal(one, spread)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 31, 256, 257, 1000])
def test_the_bitonic_network_sorts_any_count(n):
    rng = np.random.default_rng(n)
    pairs = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
    pairs[: n // 3] = pairs[0]          # repeats: pads and ties sort too
    np.testing.assert_array_equal(decode_step.bitonic_sort_plain(pairs),
                                  np.sort(pairs))


def test_desc_keys_order_values_descending_and_merge_zeros():
    v = torch.tensor([1.5, -0.0, 0.0, -2.0, float("inf"), -float("inf"),
                      3e-38, -3e-38])
    keys = decode_step.desc_keys(v)
    assert keys[1] == keys[2]
    order = torch.argsort(keys, stable=True)
    assert order.tolist() == [4, 0, 6, 1, 2, 7, 3, 5]


def test_the_dry_run_runs_on_the_card_unless_told_otherwise():
    """``python -m icee_tpu_torch.parallel.dryrun N`` and
    ``dryrun_multichip(n)`` run on the card by default; ``--device cpu``
    (or ``device="cpu"``) asks for the CPU."""
    sig = inspect.signature(dryrun.dryrun_multichip)
    assert sig.parameters["device"].default == "cuda"
    src = inspect.getsource(dryrun.main)
    assert 'p.add_argument("--device", default="cuda"' in src
