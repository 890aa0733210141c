"""The chunked CE's row passes as the CUDA kernels partition them
(``csrc/chunked_ce.cu``), emulated in tensor ops on the CPU:

- the forward (``ce_rows_partition_plain``): one warp a row, each lane an
  online (max, rescaled sum) over the 16-byte groups q = lane mod 32 (one
  float a load where V % 4 != 0), CER_UNROLL groups a chunk, the lanes
  merged by a butterfly of offsets 16 .. 1;
- the backward (``ce_grad_rows_partition_plain``): dl per element, each
  group of CEG_ROWS rows' column sums in row order, the groups added in
  group order into db, with ``accumulate`` on and off;

held against the plain row passes (``ce_rows_plain``,
``ce_grad_rows_plain``) and JAX's ``_weighted_ce`` (value, the per-row
logsumexp of ``_ce_forward`` and ``jax.grad`` in the head's bias, which is
the column sum of dl) at V = 8192, 8800 and a ragged 301, over rows that
span two groups, with targets outside [0, V), a row of equal logits and
the clamp binding; a -inf logit against the plain passes only (JAX's
one-hot product gives nan there: 0 x -inf).  The emulations' geometry is
held against the source's constants.

Tolerances: lse and w * nll atol 1e-5 (values ~10, float32 sums over V
terms in other orders), dl atol 1e-6, db atol 1e-5 (phase 8 and
``tests/test_torch_cuda.py`` hold the kernels to the same).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops import chunked_loss as jcl
from icee_tpu_torch.ops import chunked_loss as cl

torch.set_num_threads(2)
SOURCE = (Path(cl.__file__).resolve().parents[1] / "csrc" /
          "chunked_ce.cu").read_text()
B, T, HD = 9, 8, 12          # 72 rows: two backward groups of 64 and 8


def _rows(seed, v, scale=3.0):
    """(logits (R, V), targets (R,), weights (R,)) with a target above V,
    one below 0 and a row of equal logits."""
    rng = np.random.default_rng(seed)
    r = B * T
    logits = torch.tensor((scale * rng.standard_normal((r, v))).astype(
        np.float32))
    logits[3] = 0.75
    tgt = torch.tensor(rng.integers(0, v, r))
    tgt[0], tgt[1] = v, -4
    wts = torch.tensor(rng.random(r).astype(np.float32))
    return logits, tgt, wts


@pytest.mark.parametrize("clamp", [None, 6.0])
@pytest.mark.parametrize("v", [8192, 8800, 301])
def test_forward_partition_matches_the_plain_pass(v, clamp):
    logits, tgt, wts = _rows(v, v)
    logits[2, 11] = -torch.inf
    lse, contrib = cl.ce_rows_partition_plain(logits, tgt, wts, clamp)
    want_lse, want_c = cl.ce_rows_plain(logits, tgt, wts, clamp)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(contrib, want_c, rtol=0, atol=1e-5)
    assert torch.isfinite(lse).all()
    # equal logits: lse = l + log V
    assert abs(lse[3].item() - (0.75 + np.log(v))) <= 1e-5
    if clamp is not None:   # the clamp binds on some rows
        assert (want_lse - cl._target_logit(logits, tgt)[0] > clamp).any()
    # one float a load where V % 4 != 0 (or a row is not 16-byte
    # aligned); the 16-byte path otherwise
    if v % 4 == 0:
        lse1, _ = cl.ce_rows_partition_plain(logits, tgt, wts, clamp, vw=1)
        torch.testing.assert_close(lse1, want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("clamp", [None, 6.0])
@pytest.mark.parametrize("v", [8192, 8800, 301])
def test_backward_partition_matches_the_plain_pass(v, clamp, accumulate):
    logits, tgt, wts = _rows(v + 1, v)
    logits[5, 0] = -torch.inf
    lse, _ = cl.ce_rows_plain(logits, tgt, wts, clamp)
    g = torch.tensor(1.5)
    db = torch.full((v,), 2.0)
    dl = cl.ce_grad_rows_partition_plain(logits, tgt, wts, lse, g, db,
                                         accumulate, clamp)
    want_dl, want_db = cl.ce_grad_rows_plain(logits, tgt, wts, lse, g, clamp)
    torch.testing.assert_close(dl, want_dl, rtol=0, atol=1e-6)
    torch.testing.assert_close(db, want_db + (2.0 if accumulate else 0.0),
                               rtol=0, atol=1e-5)
    assert dl[5, 0] == 0
    if clamp is not None:   # clamped rows get no gradient
        clamped = lse - cl._target_logit(logits, tgt)[0] >= clamp
        assert clamped.any() and not dl[clamped].any()


def _head(seed, v):
    rng = np.random.default_rng(seed)
    hid = (2.0 * rng.standard_normal((B, T, HD))).astype(np.float32)
    w = rng.standard_normal((HD, v)).astype(np.float32)
    b = (0.1 * rng.standard_normal(v)).astype(np.float32)
    tgt = rng.integers(0, v, (B, T)).astype(np.int32)
    tgt[0, 0], tgt[0, 1] = v, -3
    wts = rng.random((B, T)).astype(np.float32)
    return hid, w, b, tgt, wts


@pytest.mark.parametrize("clamp", [None, 6.0])
@pytest.mark.parametrize("v", [8192, 8800, 301])
def test_partitions_match_jax_weighted_ce(v, clamp):
    """Value, per-row lse and the head bias's gradient (the column sum of
    dl) of JAX's ``_weighted_ce`` over one chunk of all T steps."""
    hid, w, b, tgt, wts = _head(v + 2, v)
    want_loss, want_lse = jcl._ce_forward(hid, w, b, jnp.asarray(tgt), wts,
                                          T, clamp)
    want_db = jax.grad(lambda bb: jcl._weighted_ce(
        hid, w, bb, jnp.asarray(tgt), wts, T, clamp))(b)
    logits = torch.tensor(hid).reshape(B * T, HD) @ torch.tensor(w) \
        + torch.tensor(b)
    tflat = torch.tensor(tgt.reshape(-1)).long()
    wflat = torch.tensor(wts.reshape(-1))
    lse, contrib = cl.ce_rows_partition_plain(logits, tflat, wflat, clamp)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(-1), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(contrib.sum().item(), float(want_loss),
                               rtol=1e-6, atol=1e-5)
    db = torch.zeros(v)
    cl.ce_grad_rows_partition_plain(logits, tflat, wflat, lse,
                                    torch.tensor(1.0), db, False, clamp)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=0,
                               atol=1e-5)
    if clamp is not None:
        tgt_logit = cl._target_logit(logits, tflat)[0]
        assert ((lse - tgt_logit) > clamp).any()


def test_the_emulations_geometry_is_the_kernels():
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", SOURCE))
    assert int(consts["CER_ROWS"]) == cl.CER_ROWS
    assert int(consts["CER_UNROLL"]) == cl.CER_UNROLL
    assert "constexpr int CER_THREADS = 32 * CER_ROWS;" in SOURCE
    assert int(consts["CEG_THREADS"]) == cl.CEG_THREADS
    assert int(consts["CEG_ROWS"]) == cl.CEG_ROWS
    assert int(consts["CEG_UNROLL"]) == cl.CEG_UNROLL
    # the butterfly's offsets and the workspace: groups x V partials + R
    assert "for (int off = 16; off > 0; off >>= 1)" in SOURCE
    assert "return groups * V + R;" in SOURCE
    # no pass of gemm_f32.cuh's colsum over the chunk
    assert not re.search(r"\bcolsum\(", SOURCE)


@pytest.mark.parametrize("fn", ["icee_ce_rows", "icee_ce_grad_ws",
                                "icee_ce_grad_rows", "icee_mixture_rows"])
def test_the_ctypes_signatures_match_the_entry_points(fn, monkeypatch):
    from icee_tpu_torch.ops import cuda_lib

    declared = {}

    def fake_library(name, signatures):
        declared.update(signatures)
        raise RuntimeError("stop")

    monkeypatch.setattr(cuda_lib, "library", fake_library)
    with pytest.raises(RuntimeError, match="stop"):
        cl._library()
    sig = re.search(r"\b%s\((.*?)\)\s*\{" % fn, SOURCE, re.S).group(1)
    assert len(declared[fn][0]) == len([p for p in sig.split(",")
                                        if p.strip()])
