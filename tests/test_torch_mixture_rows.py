"""The mixture CE's forward row pass as the CUDA kernel partitions it
(``csrc/chunked_ce.cu``: ``ce_rows_kernel`` with two heads, one warp a row
reading each head's row once, the CE forward's online (max, rescaled sum)
a lane and butterfly merge), emulated in tensor ops on the CPU
(``mixture_rows_partition_plain``) and held against the plain row pass
(``mixture_ce_rows_plain``) and JAX's ``_mixture_forward`` (the per-row
logsumexp of each head and the loss) at V = 8800, 8192 and a ragged 301,
with targets outside [0, V), a row of equal logits and a p_mix under the
1e-37 floor.  The emulation's geometry is held against the source's.

Tolerances: lse atol 1e-5 (values ~10, float32 sums over V terms in other
orders), p atol 1e-6, w * nll atol 1e-5 (phase 15 and
``tests/test_torch_cuda.py`` hold the kernel to the same).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops import chunked_loss as jcl
from icee_tpu_torch.ops import chunked_loss as cl

torch.set_num_threads(2)
SOURCE = (Path(cl.__file__).resolve().parents[1] / "csrc" /
          "chunked_ce.cu").read_text()
B, T, HD = 9, 8, 12          # 72 rows


def _rows(seed, v):
    """Two heads' logits (R, V), targets (R,) with one above V and one
    below 0, gates co + cn = 1, weights; row 3 of equal logits in both
    heads, and row 5's target logit far below the rest in both heads (its
    p_mix under the floor)."""
    rng = np.random.default_rng(seed)
    r = B * T
    lo, ln = (torch.tensor((3.0 * rng.standard_normal((r, v))).astype(
        np.float32)) for _ in range(2))
    lo[3] = 0.75
    ln[3] = -1.5
    tgt = torch.tensor(rng.integers(0, v, r))
    tgt[0], tgt[1] = v, -4
    lo[5, tgt[5]] = ln[5, tgt[5]] = -600.0
    co = torch.tensor(rng.uniform(0.05, 0.95, r).astype(np.float32))
    wts = torch.tensor(rng.random(r).astype(np.float32))
    return lo, ln, tgt, co, 1 - co, wts


def _close(got, want, atol, what):
    torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=what)


@pytest.mark.parametrize("v", [8800, 8192, 301])
def test_forward_partition_matches_the_plain_pass(v):
    lo, ln, tgt, co, cn, wts = _rows(v, v)
    got = cl.mixture_rows_partition_plain(lo, ln, tgt, co, cn, wts)
    want = cl.mixture_ce_rows_plain(lo, ln, tgt, co, cn, wts)
    for i, (name, atol) in enumerate((("lse_o", 1e-5), ("lse_n", 1e-5),
                                      ("p_o", 1e-6), ("p_n", 1e-6),
                                      ("w_nll", 1e-5))):
        _close(got[i], want[i], atol, name)
    lse_o, lse_n, p_o, p_n, contrib = got
    # equal logits: lse = l + log V, p = 1 / V
    assert abs(lse_o[3].item() - (0.75 + np.log(v))) <= 1e-5
    assert abs(lse_n[3].item() - (-1.5 + np.log(v))) <= 1e-5
    assert abs(p_o[3].item() - 1.0 / v) <= 1e-6
    # no target: p = exp(0 - lse); the floor: -log(1e-37) x w
    for r in (0, 1):
        assert abs(p_o[r].item() - np.exp(-lse_o[r].item())) <= 1e-6
    assert p_o[5] == 0 and p_n[5] == 0
    assert abs(contrib[5].item() - wts[5].item() * -np.log(np.float32(
        1e-37))) <= 1e-5
    assert torch.isfinite(contrib).all()
    # one float a load where V % 4 != 0 (or a head's rows are not 16-byte
    # aligned); the 16-byte path otherwise
    if v % 4 == 0:
        got1 = cl.mixture_rows_partition_plain(lo, ln, tgt, co, cn, wts,
                                               vw=1)
        _close(got1[0], want[0], 1e-5, "lse_o, one float a load")
        _close(got1[4], want[4], 1e-5, "w_nll, one float a load")


def _heads(seed, v):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    hh_o, hh_n = n(B, T, HD, scale=2.0), n(B, T, HD, scale=2.0)
    w_o, w_n = n(HD, v), n(HD, v)
    b_o, b_n = n(v, scale=0.1), n(v, scale=0.1)
    tgt = rng.integers(0, v, (B, T)).astype(np.int32)
    tgt[0, 0], tgt[0, 1] = v, -3
    b_o[tgt[2, 2]] = b_n[tgt[2, 2]] = -600.0   # a floored token
    att = rng.uniform(0.05, 0.95, (B, T)).astype(np.float32)
    wts = rng.random((B, T)).astype(np.float32)
    return hh_o, hh_n, 1 - att, att, w_o, b_o, w_n, b_n, tgt, wts


@pytest.mark.parametrize("v", [8800, 8192, 301])
def test_partition_matches_jax_mixture_forward(v):
    """Each head's per-row logsumexp and the loss of JAX's
    ``_mixture_forward`` over one chunk of all T steps."""
    hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, tgt, wts = _heads(v + 1, v)
    loss, lse_o, lse_n = jcl._mixture_forward(
        hh_o, hh_n, co, cn, w_o, b_o, w_n, b_n, jnp.asarray(tgt), wts, T)
    lo, ln = (torch.tensor(h).reshape(B * T, HD) @ torch.tensor(w)
              + torch.tensor(b)
              for h, w, b in ((hh_o, w_o, b_o), (hh_n, w_n, b_n)))
    tflat = torch.tensor(tgt.reshape(-1)).long()
    got = cl.mixture_rows_partition_plain(
        lo, ln, tflat, *(torch.tensor(a.reshape(-1)) for a in (co, cn, wts)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(lse_o).reshape(-1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(lse_n).reshape(-1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[4].sum().item(), float(loss), rtol=1e-6,
                               atol=1e-5)
    floored = co.reshape(-1) * got[2].numpy() + cn.reshape(-1) * \
        got[3].numpy() <= 1e-37
    assert floored.any()


def test_the_emulations_geometry_is_the_kernels():
    """Both heads go through the CE forward's one warp pass (the
    emulation's ``_lse_partition``), with its constants; the mixture's
    launch is the template's two-head instance, its 16-byte path only
    where both heads' rows are aligned; the first design's block-wide
    passes are gone."""
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", SOURCE))
    assert int(consts["CER_ROWS"]) == cl.CER_ROWS
    assert int(consts["CER_UNROLL"]) == cl.CER_UNROLL
    assert "template <int VW, int HEADS>" in SOURCE
    assert "warp_row<VW>(a.l[h] + (long long)row * V, nq, qy, ky, m, s," \
        in SOURCE
    assert "ce_rows_kernel<4, HEADS>" in SOURCE
    assert "ce_rows_kernel<1, HEADS>" in SOURCE
    body = SOURCE[SOURCE.index("int icee_mixture_rows("):]
    body = body[:body.index("\n}\n")]
    assert "launch_rows<2>(" in body
    assert "V % 4 == 0 && aligned16(lo) && aligned16(ln)" in body
    ce = SOURCE[SOURCE.index("int icee_ce_rows("):]
    assert "launch_rows<1>(" in ce[:ce.index("\n}\n")]
    for gone in ("row_max_sum", "block_reduce", "CE_THREADS",
                 "mixture_rows_kernel"):
        assert not re.search(r"\b%s\b" % gone, SOURCE), gone
