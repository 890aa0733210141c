"""The CUDA kernels K1 and K2 against their plain PyTorch versions, on the
card, at small shapes that ``chip_smoke.py``'s flagship run does not reach:
a ragged vocab, an input width that is not a multiple of 4, F != H, row
counts that do not fill a block, several images per K2 block with batch
padding, research mode, early termination and all-tied logits.

These tests need an NVIDIA GPU and skip elsewhere (marker ``cuda``).  On a
host with the card, and without JAX, run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 on both sides, summed in other orders, so values to
atol 1e-4 and ids exact; where the logits tie exactly (a zero head) ids
and tokens are exact by construction.  The two decode paths share their
device functions and must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from icee_tpu_torch import bridge
from icee_tpu_torch.decode.fast import factored_decode
from icee_tpu_torch.ops.beam import mega_beam_decode, mega_beam_decode_plain
from icee_tpu_torch.ops.decode_step import (decode_step_topk,
                                            decode_step_topk_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(device, vocab, e, f, h, seed=0, zero_head=False, end_bias=None):
    """Random decoder weights in the JAX layout, made with numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"B": w(vocab, e), "V_w": w(e, 4 * f), "V_b": w(4, f, scale=0.1),
         "S_w": w(4, 4, f, f, scale=0.2), "S_b": w(4, 4, f, scale=0.1),
         "U_w": w(4, f, h, scale=0.2), "U_b": w(4, h, scale=0.1),
         "W_w": w(h, 4 * h, scale=0.2), "W_b": w(4, h, scale=0.1),
         "C_w": w(h, vocab, scale=1.0), "C_b": w(vocab, scale=0.1)}
    if zero_head:
        p["C_w"][:] = 0.0
        p["C_b"][:] = 0.0
    if end_bias is not None:
        p["C_b"][2] = end_bias
    return bridge.to_torch(p, device=device)


@pytest.mark.parametrize("rows,vocab,e,f,h,ktop", [
    (13, 520, 30, 48, 64, 5),     # ragged vocab, E % 4 != 0, F != H
    (40, 1024, 300, 64, 32, 8),   # rows over several blocks, k = KMAX
    (3, 260, 16, 32, 32, 1),      # one vocab column in the last tile
])
def test_decode_step_kernel_matches_plain(device, rows, vocab, e, f, h, ktop):
    params = _params(device, vocab, e, f, h, seed=rows)
    g = torch.Generator(device=device).manual_seed(rows)
    x, hh, c = (torch.randn((rows, d), generator=g, device=device)
                for d in (e, h, h))
    before = decode_step_topk.launches
    got = decode_step_topk(params, x, hh, c, 2, ktop=ktop)
    want = decode_step_topk_plain(params, x, hh, c, 2, ktop=ktop)
    torch.cuda.synchronize()
    assert decode_step_topk.launches == before + 1
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    for g_, w_ in (got[0], want[0]), (got[2], want[2]), (got[3], want[3]):
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-4)


def test_decode_step_kernel_ties_go_to_the_lowest_ids(device):
    params = _params(device, 768, 20, 32, 32, zero_head=True)
    x = torch.randn((9, 20), device=device)
    h = torch.zeros((9, 32), device=device)
    logp, idx, _, _ = decode_step_topk(params, x, h, h, 0, ktop=5)
    torch.cuda.synchronize()
    assert idx.tolist() == [list(range(5))] * 9
    torch.testing.assert_close(logp, torch.full_like(logp, -np.log(768.0)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["serving", "research", "early_end",
                                  "tied", "one_beam"])
def test_mega_kernel_matches_plain_and_fused_step(device, case):
    vocab, e, f, h = 516, 30, 40, 48
    k, batch, steps = (1, 7, 9) if case == "one_beam" else (4, 5, 9)
    params = _params(device, vocab, e, f, h, seed=7,
                     zero_head=case == "tied",
                     end_bias=50.0 if case == "early_end" else 1.0)
    feats = None
    if case != "research":
        g = torch.Generator(device=device).manual_seed(1)
        feats = torch.randn((batch, 1, e), generator=g, device=device)
        feats = feats.expand(batch, k, e).contiguous()
    before = mega_beam_decode.launches
    got = mega_beam_decode(params, feats, 3, batch, k=k,
                           max_seq_length=steps)
    torch.cuda.synchronize()
    assert mega_beam_decode.launches == before + 1
    want = mega_beam_decode_plain(params, feats, 3, batch, k=k,
                                  max_seq_length=steps)
    torch.testing.assert_close(got.tokens, want.tokens, rtol=0, atol=0)
    torch.testing.assert_close(got.length, want.length, rtol=0, atol=0)
    torch.testing.assert_close(got.score, want.score, rtol=0, atol=1e-4)
    # the serial serving path (K1 in the Python beam) is bit-identical
    fused = factored_decode("fused-step", params, feats, 3, batch, k, steps,
                            1, 2)
    torch.testing.assert_close(fused.tokens, got.tokens, rtol=0, atol=0)
    torch.testing.assert_close(fused.length, got.length, rtol=0, atol=0)
    torch.testing.assert_close(fused.score, got.score, rtol=0, atol=0)
    if case == "early_end":
        assert got.length.tolist() == [2] * batch


def test_wrappers_raise_on_what_the_kernels_do_not_take(device):
    params = _params(device, 130, 16, 32, 32)   # V % 4 != 0
    x = torch.zeros((5, 16), device=device)
    h = torch.zeros((5, 32), device=device)
    with pytest.raises(ValueError, match="multiples of 4"):
        decode_step_topk(params, x, h, h, 0)
    with pytest.raises(ValueError, match="multiples of 4"):
        mega_beam_decode(params, None, 0, 2, k=4)
    params = _params(device, 128, 16, 32, 32)
    with pytest.raises(ValueError, match="expected cpu"):
        decode_step_topk(params, x.cpu(), h, h, 0)
