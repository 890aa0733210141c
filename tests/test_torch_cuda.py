"""The CUDA kernels against their plain PyTorch versions, on the card, at
small shapes that ``chip_smoke.py``'s flagship run does not reach.  K1 and
K2: a ragged vocab, an input width that is not a multiple of 4, F != H, row
counts that do not fill a block, several images per K2 block with batch
padding, research mode, early termination and all-tied logits.  K3 (the
training scan): B = 3, T = 1, E % 4 != 0, F != H, a style other than 0 with
zero grads on the other slices, and the same bits on a second run.  The
chunked CE's row passes: V % 4 != 0, a target outside the vocabulary, the
clamp, and the whole loss on the card against the CPU.

These tests need an NVIDIA GPU and skip elsewhere (marker ``cuda``).  On a
host with the card, and without JAX, run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: float32 on both sides, summed in other orders, so values to
atol 1e-4 (K3 grads: 1e-3 x the largest magnitude, sums over B*T rows)
and ids exact; where the logits tie exactly (a zero head) ids
and tokens are exact by construction.  The two decode paths share their
device functions and must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from icee_tpu_torch import bridge
from icee_tpu_torch.decode.fast import factored_decode
from icee_tpu_torch.ops import chunked_loss, lstm_scan
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


# --- training kernels: K3 (lstm_scan.cu) and the chunked CE (chunked_ce.cu) --

def _cell_params(device, e, f, h, styles=4, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.2):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return bridge.to_torch({
        "V_w": w(e, 4 * f), "V_b": w(4, f, scale=0.1),
        "S_w": w(styles, 4, f, f), "S_b": w(styles, 4, f, scale=0.1),
        "U_w": w(4, f, h), "U_b": w(4, h, scale=0.1),
        "W_w": w(h, 4 * h), "W_b": w(4, h, scale=0.1)}, device=device)


def _slice(full, style):
    p = {k: full[k] for k in lstm_scan.CELL_KEYS}
    p["S_w"], p["S_b"] = full["S_w"][style], full["S_b"][style]
    return p


def _close_scaled(got, want, rel=1e-3):
    """Max-abs error within rel x the largest magnitude of the reference
    (float32 sums over B*T rows in other orders)."""
    bound = rel * max(want.abs().max().item(), 1e-6)
    err = (got - want).abs().max().item()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("b,t,e,f,h,style", [
    (3, 4, 30, 48, 64, 2),     # B not a multiple of 8, E % 4 != 0, F != H
    (9, 1, 16, 32, 32, 0),     # T = 1
    (40, 7, 20, 40, 24, 3),    # F > H, rows over two step blocks
])
def test_lstm_scan_kernels_match_plain(device, b, t, e, f, h, style):
    full = _cell_params(device, e, f, h, seed=b)
    p = _slice(full, style)
    g = torch.Generator(device=device).manual_seed(t)
    x = torch.randn((b, t, e), generator=g, device=device)
    dh = torch.randn((b, t, h), generator=g, device=device)
    before = (lstm_scan.factored_scan_fwd.launches,
              lstm_scan.factored_scan_bwd.launches)
    h_seq, c_seq, saved = lstm_scan.factored_scan_fwd(p, x)
    want_h, want_c = lstm_scan.fused_factored_scan_plain(p, x)
    torch.testing.assert_close(h_seq, want_h, rtol=0, atol=1e-4)
    torch.testing.assert_close(c_seq, want_c, rtol=0, atol=1e-4)
    dx, grads = lstm_scan.factored_scan_bwd(p, x, h_seq, c_seq, dh, saved)
    want_dx, want_grads = lstm_scan.factored_scan_bwd_plain(p, x, h_seq,
                                                            c_seq, dh)
    torch.cuda.synchronize()
    assert (lstm_scan.factored_scan_fwd.launches,
            lstm_scan.factored_scan_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    _close_scaled(dx, want_dx)
    for k in lstm_scan.CELL_KEYS:
        _close_scaled(grads[k], want_grads[k])
    # the same bits on a second run: no atomics anywhere
    dx2, grads2 = lstm_scan.factored_scan_bwd(p, x, h_seq, c_seq, dh, saved)
    assert torch.equal(dx, dx2) and all(torch.equal(grads[k], grads2[k])
                                        for k in lstm_scan.CELL_KEYS)


def test_lstm_scan_autograd_scatters_the_style_slice(device):
    full = {k: v.requires_grad_(True)
            for k, v in _cell_params(device, 12, 16, 20).items()}
    x = torch.randn((5, 3, 12), device=device, requires_grad=True)
    (lstm_scan.fused_factored_scan(_slice(full, 1), x) ** 2).sum().backward()
    torch.cuda.synchronize()
    for name in ("S_w", "S_b"):
        g = full[name].grad
        assert torch.count_nonzero(g[1]) > 0
        assert torch.count_nonzero(g[[0, 2, 3]]) == 0
    assert torch.count_nonzero(x.grad) > 0


@pytest.mark.parametrize("rows,vocab,clamp", [
    (7, 37, None),        # V % 4 != 0: the scalar path
    (33, 1024, 2.0),      # the clamp bites on some rows
    (1, 8192, None),
])
def test_ce_row_kernels_match_plain(device, rows, vocab, clamp):
    g = torch.Generator(device=device).manual_seed(rows)
    logits = 3.0 * torch.randn((rows, vocab), generator=g, device=device)
    tgt = torch.randint(0, vocab, (rows,), generator=g, device=device)
    tgt[0] = vocab                                   # no one-hot entry
    wts = torch.rand((rows,), generator=g, device=device)
    lse, contrib = chunked_loss.ce_rows(logits, tgt, wts, clamp)
    want_lse, want_c = chunked_loss.ce_rows_plain(logits, tgt, wts, clamp)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(contrib, want_c, rtol=0, atol=1e-5)
    gup = torch.tensor([1.5], device=device)
    db = torch.ones((vocab,), device=device)
    dl = chunked_loss.ce_grad_rows(logits.clone(), tgt, wts, lse, gup, db,
                                   clamp)
    want_dl, want_db = chunked_loss.ce_grad_rows_plain(
        logits, tgt, wts, lse, gup.reshape(()), clamp)
    torch.cuda.synchronize()
    torch.testing.assert_close(dl, want_dl, rtol=0, atol=1e-6)
    torch.testing.assert_close(db, 1.0 + want_db, rtol=0, atol=1e-5)


@pytest.mark.parametrize("t_chunk", [None, 4])
def test_chunked_ce_on_the_card_matches_the_cpu(device, t_chunk):
    rng = np.random.default_rng(2)
    hid = rng.standard_normal((6, 9, 16)).astype(np.float32)
    w = (0.5 * rng.standard_normal((16, 52))).astype(np.float32)
    b = (0.1 * rng.standard_normal((52,))).astype(np.float32)
    tgt = rng.integers(0, 52, (6, 9))
    lens = np.array([9, 0, 3, 8, 5, 9])
    smask = np.array([True, True, False, True, True, True])
    out = {}
    for dev in ("cpu", device):
        th, tw, tb = (torch.tensor(a, device=dev, requires_grad=True)
                      for a in (hid, w, b))
        loss = chunked_loss.masked_ce_from_hiddens(
            th, tw, tb, torch.tensor(tgt, device=dev),
            torch.tensor(lens, device=dev), torch.tensor(smask, device=dev),
            t_chunk)
        loss.backward()
        out[str(dev)] = [a.detach().cpu() for a in (loss, th.grad, tw.grad,
                                                    tb.grad)]
    for got, want in zip(out[str(device)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_training_wrappers_raise_on_what_the_kernels_do_not_take(device):
    p = _slice(_cell_params(device, 8, 8, 8), 0)
    x = torch.zeros((2, 3, 8), device=device)
    h_seq, c_seq, _ = lstm_scan.factored_scan_fwd(p, x)
    with pytest.raises(ValueError, match="saved"):
        lstm_scan.factored_scan_bwd(p, x, h_seq, c_seq, h_seq)
    with pytest.raises(ValueError, match="expected"):
        lstm_scan.factored_scan_fwd(p, x.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_scan.factored_scan_fwd(p, x.transpose(0, 1).contiguous()
                                    .transpose(0, 1))
    logits = torch.zeros((4, 8), device=device)
    with pytest.raises(ValueError, match="expected"):
        chunked_loss.ce_rows(logits, torch.zeros(4, dtype=torch.long),
                             torch.ones(4, device=device))
