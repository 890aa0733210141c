"""The CUDA kernels against their plain PyTorch versions, on the card, at
small shapes that ``chip_smoke.py``'s flagship run does not reach.  K1 and
K2: a ragged vocab, an input width that is not a multiple of 4, F != H, row
counts that do not fill a block, several images per K2 search with batch
padding, research mode, early termination and all-tied logits.  K3 (the
training scan): B = 1, 3 and 130 (three 64-row passes), T = 1 and 25,
E % 4 != 0, F != H, H that the recurrence's unit groups do not divide, a
style other than 0 with zero grads on the other slices, and the same bits
on a second run; every product K3 and K8 run over all rows alone at the
main path's shapes against float64 (at most 4x gemm_f32.cuh's error, the
same bits twice) and at ragged shapes against its emulation; a hidden
width no recurrence plan fits refused by name.  The
chunked CE's row passes: V % 4 != 0, a target outside the vocabulary, the
clamp, and the whole loss on the card against the CPU; the one-read
forward and the slab x row-group backward against the emulation of their
partition at V = 8192, 8800 and a ragged V, rows not 16-byte aligned, a
-inf logit, a row of equal logits, the same bits twice.  K4 (the NIC
training scan): T = 1, B not a multiple of 8, E % 4 != 0, the shared bias
grad, and the same bits on a second run; at flagship width against its
3xTF32 emulation; H = 1024 refused by name.  K2 with the LSTM cell: both
feature modes, batch padding and an early end; the whole-card search at
1, 8 and 64 images, k = 1 and 8, images ending at widely different steps,
the same bits on a second run and on a 3-block grid.  K6 and K7 (the attention
step and search), both cells: E % 4 != 0, F != H, P % 4 != 0, a ragged
vocab, k below a full block, the h0/c0 kernel, and the serial path (K6 per
step) bit-identical to K7; K7 as one search over the whole card at 1, 3, 8
and 64 images and k = 1, 5 and 8, the same bits on a second run and on a
3-block grid.  Every wrapper refuses k above the kernels' K_MAX = 8 on a
CUDA tensor (the CPU route takes any k).  K5 (the attention training scan), both cells,
teacher-forced and sampled: E % 4 != 0, F != H, P = 9 and 196, T = 1, the
same bits on a second run, and the attention train steps on the card
against the CPU; K5's tensor-core product (``gemm_tf32x3.cuh``) in each
form against float64 (at most 4x the CUDA-core product's error), its
emulation, ragged, padded, batched and split shapes, the same bits twice.  K8 and K9 (the SentiCap scan and base beam search) and
K10 (the switched beam search): a ragged vocabulary, E != H, K8 at B = 1,
130 and 129 (H = 528: the forward's blocks take 192 rows), gclip 0.01 where
the clamp binds, one image at beam 20, all-tied and saturated heads, the trace, beam 1; their products alone
(3xTF32 by wgmma from pre-split planes) against float64 at the decode's
shapes and ragged ones, at both tile widths, and their row
selection against its plain emulation; the mixture CE's value
and every gradient, the same bits twice; the switched step on the card
against the CPU.

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
from icee_tpu_torch.decode.fast import (attention_decode, factored_decode,
                                        nic_att_decode)
from icee_tpu_torch.ops import chunked_loss, lstm_scan, nic_scan
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.ops import att_beam, att_decode_step, att_scan
from icee_tpu_torch.core.config import AttentionDecoderConfig, TrainConfig
from icee_tpu_torch.train import optim
from icee_tpu_torch.train.steps import make_attention_steps
from icee_tpu_torch.ops.beam import (max_grid, mega_beam_decode,
                                     mega_beam_decode_plain,
                                     mega_beam_decode_steps)
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
                                  "tied", "one_beam", "one_image"])
def test_mega_kernel_matches_plain_and_fused_step(device, case):
    # one_image: the serial serving shape, K1's column-split path
    vocab, e, f, h = 516, 30, 40, 48
    k, batch, steps = {"one_beam": (1, 7, 9),
                       "one_image": (4, 1, 9)}.get(case, (4, 5, 9))
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
    split = decode_step_topk.split_launches
    fused = factored_decode("fused-step", params, feats, 3, batch, k, steps,
                            1, 2)
    if batch * k <= 8:
        assert decode_step_topk.split_launches > split
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
    # above K_MAX the CPU route decodes; the kernels refuse, naming it
    with pytest.raises(ValueError, match="K1 .*K_MAX = 8"):
        decode_step_topk(params, x, h, h, 0, ktop=9)
    with pytest.raises(ValueError, match="K2 .*K_MAX = 8"):
        mega_beam_decode(params, None, 0, 2, k=9)
    with pytest.raises(ValueError, match="K2 .*K_MAX = 8"):
        mega_beam_decode(_nic_params(device, 128, 16, 32), None, 0, 2, k=9,
                         cell="lstm")


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
    (40, 7, 20, 40, 24, 3),    # F > H, a backward unit group half full
    (1, 6, 8, 16, 36, 1),      # B = 1; H = 36: 9 forward unit groups,
                               # the last backward group a quarter full
    (3, 25, 12, 24, 44, 2),    # T = 25 at small width, H % 8 != 0
    (130, 3, 20, 32, 32, 0),   # three 64-row passes
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


@pytest.mark.parametrize("rows,vocab,clamp,offset", [
    (1600, 8192, None, 0),   # StyleNet / NIC factual chunk
    (96, 8800, 8.0, 0),      # SentiCap's vocabulary, the clamp
    (45, 301, 2.0, 0),       # a ragged V: one float a load
    (33, 1024, None, 1),     # rows not 16-byte aligned: one float a load
])
def test_ce_row_kernels_read_a_row_once_and_keep_their_bits(
        device, rows, vocab, clamp, offset):
    """The one-read forward and the slab x row-group backward against their
    plain versions and the emulation of their partition
    (``ce_rows_partition_plain``, ``ce_grad_rows_partition_plain``), with
    a -inf logit, a row of equal logits, targets outside [0, V) and the
    same bits on a second run."""
    g = torch.Generator(device=device).manual_seed(rows + vocab)
    buf = torch.empty(rows * vocab + offset, device=device)
    logits = buf[offset:].view(rows, vocab)
    logits.copy_(3.0 * torch.randn((rows, vocab), generator=g,
                                   device=device))
    logits[2, 7] = -torch.inf
    logits[3] = 0.25
    tgt = torch.randint(0, vocab, (rows,), generator=g, device=device)
    tgt[0], tgt[1] = vocab, -1
    wts = torch.rand((rows,), generator=g, device=device)
    lse, contrib = chunked_loss.ce_rows(logits, tgt, wts, clamp)
    lse2, contrib2 = chunked_loss.ce_rows(logits, tgt, wts, clamp)
    want_lse, want_c = chunked_loss.ce_rows_plain(logits, tgt, wts, clamp)
    emu_lse, emu_c = chunked_loss.ce_rows_partition_plain(logits, tgt, wts,
                                                          clamp)
    for want in (want_lse, emu_lse):
        torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(contrib, want_c, rtol=0, atol=1e-5)
    torch.testing.assert_close(contrib, emu_c, rtol=0, atol=1e-5)
    gup = torch.tensor([1.5], device=device)
    db = torch.ones((vocab,), device=device)
    db2 = torch.ones((vocab,), device=device)
    before = chunked_loss.ce_grad_rows.launches
    dl = chunked_loss.ce_grad_rows(logits.clone(), tgt, wts, lse, gup, db,
                                   clamp)
    dl2 = chunked_loss.ce_grad_rows(logits.clone(), tgt, wts, lse, gup, db2,
                                    clamp)
    want_dl, want_db = chunked_loss.ce_grad_rows_plain(
        logits, tgt, wts, lse, gup.reshape(()), clamp)
    emu_db = torch.ones((vocab,), device=device)
    chunked_loss.ce_grad_rows_partition_plain(logits, tgt, wts, lse,
                                              gup.reshape(()), emu_db, True,
                                              clamp)
    torch.cuda.synchronize()
    assert chunked_loss.ce_grad_rows.launches == before + 2
    torch.testing.assert_close(dl, want_dl, rtol=0, atol=1e-6)
    torch.testing.assert_close(db, 1.0 + want_db, rtol=0, atol=1e-5)
    torch.testing.assert_close(db, emu_db, rtol=0, atol=1e-5)
    assert torch.isfinite(lse).all() and dl[2, 7] == 0
    for a, b in ((lse, lse2), (contrib, contrib2), (dl, dl2), (db, db2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows,vocab,offset", [
    (1408, 8800, 0),   # the switch step's chunk: 11 steps x 128
    (45, 301, 0),      # a ragged V: one float a load
    (33, 1024, 1),     # one head's rows not 16-byte aligned
])
def test_mixture_rows_kernel_reads_each_head_once_and_keeps_its_bits(
        device, rows, vocab, offset):
    """The mixture forward (the CE forward's warp pass over both heads)
    against its plain version and the emulation of its partition
    (``mixture_rows_partition_plain``), with targets outside [0, V), a row
    of equal logits, a floored p_mix and the same bits on a second run."""
    g = torch.Generator(device=device).manual_seed(rows + vocab)
    lo = 3.0 * torch.randn((rows, vocab), generator=g, device=device)
    buf = torch.empty(rows * vocab + offset, device=device)
    ln = buf[offset:].view(rows, vocab)
    ln.copy_(3.0 * torch.randn((rows, vocab), generator=g, device=device))
    lo[3] = ln[3] = 0.25
    tgt = torch.randint(0, vocab, (rows,), generator=g, device=device)
    tgt[0], tgt[1] = vocab, -1
    lo[5, tgt[5]] = ln[5, tgt[5]] = -600.0
    co = torch.rand((rows,), generator=g, device=device)
    cn = 1.0 - co
    wts = torch.rand((rows,), generator=g, device=device)
    before = chunked_loss.mixture_ce_rows.launches
    got = chunked_loss.mixture_ce_rows(lo, ln, tgt, co, cn, wts)
    again = chunked_loss.mixture_ce_rows(lo, ln, tgt, co, cn, wts)
    want = chunked_loss.mixture_ce_rows_plain(lo, ln, tgt, co, cn, wts)
    emu = chunked_loss.mixture_rows_partition_plain(lo, ln, tgt, co, cn, wts)
    torch.cuda.synchronize()
    assert chunked_loss.mixture_ce_rows.launches == before + 2
    for ref in (want, emu):
        for i, atol in enumerate((1e-5, 1e-5, 1e-6, 1e-6, 1e-5)):
            torch.testing.assert_close(got[i], ref[i], rtol=0, atol=atol)
    assert got[2][5] == 0 and got[3][5] == 0
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("t_chunk", [None, 4])
def test_chunked_ce_on_the_card_matches_the_cpu(device, t_chunk):
    """The chunked loss on the card against the CPU's float64 loss and
    grads of the same float32 inputs (log-softmax and autograd in float64),
    to atol 1e-6.  The float32 CPU path is not the reference: on the chip
    machine it gave a loss 13 ulps (6.2e-6) off, in one fresh test process
    in three to twelve, while the card's bits never moved
    (``scripts/probe_ce_reference.py``)."""
    rng = np.random.default_rng(2)
    hid = rng.standard_normal((6, 9, 16)).astype(np.float32)
    w = (0.5 * rng.standard_normal((16, 52))).astype(np.float32)
    b = (0.1 * rng.standard_normal((52,))).astype(np.float32)
    tgt = rng.integers(0, 52, (6, 9))
    lens = np.array([9, 0, 3, 8, 5, 9])
    smask = np.array([True, True, False, True, True, True])
    out = []
    for dev, dtype in (("cpu", torch.float64), (device, torch.float32)):
        th, tw, tb = (torch.tensor(a, device=dev, dtype=dtype,
                                   requires_grad=True) for a in (hid, w, b))
        targets, lengths, mask = (torch.tensor(a, device=dev)
                                  for a in (tgt, lens, smask))
        if dtype == torch.float64:
            valid = (torch.arange(9)[None, :] < lengths[:, None]) & \
                mask[:, None]
            logp = torch.log_softmax(th @ tw + tb, dim=-1)
            nll = -logp.gather(-1, targets[..., None])[..., 0]
            loss = (nll * valid / valid.sum()).sum()
        else:
            loss = chunked_loss.masked_ce_from_hiddens(
                th, tw, tb, targets, lengths, mask, t_chunk)
        loss.backward()
        out.append([a.detach().cpu().double() for a in (loss, th.grad,
                                                         tw.grad, tb.grad)])
    for want, got in zip(*out):
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


# --- NIC kernels: K4 (nic_scan.cu) and K2 with the LSTM cell (beam.cu) -------

def _nic_params(device, vocab, e, h, seed=0, end_bias=1.0):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"embed": w(vocab, e),
         "cell": {"W_ih": w(e, 4 * h), "W_hh": w(h, 4 * h),
                  "b_ih": w(4 * h, scale=0.1), "b_hh": w(4 * h, scale=0.1)},
         "linear_w": w(h, vocab, scale=1.0), "linear_b": w(vocab, scale=0.1)}
    p["linear_b"][2] = end_bias
    return bridge.to_torch(p, device=device)


@pytest.mark.parametrize("b,t,e,h", [
    (5, 1, 30, 64),      # T = 1, B not a multiple of 8, E % 4 != 0
    (37, 9, 40, 48),     # rows over two step blocks, H not a multiple of 8
])
def test_nic_scan_kernels_match_plain(device, b, t, e, h):
    cell = _nic_params(device, 8, e, h, seed=b)["cell"]
    g = torch.Generator(device=device).manual_seed(t)
    x = torch.randn((b, t, e), generator=g, device=device)
    dh = torch.randn((b, t, h), generator=g, device=device)
    before = (nic_scan.nic_scan_fwd.launches, nic_scan.nic_scan_bwd.launches)
    h_seq, c_seq, gates = nic_scan.nic_scan_fwd(cell, x)
    want_h, want_c = nic_scan.fused_nic_scan_plain(cell, x)
    torch.testing.assert_close(h_seq, want_h, rtol=0, atol=1e-4)
    torch.testing.assert_close(c_seq, want_c, rtol=0, atol=1e-4)
    dx, grads = nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq, dh, gates)
    want_dx, want_grads = nic_scan.nic_scan_bwd_plain(cell, x, h_seq, c_seq,
                                                      dh)
    torch.cuda.synchronize()
    assert (nic_scan.nic_scan_fwd.launches,
            nic_scan.nic_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    _close_scaled(dx, want_dx)
    for k in nic_scan.CELL_KEYS:
        _close_scaled(grads[k], want_grads[k])
    assert torch.equal(grads["b_ih"], grads["b_hh"])
    # the same bits on a second run: no atomics anywhere
    h2, c2, gates2 = nic_scan.nic_scan_fwd(cell, x)
    dx2, grads2 = nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq, dh, gates)
    assert torch.equal(h_seq, h2) and torch.equal(c_seq, c2)
    assert torch.equal(dx, dx2) and all(torch.equal(grads[k], grads2[k])
                                        for k in nic_scan.CELL_KEYS)


def test_nic_scan_kernels_match_their_arithmetic_at_flagship_width(device):
    """K4 at the main path's B 64, T 25, E 300, H 512 against
    ``scan_grid.nic_scan_tc_plain`` / ``nic_scan_bwd_tc_plain`` (the
    kernels' own products and order of sums, 3xTF32): h and c within
    1e-5, each grad within 1e-4 of its largest magnitude (only expf and
    tanhf, and the products' tile order, differ), and one recurrence
    launch a direction."""
    from icee_tpu_torch.ops import scan_grid

    b, t, e, h = 64, 25, 300, 512
    cell = _nic_params(device, 8, e, h, seed=3)["cell"]
    cell["W_hh"] = cell["W_hh"] * (3.0 / h ** 0.5)
    g = torch.Generator(device=device).manual_seed(4)
    x = 0.5 * torch.randn((b, t, e), generator=g, device=device)
    dh = 0.02 * torch.randn((b, t, h), generator=g, device=device)
    h_seq, c_seq, gates = nic_scan.nic_scan_fwd(cell, x)
    want_h, want_c, acts = scan_grid.nic_scan_tc_plain(cell, x)
    torch.testing.assert_close(h_seq, want_h, rtol=0, atol=1e-5)
    torch.testing.assert_close(c_seq, want_c, rtol=0, atol=1e-5)
    torch.testing.assert_close(gates.view(b, t, 4, h), acts, rtol=0,
                               atol=1e-5)
    dx, grads = nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq, dh, gates)
    plan = scan_grid.plan_on("K4", b, h, device)
    want_dx, want_g = scan_grid.nic_scan_bwd_tc_plain(
        cell, x, h_seq, c_seq, dh, gates.view(b, t, 4, h), plan)
    torch.cuda.synchronize()
    _close_scaled(dx, want_dx, 1e-4)
    for k in nic_scan.CELL_KEYS:
        _close_scaled(grads[k], want_g[k], 1e-4)


def test_nic_scan_autograd_returns_the_shared_bias_grad(device):
    cell = {k: v.requires_grad_(True)
            for k, v in _nic_params(device, 8, 12, 16)["cell"].items()}
    x = torch.randn((6, 4, 12), device=device, requires_grad=True)
    (nic_scan.fused_nic_scan(cell, x) ** 2).sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(cell["b_ih"].grad, cell["b_hh"].grad)
    assert torch.count_nonzero(cell["W_hh"].grad) > 0
    assert torch.count_nonzero(x.grad) > 0


@pytest.mark.parametrize("case", ["serving", "research", "early_end"])
def test_mega_kernel_lstm_cell_matches_plain(device, case):
    vocab, e, h, k, batch, steps = 516, 30, 48, 4, 5, 9
    params = _nic_params(device, vocab, e, h, seed=9,
                         end_bias=50.0 if case == "early_end" else 1.0)
    feats = None
    if case != "research":
        g = torch.Generator(device=device).manual_seed(2)
        feats = torch.randn((batch, 1, e), generator=g, device=device)
        feats = feats.expand(batch, k, e).contiguous()
    before = (mega_beam_decode.launches, mega_beam_decode.lstm_launches)
    got = mega_beam_decode(params, feats, 0, batch, k=k, max_seq_length=steps,
                           cell="lstm")
    torch.cuda.synchronize()
    assert (mega_beam_decode.launches,
            mega_beam_decode.lstm_launches) == (before[0], before[1] + 1)
    want = mega_beam_decode_plain(params, feats, 0, batch, k=k,
                                  max_seq_length=steps, cell="lstm")
    torch.testing.assert_close(got.tokens, want.tokens, rtol=0, atol=0)
    torch.testing.assert_close(got.length, want.length, rtol=0, atol=0)
    torch.testing.assert_close(got.score, want.score, rtol=0, atol=1e-4)
    if case == "early_end":
        assert got.length.tolist() == [2] * batch


def test_nic_wrappers_raise_on_what_the_kernels_do_not_take(device):
    cell = _nic_params(device, 8, 8, 8)["cell"]
    x = torch.zeros((2, 3, 8), device=device)
    h_seq, c_seq, _ = nic_scan.nic_scan_fwd(cell, x)
    with pytest.raises(ValueError, match="gates"):
        nic_scan.nic_scan_bwd(cell, x, h_seq, c_seq, h_seq)
    with pytest.raises(ValueError, match="expected"):
        nic_scan.nic_scan_fwd(cell, x.cpu())
    with pytest.raises(TypeError, match="dtype"):
        nic_scan.nic_scan_fwd(cell, x.double())
    with pytest.raises(ValueError, match="shape"):
        nic_scan.nic_scan_fwd(cell, torch.zeros((2, 3, 9), device=device))
    params = _nic_params(device, 130, 16, 32)   # V % 4 != 0
    with pytest.raises(ValueError, match="multiples of 4"):
        mega_beam_decode(params, None, 0, 2, k=4, cell="lstm")
    params = _nic_params(device, 128, 16, 32)
    with pytest.raises(ValueError, match="expected"):
        mega_beam_decode(params, torch.zeros((2, 4, 16)), 0, 2, k=4,
                         cell="lstm")
    with pytest.raises(ValueError, match="unknown cell"):
        mega_beam_decode(params, None, 0, 2, k=4, cell="gru")


@pytest.mark.parametrize("cell,n_img,k", [
    ("factored", 1, 5), ("factored", 8, 5), ("factored", 64, 5),
    ("factored", 8, 1), ("factored", 8, 8),
    ("lstm", 1, 5), ("lstm", 8, 5), ("lstm", 64, 5), ("lstm", 8, 1),
    ("lstm", 8, 8)])
def test_grid_search_matches_plain_and_keeps_its_bits(device, cell, n_img,
                                                      k):
    """K2 as one search over the whole card: images that end at widely
    different steps (live-row compaction; some with the [<end>] fallback),
    a ragged vocabulary, E % 4 != 0, F != H.  Against the plain search; the
    same bits on a second run and on a 3-block grid; the factored cell
    bit-identical to the serial fused-step path (K1: column-split at <= 8
    rows, row-tiled above)."""
    vocab, e, steps = 516, 30, 16
    if cell == "factored":
        params, style = _params(device, vocab, e, 40, 48, seed=21,
                                end_bias=3.0), 3
    else:
        params, style = _nic_params(device, vocab, e, 48, seed=23,
                                    end_bias=3.0), 0
    one = np.random.default_rng(5).standard_normal((n_img, 1, e))
    feats = torch.tensor(np.repeat(one, k, axis=1).astype(np.float32),
                         device=device)
    kw = dict(k=k, max_seq_length=steps, cell=cell)
    before = (mega_beam_decode.launches, mega_beam_decode.lstm_launches)
    got, ran = mega_beam_decode_steps(params, feats, style, n_img, **kw)
    torch.cuda.synchronize()
    after = (mega_beam_decode.launches, mega_beam_decode.lstm_launches)
    assert after == ((before[0] + 1, before[1]) if cell == "factored"
                     else (before[0], before[1] + 1))
    want = mega_beam_decode_plain(params, feats, style, n_img, **kw)
    torch.testing.assert_close(got.tokens, want.tokens, rtol=0, atol=0)
    torch.testing.assert_close(got.length, want.length, rtol=0, atol=0)
    torch.testing.assert_close(got.score, want.score, rtol=0, atol=1e-4)
    if n_img >= 8:
        assert len(set(got.length.tolist())) >= 3
    # steps each image ran (>= 1, at most all of them) and its live
    # row-steps: one row at step 1, at most k after
    assert ran.shape == (n_img, 2) and ran.dtype == torch.int32
    n_steps, row_steps = ran[:, 0].cpu(), ran[:, 1].cpu()
    assert bool(((n_steps >= 1) & (n_steps <= steps + 1)).all())
    assert bool(((row_steps >= n_steps)
                 & (row_steps <= 1 + k * (n_steps - 1))).all())
    for grid in (None, 3):
        again, ran2 = mega_beam_decode_steps(params, feats, style, n_img,
                                             grid=grid, **kw)
        assert torch.equal(again.tokens, got.tokens)
        assert torch.equal(again.length, got.length)
        assert torch.equal(again.score, got.score)
        assert torch.equal(ran2, ran)
    if cell == "factored":
        split = decode_step_topk.split_launches
        fused = factored_decode("fused-step", params, feats, style, n_img, k,
                                steps, 1, 2)
        assert (decode_step_topk.split_launches > split) == (n_img * k <= 8)
        torch.testing.assert_close(fused.tokens, got.tokens, rtol=0, atol=0)
        torch.testing.assert_close(fused.length, got.length, rtol=0, atol=0)
        torch.testing.assert_close(fused.score, got.score, rtol=0, atol=0)


def test_grid_search_takes_only_a_grid_the_card_holds(device):
    params = _params(device, 128, 16, 32, 32)
    most = max_grid(device)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    for grid in (0, most + 1):
        with pytest.raises(ValueError, match="grid="):
            mega_beam_decode_steps(params, None, 0, 2, k=4, grid=grid)


def _att_params(device, kind, vocab=516, e=30, f=40, h=48, a=20, fs=64,
                seed=11, gain=1.5, end_bias=2.0):
    """Random attention-decoder weights in the JAX layout, N(0, gain^2 /
    fan_in) with a sharper head and a bias on <end>, so beams complete at
    several lengths."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        scale = gain / np.sqrt(shape[-2]) if len(shape) >= 2 else 0.3
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    if kind == "factored":
        p = {"B": w(vocab, e), "V_w": w(e + fs, 4 * f), "V_b": w(4, f),
             "S_w": w(4, 4, f, f), "S_b": w(4, 4, f), "U_w": w(4, f, h),
             "U_b": w(4, h), "W_w": w(h, 4 * h), "W_b": w(4, h),
             "C_w": 3 * w(h, vocab), "C_b": w(vocab),
             "attention": {"enc_w": w(4, fs, a), "enc_b": w(4, a),
                           "dec_w": w(4, h, a), "dec_b": w(4, a),
                           "full_w": w(4, a, 1), "full_b": w(4, 1)}}
        p["C_b"][2] = end_bias
    else:
        p = {"embed": w(vocab, e),
             "cell": {"W_ih": w(e + fs, 4 * h), "W_hh": w(h, 4 * h),
                      "b_ih": w(4 * h), "b_hh": w(4 * h)},
             "linear_w": 3 * w(h, vocab), "linear_b": w(vocab),
             "attention": {"enc_w": w(fs, a), "enc_b": w(a),
                           "dec_w": w(h, a), "dec_b": w(a),
                           "full_w": w(a, 1), "full_b": w(1)}}
        p["linear_b"][2] = end_bias
    p.update({"init_h_w": w(fs, h), "init_h_b": w(h), "init_c_w": w(fs, h),
              "init_c_b": w(h), "f_beta_w": w(h, fs), "f_beta_b": w(fs)})
    return bridge.to_torch(p, device=device)


def _att_counts():
    return (att_decode_step.att_decode_step_topk.launches,
            att_decode_step.att_decode_step_topk.lstm_launches,
            att_decode_step.att_init_state.launches,
            att_beam.mega_att_beam_decode.launches,
            att_beam.mega_att_beam_decode.lstm_launches)


def _att_split_counts():
    step = att_decode_step.att_decode_step_topk
    return step.split_launches, step.lstm_split_launches


@pytest.mark.parametrize("kind,n_img,k,p", [("factored", 3, 5, 9),
                                            ("lstm", 4, 3, 196)])
def test_att_decode_step_kernel_matches_plain(device, kind, n_img, k, p):
    params = _att_params(device, kind)
    cell, att, gate = att_decode_step.step_params(params, kind, 2)
    g = torch.Generator(device=device).manual_seed(n_img)
    rows = n_img * k
    x, hh, c = (torch.randn((rows, d), generator=g, device=device)
                for d in (30, 48, 48))
    feats = torch.rand((n_img, p, 64), generator=g, device=device)
    att1 = att_mod.att_projection(att, feats)
    before = _att_counts()
    got = att_decode_step.att_decode_step_topk(cell, att, gate, x, hh, c,
                                               feats, att1, kind, k, ktop=k)
    want = att_decode_step.att_decode_step_topk_plain(
        cell, att, gate, x, hh, c, feats, att1, kind, k, ktop=k)
    torch.cuda.synchronize()
    after = list(before)
    after[0 if kind == "factored" else 1] += 1
    assert _att_counts() == tuple(after)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    for i in (0, 2, 3):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["factored", "lstm"])
@pytest.mark.parametrize("n_img", [1, 3])
def test_att_init_state_kernel_matches_plain(device, n_img, kind):
    """The h0/c0 launch (K7's mean and init stages alone) against the
    plain version, and the h0/c0 K7 computes for the same images (a search
    of no further step) at atol 0; the same bits twice."""
    params = _att_params(device, kind)
    feats = torch.rand((n_img, 196, 64), device=device)
    before = att_decode_step.att_init_state.launches
    h0, c0 = att_decode_step.att_init_state(params, feats)
    h1, c1 = att_decode_step.att_init_state(params, feats)
    want_h, want_c = att_mod.init_hidden_state(params, feats)
    k7_h, k7_c = att_beam.search_init_state(params, feats, kind, 1)
    torch.cuda.synchronize()
    assert att_decode_step.att_init_state.launches == before + 2
    torch.testing.assert_close(h0, want_h, rtol=0, atol=1e-5)
    torch.testing.assert_close(c0, want_c, rtol=0, atol=1e-5)
    assert torch.equal(h0, k7_h) and torch.equal(c0, k7_c)
    assert torch.equal(h0, h1) and torch.equal(c0, c1)


def _k1_inputs(device, rows, seed):
    params = _params(device, 520, 30, 40, 48, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed)
    x, hh, c = (torch.randn((rows, d), generator=g, device=device)
                for d in (30, 48, 48))
    return params, x, hh, c


def _k6_inputs(device, kind, n_img, k, seed):
    params = _att_params(device, kind)
    cell, att, gate = att_decode_step.step_params(params, kind, 2)
    g = torch.Generator(device=device).manual_seed(seed)
    rows = n_img * k
    x, hh, c = (torch.randn((rows, d), generator=g, device=device)
                for d in (30, 48, 48))
    feats = torch.rand((n_img, 196, 64), generator=g, device=device)
    att1 = att_mod.att_projection(att, feats)
    return (cell, att, gate, x, hh, c, feats, att1, kind, k)


@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("op", ["k1", "factored", "lstm"])
def test_split_path_matches_plain_at_one_image(device, op, k):
    """The column-split path (one image's k rows) against the plain version:
    ids exact, values atol 1e-4, alpha atol 1e-5; E % 4 != 0, F != H, a
    ragged vocabulary, P = 196."""
    if op == "k1":
        params, x, hh, c = _k1_inputs(device, k, 30 + k)
        before = (decode_step_topk.split_launches,
                  decode_step_topk.tiled_launches)
        got = decode_step_topk(params, x, hh, c, 1, ktop=k)
        want = decode_step_topk_plain(params, x, hh, c, 1, ktop=k)
        torch.cuda.synchronize()
        assert (decode_step_topk.split_launches,
                decode_step_topk.tiled_launches) == (before[0] + 1, before[1])
    else:
        args = _k6_inputs(device, op, 1, k, 40 + k)
        step = att_decode_step.att_decode_step_topk
        before = (_att_split_counts(), step.tiled_launches,
                  step.lstm_tiled_launches)
        got = step(*args, ktop=k)
        want = att_decode_step.att_decode_step_topk_plain(*args, ktop=k)
        torch.cuda.synchronize()
        split = list(before[0])
        split[0 if op == "factored" else 1] += 1
        assert (_att_split_counts(), step.tiled_launches,
                step.lstm_tiled_launches) == (tuple(split), *before[1:])
        torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-5)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    for i in (0, 2, 3):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=1e-4)


def test_split_path_at_flagship_width(device):
    """K1, K6 factored and K6 lstm one after another at the serving widths
    (E = 300, F = H = A = 512, FS = 2048, P = 196, V = 8192, k = 5), where
    several launches need more than 48 KB of shared memory: against the
    plain versions as above."""
    rng = np.random.default_rng(3)
    e, f, h, a, fs, p, vocab, k = 300, 512, 512, 512, 2048, 196, 8192, 5

    def w(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else 4)
        return torch.tensor((scale * rng.standard_normal(shape)).astype(
            np.float32), device=device)

    x, hh, c = w(k, e, scale=0.3), w(k, h, scale=0.5), w(k, h, scale=0.5)
    feats = torch.tensor(0.3 * rng.random((1, p, fs), dtype=np.float32),
                         device=device)
    k1 = {"B": w(vocab, e), "V_w": w(e, 4 * f), "V_b": w(4, f),
          "S_w": w(4, 4, f, f), "S_b": w(4, 4, f), "U_w": w(4, f, h),
          "U_b": w(4, h), "W_w": w(h, 4 * h), "W_b": w(4, h),
          "C_w": w(h, vocab, scale=0.2), "C_b": w(vocab)}
    got = decode_step_topk(k1, x, hh, c, 1, ktop=k)
    want = decode_step_topk_plain(k1, x, hh, c, 1, ktop=k)
    outs = [(got, want)]
    att = {"dec_w": w(h, a), "dec_b": w(a), "full_w": w(a, 1),
           "full_b": w(1), "enc_w": w(fs, a), "enc_b": w(a)}
    gate = {"f_beta_w": w(h, fs), "f_beta_b": w(fs)}
    att1 = att_mod.att_projection(att, feats)
    cells = {"factored": dict(k1, V_w=w(e + fs, 4 * f), S_w=w(4, f, f),
                              S_b=w(4, f)),
             "lstm": {"W_ih": w(e + fs, 4 * h), "b_ih": w(4 * h),
                      "W_hh": w(h, 4 * h), "b_hh": w(4 * h),
                      "C_w": k1["C_w"], "C_b": k1["C_b"]}}
    for kind, cell in cells.items():
        args = (cell, att, gate, x, hh, c, feats, att1, kind, k)
        outs.append((att_decode_step.att_decode_step_topk(*args, ktop=k),
                     att_decode_step.att_decode_step_topk_plain(*args,
                                                                ktop=k)))
    torch.cuda.synchronize()
    for got, want in outs:
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        for i in (0, 2, 3):
            torch.testing.assert_close(got[i], want[i], rtol=0, atol=1e-4)
        if len(got) == 5:
            torch.testing.assert_close(got[4], want[4], rtol=0, atol=1e-5)


@pytest.mark.parametrize("op", ["k1", "factored", "lstm"])
def test_split_and_tiled_paths_give_a_row_the_same_bits(device, op):
    """One image's 5 rows alone (the column-split path) and inside a
    320-row call (the row-tiled path): logp, idx, h', c' and alpha
    bit-identical."""
    if op == "k1":
        params, x, hh, c = _k1_inputs(device, 320, 7)
        rows = slice(85, 90)
        whole = decode_step_topk(params, x, hh, c, 1, ktop=5)
        alone = decode_step_topk(params, x[rows].contiguous(),
                                 hh[rows].contiguous(),
                                 c[rows].contiguous(), 1, ktop=5)
    else:
        args = _k6_inputs(device, op, 64, 5, 8)
        cell, att, gate, x, hh, c, feats, att1 = args[:8]
        rows, img = slice(85, 90), slice(17, 18)
        step = att_decode_step.att_decode_step_topk
        whole = step(*args, ktop=5)
        alone = step(cell, att, gate, *(t[rows].contiguous()
                                        for t in (x, hh, c)),
                     feats[img].contiguous(), att1[img].contiguous(), op, 5,
                     ktop=5)
    torch.cuda.synchronize()
    for w_, a_ in zip(whole, alone):
        torch.testing.assert_close(a_, w_[rows], rtol=0, atol=0)


ATT_BEAM_WEIGHTS = {"factored": dict(vocab=36, seed=14, end_bias=1.0),
                    "lstm": {}}


@pytest.mark.parametrize("kind,k,batch", [
    pytest.param("factored", 5, 6, id="factored-5"),
    pytest.param("lstm", 5, 6, id="lstm-5"),
    pytest.param("factored", 3, 6, id="factored-3"),
    # one image: the serial serving shape, K6's column-split path
    pytest.param("factored", 5, 1, id="factored-5-one_image"),
    pytest.param("lstm", 5, 1, id="lstm-5-one_image")])
def test_mega_att_kernel_matches_plain_and_fused_step(device, kind, k,
                                                      batch):
    # weights whose beams end at several lengths (checked below)
    params = _att_params(device, kind, **ATT_BEAM_WEIGHTS[kind])
    steps = 9
    feats = torch.tensor(np.random.default_rng(k).random(
        (batch, 9, 64), dtype=np.float32), device=device)
    before = _att_counts()
    got, block_steps = att_beam.mega_att_beam_decode_steps(
        params, feats, 1, batch, k=k, max_seq_length=steps, kind=kind)
    torch.cuda.synchronize()
    after = list(before)
    after[3 if kind == "factored" else 4] += 1
    assert _att_counts() == tuple(after)
    want = att_beam.mega_att_beam_decode_plain(params, feats, 1, batch, k=k,
                                               max_seq_length=steps,
                                               kind=kind)
    torch.testing.assert_close(got.tokens, want.tokens, rtol=0, atol=0)
    torch.testing.assert_close(got.length, want.length, rtol=0, atol=0)
    torch.testing.assert_close(got.score, want.score, rtol=0, atol=1e-4)
    if batch > 1:
        assert len(set(got.length.tolist())) > 1, got.length
    assert block_steps.shape == (batch, 2)
    assert int(block_steps[:, 0].max()) <= steps + 1
    assert (block_steps[:, 0] >= got.length - 1).all()
    # the serial serving path (K6 in the Python beam from the h0/c0
    # kernel) is bit-identical
    args = (batch, k, steps, 1, 2)
    split = _att_split_counts()
    fused = (attention_decode("fused-step", params, feats, 1, *args)
             if kind == "factored"
             else nic_att_decode("fused-step", params, feats, *args))
    moved = [a > b for a, b in zip(_att_split_counts(), split)]
    assert moved == ([kind == "factored", kind == "lstm"] if batch == 1
                     else [False, False])
    torch.testing.assert_close(fused.tokens, got.tokens, rtol=0, atol=0)
    torch.testing.assert_close(fused.length, got.length, rtol=0, atol=0)
    torch.testing.assert_close(fused.score, got.score, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("n_img", [1, 3, 8, 64])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_grid_att_search_matches_plain_and_keeps_its_bits(device, kind,
                                                          n_img, k):
    """K7 as one search over the whole card: images that end at several
    steps (live-row and live-image compaction), a ragged vocabulary, E % 4
    != 0, F != H, P = 9.  Against the plain search; the same bits on a
    second run and on a 3-block grid; bit-identical to the serial
    fused-step path (K6 per step from the h0/c0 kernel: column-split at
    one image, row-tiled above)."""
    params = _att_params(device, kind, **ATT_BEAM_WEIGHTS[kind])
    steps = 9
    feats = torch.tensor(np.random.default_rng(n_img + k).random(
        (n_img, 9, 64), dtype=np.float32), device=device)
    kw = dict(k=k, max_seq_length=steps, kind=kind)
    before = _att_counts()
    got, ran = att_beam.mega_att_beam_decode_steps(params, feats, 1, n_img,
                                                   **kw)
    torch.cuda.synchronize()
    after = list(before)
    after[3 if kind == "factored" else 4] += 1
    assert _att_counts() == tuple(after)
    want = att_beam.mega_att_beam_decode_plain(params, feats, 1, n_img, **kw)
    torch.testing.assert_close(got.tokens, want.tokens, rtol=0, atol=0)
    torch.testing.assert_close(got.length, want.length, rtol=0, atol=0)
    torch.testing.assert_close(got.score, want.score, rtol=0, atol=1e-4)
    if n_img >= 8 and k > 1:
        assert len(set(got.length.tolist())) >= 2, got.length
    # steps each image ran and its live row-steps: one row at step 1, at
    # most k after
    assert ran.shape == (n_img, 2) and ran.dtype == torch.int32
    n_steps, row_steps = ran[:, 0].cpu(), ran[:, 1].cpu()
    assert bool(((n_steps >= 1) & (n_steps <= steps + 1)).all())
    assert bool(((row_steps >= n_steps)
                 & (row_steps <= 1 + k * (n_steps - 1))).all())
    for grid in (None, 3):
        again, ran2 = att_beam.mega_att_beam_decode_steps(
            params, feats, 1, n_img, grid=grid, **kw)
        assert torch.equal(again.tokens, got.tokens)
        assert torch.equal(again.length, got.length)
        assert torch.equal(again.score, got.score)
        assert torch.equal(ran2, ran)
    args = (n_img, k, steps, 1, 2)
    fused = (attention_decode("fused-step", params, feats, 1, *args)
             if kind == "factored"
             else nic_att_decode("fused-step", params, feats, *args))
    torch.testing.assert_close(fused.tokens, got.tokens, rtol=0, atol=0)
    torch.testing.assert_close(fused.length, got.length, rtol=0, atol=0)
    torch.testing.assert_close(fused.score, got.score, rtol=0, atol=0)


def test_att_wrappers_raise_on_what_the_kernels_do_not_take(device):
    params = _att_params(device, "lstm", a=18)    # A % 4 != 0
    feats = torch.rand((2, 9, 64), device=device)
    with pytest.raises(ValueError, match="multiples of 4"):
        att_beam.mega_att_beam_decode(params, feats, 0, 2, k=4, kind="lstm")
    params = _att_params(device, "factored")
    with pytest.raises(ValueError, match="expected"):
        att_beam.mega_att_beam_decode(params, feats.cpu(), 0, 2, k=4)
    with pytest.raises(ValueError, match="P=300"):
        att_beam.mega_att_beam_decode(params,
                                      torch.rand((2, 300, 64), device=device),
                                      0, 2, k=4)
    # above K_MAX the CPU route decodes; the kernels refuse, naming it
    with pytest.raises(ValueError, match="K7 .*K_MAX = 8"):
        att_beam.mega_att_beam_decode(params, feats, 0, 2, k=9)
    most = att_beam.max_grid(device)
    assert most >= torch.cuda.get_device_properties(0).multi_processor_count
    for grid in (0, most + 1):
        with pytest.raises(ValueError, match="grid="):
            att_beam.mega_att_beam_decode_steps(params, feats, 0, 2, k=4,
                                                grid=grid)
    cell, att, gate = att_decode_step.step_params(params, "factored", 0)
    att1 = att_mod.att_projection(att, feats)
    x = torch.zeros((6, 30), device=device)
    h = torch.zeros((6, 48), device=device)
    with pytest.raises(ValueError, match="rows"):
        att_decode_step.att_decode_step_topk(
            cell, att, gate, x, h, h, feats, att1, k=4, ktop=4)
    x9 = torch.zeros((18, 30), device=device)
    h9 = torch.zeros((18, 48), device=device)
    with pytest.raises(ValueError, match="K6 .*K_MAX = 8"):
        att_decode_step.att_decode_step_topk(
            cell, att, gate, x9, h9, h9, feats, att1, k=9, ktop=4)
    with pytest.raises(ValueError, match="K6 .*K_MAX = 8"):
        att_decode_step.att_decode_step_topk(
            cell, att, gate, x9[:16], h9[:16], h9[:16], feats, att1, k=8,
            ktop=9)


# --- K5: the attention training scan (att_scan.cu) --------------------------

def _att_scan_inputs(device, kind, b, t, p, sampled, vocab=37, seed=21):
    """K5's inputs from a random attention decoder (E = 30, F = 40, H = 48,
    A = 20, FS = 64) through the model's own repacking."""
    params = _att_params(device, kind, vocab=vocab, seed=seed)
    rng = np.random.default_rng(seed + b)
    feats = torch.tensor(rng.random((b, p, 64), dtype=np.float32),
                         device=device)
    caps = torch.tensor(rng.integers(0, vocab, (b, t)), device=device)
    fam = att_mod._Family(params, AttentionDecoderConfig(embed_size=30),
                          2, kind == "factored")
    att = att_mod.select_attention(params, 2)
    cell, katt = fam.kernel_params(att)
    att1 = feats @ att["enc_w"] + att["enc_b"]
    h0, c0 = att_mod.init_hidden_state(params, feats)
    args = [cell, katt, fam.embed(caps), att1, feats, h0, c0, kind]
    samp = None
    if sampled:
        coins = torch.tensor(rng.integers(0, 2, t), dtype=torch.float32,
                             device=device)
        coins[0] = 0.0
        samp = {"head": {"C_w": fam.head_w, "C_b": fam.head_b,
                         "B": fam.table},
                "emb_raw": fam.embed(caps[:, :1]), "coins": coins}
    cot = (torch.tensor(rng.standard_normal((b, t, 48)), dtype=torch.float32,
                        device=device),
           torch.tensor(rng.standard_normal((b, t, p)), dtype=torch.float32,
                        device=device))
    return args, samp, cot


@pytest.mark.parametrize("sampled", [False, True, "tied"])
@pytest.mark.parametrize("kind,b,t,p", [("factored", 5, 4, 9),
                                        ("lstm", 3, 6, 196),
                                        ("factored", 2, 1, 9),
                                        ("lstm", 64, 25, 9)])
def test_att_scan_kernels_match_plain(device, kind, b, t, p, sampled):
    """``sampled="tied"``: a zero head, so every logit ties and every
    argmax is token 0 (the lowest index), and the token scatter adds all
    the sampled rows into one row of B."""
    args, samp, (dh, da) = _att_scan_inputs(device, kind, b, t, p,
                                            bool(sampled))
    if sampled == "tied":
        samp["head"] = dict(samp["head"], C_w=torch.zeros_like(
            samp["head"]["C_w"]), C_b=torch.zeros_like(samp["head"]["C_b"]))
        sampled = True
    name = att_scan.counter_name(kind, sampled)
    before = (getattr(att_scan.att_scan_fwd, name),
              getattr(att_scan.att_scan_bwd, name))
    h, a, res = att_scan.att_scan_fwd(*args, samp)
    if sampled:
        want = att_scan.fused_att_scan_sampled_plain(
            *args[:2], samp["head"], args[2], samp["emb_raw"], *args[3:7],
            samp["coins"], kind)
        torch.testing.assert_close(res["pidx"].long(), want[3], rtol=0,
                                   atol=0)
        if not samp["head"]["C_w"].any():
            assert not res["pidx"].any()
    else:
        want = att_scan.fused_att_scan_plain(*args)
    torch.testing.assert_close(h, want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(res["c_seq"], want[2], rtol=0, atol=1e-4)
    torch.testing.assert_close(a, want[1], rtol=0, atol=1e-5)
    got = att_scan.att_scan_bwd(*args[:7], h, a, res, dh, da, kind, samp)
    cpu_res = {"c_seq": res["c_seq"].cpu(),
               "pidx": None if res["pidx"] is None else res["pidx"].cpu()}
    # the plain backward on the forward's att2, so both sides take the same
    # relu' masks (see att_scan_bwd_plain)
    att2 = res["buf"]["hp"][:, :, :20].transpose(0, 1).cpu()
    with torch.no_grad():
        ref = att_scan.att_scan_grads_plain(
            *(bridge.to_torch(bridge.to_numpy(x)) for x in args[:7]),
            h.cpu(), a.cpu(), cpu_res, dh.cpu(), da.cpu(), kind,
            None if samp is None else bridge.to_torch(bridge.to_numpy(samp)),
            att2)
    torch.cuda.synchronize()
    assert (getattr(att_scan.att_scan_fwd, name),
            getattr(att_scan.att_scan_bwd, name)) == (before[0] + 1,
                                                      before[1] + 1)
    flat_got, flat_ref = optim.tree_leaves(got), optim.tree_leaves(ref)
    assert len(flat_got) == len(flat_ref)
    for g_, r_ in zip(flat_got, flat_ref):
        if g_ is got["att"]["full_b"]:
            # sum of every row's sum_p d_e: 0 in exact arithmetic, so both
            # sides hold float32 rounding noise of the B T P terms (up to
            # 7.4e-6 at B = 64, T = 25 with these weights)
            assert max(g_.abs().item(), r_.abs().item()) <= 1e-4
        else:
            _close_scaled(g_.cpu(), r_)
    # the same bits on a second run: no atomics anywhere
    again = att_scan.att_scan_bwd(*args[:7], h, a, res, dh, da, kind, samp)
    assert all(torch.equal(x, y) for x, y in
               zip(flat_got, optim.tree_leaves(again)))


@pytest.mark.parametrize("ratio", [1.0, 0.8])
@pytest.mark.parametrize("factored", [True, False])
def test_attention_steps_on_the_card_match_the_cpu(device, factored, ratio):
    """The whole attention train step (K5 and the chunked CE on the card,
    their plain versions on the CPU) from the same weights and draws."""
    kind = "factored" if factored else "lstm"
    params = _att_params(device, kind, vocab=37, seed=31)
    cfg = AttentionDecoderConfig(vocab_size=37, embed_size=30,
                                 hidden_size=48, factored_size=40,
                                 feature_size=64, attention_size=20)
    tcfg = TrainConfig(teacher_forcing_ratio=ratio)
    rng = np.random.default_rng(32)
    b, t = 6, 8
    data = [torch.tensor(rng.random((b, 9, 64), dtype=np.float32)),
            torch.tensor(rng.integers(0, 37, (b, t))),
            torch.tensor([8, 3, 5, 1, 8, 6]),
            torch.tensor([True] * 5 + [False])]
    keep = rng.random((b, t - 1, 30)) < 0.5
    coins = [bool(x) for x in rng.integers(0, 2, t - 1)]
    out = {}
    for dev in (device, torch.device("cpu")):
        steps = make_attention_steps(cfg, tcfg, None, None, factored,
                                     device=dev)
        assert steps.use_fused == steps.use_chunked == (dev.type == "cuda")
        dec = bridge.to_torch(bridge.to_numpy(params), device=dev)
        out[dev.type] = steps.emotion_grads(
            dec, *(x.to(dev) for x in data), 2, keep=keep, coins=coins)
    torch.cuda.synchronize()
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0],
                               rtol=0, atol=1e-5)
    for key, r_ in out["cpu"][1].items():
        g_ = out["cuda"][1][key]
        if key == "attention":
            # full_b's grad sums every row's sum_p d_e, 0 in exact
            # arithmetic: both sides hold rounding noise
            full_b = g_.pop("full_b").cpu(), r_.pop("full_b")
            assert max(x.abs().max().item() for x in full_b) <= 1e-4
        for gl, rl in zip(optim.tree_leaves(g_), optim.tree_leaves(r_)):
            _close_scaled(gl.cpu(), rl)


def test_att_scan_wrappers_raise_on_what_the_kernels_do_not_take(device):
    args, samp, (dh, da) = _att_scan_inputs(device, "lstm", 2, 3, 9, True)
    bad = list(args)
    bad[4] = args[4].cpu()                           # device mix
    with pytest.raises(ValueError, match="expected cuda"):
        att_scan.att_scan_fwd(*bad, samp)
    bad = list(args)
    bad[2] = args[2].double()                        # unsupported dtype
    with pytest.raises(TypeError, match="dtype"):
        att_scan.att_scan_fwd(*bad, samp)
    odd = dict(args[1])
    odd["full_w"] = torch.zeros((18, 1), device=device)   # A % 4 != 0
    odd["dec_w"] = torch.zeros((48, 18), device=device)
    odd["dec_b"] = torch.zeros((18,), device=device)
    bad = list(args)
    bad[1], bad[3] = odd, torch.zeros((2, 9, 18), device=device)
    with pytest.raises(ValueError, match="multiples of 4"):
        att_scan.att_scan_fwd(*bad, samp)
    h, a, res = att_scan.att_scan_fwd(*args)         # teacher-forced res
    with pytest.raises(ValueError, match="token trace"):
        att_scan.att_scan_bwd(*args[:7], h, a, res, dh, da, "lstm", samp)


# --- K5's product (gemm_tf32x3.cuh) ------------------------------------------

# (form, M, N, K, batch, bias, row pad): ragged M, N and K against the
# 128 x 64 x 32 tiles; rows that are not 16-byte aligned (the 4-byte copy
# path: N = 37 in a (K, N) operand, K = 301, M = 3 in an (K, M) one); rows
# padded beyond their width (a row stride > the width); batches laid out as
# K5's S / U / ds / dv (interleaved along the rows); and shapes whose K the
# schedule splits into chunks (S / U: 4 of 128, dh: 16 of 288, x W_in: 4 of
# 608 with the K = 2348 = 293 x 8 + 4 tail)
TF32X3_CASES = {
    "N_ragged": ("N", 3, 37, 300, 1, True, 0),
    "T_ragged": ("T", 3, 37, 300, 1, False, 0),
    "A_ragged": ("A", 3, 37, 300, 1, True, 0),
    "N_k301_padded": ("N", 7, 64, 301, 1, False, 3),
    "A_padded_batched": ("A", 130, 70, 96, 3, True, 4),
    "N_batched_split": ("N", 128, 512, 512, 4, True, 0),
    "T_batched_split": ("T", 128, 512, 512, 4, False, 0),
    "A_batched_weight_grad": ("A", 512, 512, 3200, 4, False, 0),
    "N_x_Win_split": ("N", 128, 2048, 2348, 1, True, 0),
    "T_dh_split": ("T", 128, 512, 4608, 1, False, 0),
    "T_dx_split": ("T", 128, 2348, 2048, 1, False, 0),
}


def _product_operands(device, form, m, n, k, batch, pad, seed):
    rng = np.random.default_rng(seed)
    a_rows, a_cols = (k, m) if form == "A" else (m, k)
    b_rows, b_cols = (n, k) if form == "T" else (k, n)
    a = torch.tensor(rng.uniform(-1, 1, (a_rows, batch * a_cols + pad)),
                     dtype=torch.float32, device=device)[:, :batch * a_cols]
    b = torch.tensor(0.05 * rng.standard_normal((batch, b_rows,
                                                 b_cols + pad)),
                     dtype=torch.float32, device=device)[..., :b_cols]
    if batch == 1:
        return a, b[0]
    return a.view(a_rows, batch, a_cols).transpose(0, 1), b


@pytest.mark.parametrize("case", sorted(TF32X3_CASES))
def test_tf32x3_product_matches_float64_and_the_plain_version(device, case):
    """The product K5 launches against float64: its error at most 4x that
    of gemm_f32.cuh's CUDA-core product on the same inputs (the tensor
    core's float32 sum truncates, so a small factor is allowed); against
    the emulation of its split within that bound plus the emulation's own
    error; the same bits twice."""
    form, m, n, k, batch, with_bias, pad = TF32X3_CASES[case]
    a, b = _product_operands(device, form, m, n, k, batch, pad,
                             seed=len(case))
    bias = None
    if with_bias:
        bias = torch.randn((batch, n) if batch > 1 else (n,),
                           generator=torch.Generator().manual_seed(3)).to(
                               device)
    before = att_scan.tf32x3_product.launches
    got = att_scan.tf32x3_product(a, b, form, bias)
    again = att_scan.tf32x3_product(a, b, form, bias)
    f32 = att_scan.f32_product(a, b, form, bias)
    plain = att_scan.tf32x3_product_plain(a, b, form, bias)
    ref = att_scan._as_mk(a, form).double() @ att_scan._as_kn(b, form).double()
    if bias is not None:
        ref = ref + (bias[:, None] if bias.dim() == 2 else bias).double()
    torch.cuda.synchronize()
    assert att_scan.tf32x3_product.launches == before + 2
    assert got.shape == ((batch,) if batch > 1 else ()) + (m, n)
    assert torch.equal(got, again)
    err = (got.double() - ref).abs().max().item()
    err_f32 = (f32.double() - ref).abs().max().item()
    err_plain = (plain.double() - ref).abs().max().item()
    assert 0.0 < err_f32 and err <= 4.0 * err_f32, (err, err_f32)
    assert (got - plain).abs().max().item() <= 4.0 * err_f32 + err_plain


def test_tf32x3_wrapper_raises_on_what_the_kernel_does_not_take(device):
    a = torch.zeros((4, 8), device=device)
    b = torch.zeros((8, 5), device=device)
    with pytest.raises(ValueError, match="expected cuda"):
        att_scan.tf32x3_product(a, b.cpu())
    with pytest.raises(TypeError, match="dtype"):
        att_scan.tf32x3_product(a.double(), b.double())
    with pytest.raises(ValueError, match="rows must be contiguous"):
        att_scan.tf32x3_product(a.t(), b, "A")   # chains, rows strided
    with pytest.raises(ValueError, match="bias"):
        att_scan.tf32x3_product(a, b, "N", torch.zeros(4, device=device))


# --- K3's and K8's products over all rows alone -------------------------------

def _scan_product_shapes():
    """(name, form, M, N, K, batch) of every product over all rows that K3
    (B 64, T 25, E 300, F = H = 512) and K8 (B 128, T 22, E = H = 512)
    launch: 'N' and 'T' by wgmma from the weight's planes, 'A' (the weight
    grads) on gemm_tf32x3.cuh."""
    n3, n8 = 64 * 25, 128 * 22
    return [("k3_x_Vw", "N", n3, 2048, 300, 1), ("k3_v_S", "N", n3, 512, 512, 4),
            ("k3_s_U", "N", n3, 512, 512, 4), ("k3_dz_Ut", "T", n3, 512, 512, 4),
            ("k3_ds_St", "T", n3, 512, 512, 4),
            ("k3_dv_Vwt", "T", n3, 300, 2048, 1),
            ("k3_g_Ww", "A", 512, 2048, n3, 1), ("k3_g_U", "A", 512, 512, n3, 4),
            ("k3_g_S", "A", 512, 512, n3, 4), ("k3_g_Vw", "A", 300, 2048, n3, 1),
            ("k8_x_Wx", "N", n8, 2048, 512, 1),
            ("k8_dZ_Wxt", "T", n8, 512, 2048, 1),
            ("k8_g_Wx", "A", 512, 2048, n8, 1), ("k8_g_Wh", "A", 512, 2048, n8, 1)]


@pytest.mark.parametrize("shape", _scan_product_shapes(), ids=lambda s: s[0])
def test_scan_products_match_float64_and_keep_their_bits(device, shape):
    """Each product K3 and K8 run over all rows, alone at its main-path
    shape (batched operands strided as the scans keep them): its error
    against float64 at most 4x that of gemm_f32.cuh's product on the same
    inputs, the same bits twice; 'N' with the bias the forward adds."""
    from icee_tpu_torch.ops import scan_grid

    name, form, m, n, k, batch = shape
    a, b = _product_operands(device, form, m, n, k, batch, 0,
                             seed=len(name) + m)
    bias = None
    if form == "N":
        bias = torch.randn((batch, n) if batch > 1 else (n,),
                           generator=torch.Generator().manual_seed(4)).to(
                               device)
    before = scan_grid.scan_product.launches
    got = scan_grid.scan_product(a, b, form, bias)
    again = scan_grid.scan_product(a, b, form, bias)
    f32 = att_scan.f32_product(a, b, form, bias)
    ref = att_scan._as_mk(a, form).double() @ att_scan._as_kn(b, form).double()
    if bias is not None:
        ref = ref + (bias[:, None] if bias.dim() == 2 else bias).double()
    torch.cuda.synchronize()
    assert scan_grid.scan_product.launches == before + 2
    assert got.shape == ((batch,) if batch > 1 else ()) + (m, n)
    assert torch.equal(got, again)
    err = (got.double() - ref).abs().max().item()
    err_f32 = (f32.double() - ref).abs().max().item()
    assert 0.0 < err_f32 and err <= 4.0 * err_f32, (err, err_f32)


@pytest.mark.parametrize("form,m,n,k,batch", [
    ("N", 37, 70, 45, 3),    # ragged everywhere, three weights
    ("T", 5, 33, 100, 1),
    ("A", 19, 40, 77, 2),
])
def test_scan_product_matches_its_emulation_at_ragged_shapes(device, form, m,
                                                             n, k, batch):
    from icee_tpu_torch.ops import scan_grid

    a, b = _product_operands(device, form, m, n, k, batch, 3, seed=m)
    got = scan_grid.scan_product(a, b, form)
    plain = scan_grid.scan_product(a.cpu(), b.cpu(), form)
    f32 = att_scan.f32_product(a, b, form)
    ref = att_scan._as_mk(a, form).double() @ att_scan._as_kn(b, form).double()
    torch.cuda.synchronize()
    err_f32 = (f32.double() - ref).abs().max().item()
    err_plain = (plain.double() - ref.cpu()).abs().max().item()
    assert (got.cpu() - plain).abs().max().item() <= 4.0 * err_f32 + err_plain


def test_scan_wrappers_refuse_a_shape_without_a_plan(device):
    """H = 1024: no block's slice of W_h fits one an SM; each wrapper
    (K3, K4, K8) raises naming its kernel, and launches nothing."""
    from icee_tpu_torch.ops import senticap_scan as ss

    h = 1024
    x = torch.zeros((2, 3, 8), device=device)
    w = torch.zeros((8 + h, 4 * h), device=device)
    before = ss.senticap_scan_fwd.launches
    with pytest.raises(ValueError, match="K8"):
        ss.senticap_scan_fwd(w, x)
    assert ss.senticap_scan_fwd.launches == before
    p = _slice(_cell_params(device, 8, 16, h), 0)
    with pytest.raises(ValueError, match="K3"):
        lstm_scan.factored_scan_fwd(p, x)
    cell = _nic_params(device, 8, 8, h)["cell"]
    before = nic_scan.nic_scan_fwd.launches
    with pytest.raises(ValueError, match="K4"):
        nic_scan.nic_scan_fwd(cell, x)
    assert nic_scan.nic_scan_fwd.launches == before


# --- the SentiCap base slice: K8, K9, the step, TF32 -------------------------

def _senticap_params(device, vocab, e, h, seed=0, vis=24, stop_bias=2.0,
                     zero_head=False):
    """Base mRNN weights drawn with numpy (N(0, 1), a STOP bias)."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"wemb": n(vocab, e), "w_lstm": n(e + h, 4 * h, scale=0.5),
         "w": n(h, vocab), "b": n(vocab, scale=0.5),
         "wvm": n(vis, e, scale=0.5), "bmv": n(e, scale=0.1)}
    p["b"][0] += stop_bias
    if zero_head:
        p["w"][:] = 0.0
        p["b"][:] = 0.0
    return bridge.to_torch(p, device=device)


@pytest.mark.parametrize("b,t,e,h,gclip", [
    (3, 1, 13, 16, 0.01),    # T = 1, E % 4 != 0, the clamp binding
    (5, 6, 30, 32, 0.01),    # B not a multiple of 8, the clamp binding
    (8, 4, 12, 8, 5.0),
    (1, 22, 16, 20, 0.01),   # B = 1, H = 20: groups that do not divide
    (130, 5, 24, 36, 5.0),   # three 64-row passes, H % 8 != 0
    (129, 3, 16, 528, 0.01), # 132 unit groups: the forward's blocks
                             # take 192 rows, three passes each
])
def test_senticap_scan_kernels_match_plain(device, b, t, e, h, gclip):
    from icee_tpu_torch.ops import senticap_scan as ss

    g = torch.Generator(device=device).manual_seed(b + t)
    w = 0.6 * torch.randn((e + h, 4 * h), generator=g, device=device)
    x = torch.randn((b, t, e), generator=g, device=device)
    dh = 3.0 * torch.randn((b, t, h), generator=g, device=device)
    before = (ss.senticap_scan_fwd.launches, ss.senticap_scan_bwd.launches)
    h_seq, c_seq, gates = ss.senticap_scan_fwd(w, x, gclip)
    want_h, want_c = ss.fused_senticap_scan_plain(w, x, gclip)
    torch.testing.assert_close(h_seq, want_h, rtol=0, atol=1e-4)
    torch.testing.assert_close(c_seq, want_c, rtol=0, atol=1e-4)
    dx, dw = ss.senticap_scan_bwd(w, x, h_seq, c_seq, dh, gclip, gates)
    want_dx, want_dw = ss.senticap_scan_bwd_plain(w, x, h_seq, c_seq, dh,
                                                  gclip)
    torch.cuda.synchronize()
    assert (ss.senticap_scan_fwd.launches,
            ss.senticap_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    _close_scaled(dx, want_dx)
    _close_scaled(dw, want_dw)
    if t > 1 and gclip < 1:   # the clamp binds: it changes dw
        loose = ss.senticap_scan_bwd_plain(w, x, h_seq, c_seq, dh, 1e9)[1]
        assert not torch.allclose(loose, want_dw)
    # the same bits on a second run: no atomics anywhere
    h2, c2, _ = ss.senticap_scan_fwd(w, x, gclip)
    dx2, dw2 = ss.senticap_scan_bwd(w, x, h_seq, c_seq, dh, gclip, gates)
    assert torch.equal(h_seq, h2) and torch.equal(c_seq, c2)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("case", ["ragged", "one_image", "tied", "saturated",
                                  "beam1"])
def test_senticap_beam_kernel_matches_plain(device, case):
    """K9 against its plain search: a ragged vocabulary over several
    images, one image at beam 20, an all-tied zero head (every step picks
    tokens 0, 1, 2, ... in index order, so the best sequence is all 0s
    when STOP is another token), a saturated tail (nll plateau at
    -log2(1e-37), ranked by index) and beam 1 (greedy)."""
    from icee_tpu_torch.ops import senticap_decode as sd

    vocab, beam, batch, max_len, stop = 515, 5, 6, 7, 0
    kw = dict(seed=3, stop_bias=4.0)
    if case == "one_image":
        vocab, beam, batch = 300, 20, 1
    elif case == "beam1":
        beam = 1
    elif case == "tied":
        vocab, stop, kw = 64, 63, dict(zero_head=True)
    params = _senticap_params(device, vocab, 16, 16, **kw)
    if case == "saturated":
        params["b"].fill_(-200.0)
        params["b"][:4] = torch.tensor([50.0, 49.0, 48.0, 47.0])
    g = torch.Generator(device=device).manual_seed(5)
    v = torch.randn((batch, 24), generator=g, device=device)
    before = sd.mega_senticap_beam_decode.launches
    got = sd.mega_senticap_beam_decode(params, v, batch, beam_size=beam,
                                       max_len=max_len, stop_token=stop)
    torch.cuda.synchronize()
    assert sd.mega_senticap_beam_decode.launches == before + 1
    want = sd.mega_senticap_beam_decode_plain(params, v, batch, beam, max_len,
                                              stop)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    for i in range(batch):
        n = int(want[2][i])
        assert got[1][i, :n].tolist() == want[1][i, :n].tolist(), i
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    if case == "tied":
        assert got[1].tolist() == [[0] * (max_len + 1)] * batch
    if case == "ragged":
        assert len(set(got[2].tolist())) > 1
    again = sd.mega_senticap_beam_decode(params, v, batch, beam_size=beam,
                                         max_len=max_len, stop_token=stop)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("semi,chunked", [(1.0, True), (1.0, False),
                                          (0.8, True)])
def test_senticap_base_step_on_the_card_matches_the_cpu(device, semi,
                                                        chunked):
    """One base-model step on the card (K8 at SEMI_FORCED 1.0, the chunked
    CE kernels) against the same step on the CPU with the same masks.
    Tolerances: loss rtol 1e-5; params atol 1e-4 (the RMSProp update
    magnifies grad rounding by up to 10)."""
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import solver as ssolver
    from icee_tpu_torch.senticap.config import senticap_conf
    from icee_tpu_torch.senticap.train import make_base_step

    conf = senticap_conf(emb_size=12, lstm_hidden_size=16, visual_size=24,
                         MAX_SENTENCE_LEN=6, SEMI_FORCED=semi,
                         CHUNKED_CE=chunked, batch_size_val=5)
    rng = np.random.default_rng(7)
    n, t, vocab = 9, 7, 40
    ds = sio.SentiDataset(
        X=rng.integers(0, vocab, (n, t)).astype(np.int32),
        Y=rng.integers(0, vocab, (n, t)).astype(np.int32),
        Xlen=(np.arange(t)[None] < rng.integers(2, t, (n, 1))).astype(
            np.float32),
        V=rng.standard_normal((n, 24)).astype(np.float32),
        SW=np.zeros((n, t), np.float32), senti=np.ones(n, np.float32),
        ids=list(range(n)))
    masks = dict(
        x_drop=torch.tensor((rng.random((5, t, 12)) < 0.5) * 2.0,
                            dtype=torch.float32),
        y_drop=torch.tensor((rng.random((5, t, 16)) < 0.5) * 2.0,
                            dtype=torch.float32),
        forced=(torch.tensor(rng.random((5, t)) < semi, dtype=torch.float32)
                if semi < 1 else None))
    idx = torch.tensor([4, 0, 8, 2, 6])
    out = {}
    for dev in ("cpu", device):
        params = _senticap_params(dev, vocab, 12, 16, seed=8)
        tx = ssolver.make_solver(conf)
        step = make_base_step(conf, tx, device=dev)
        _, _, loss = step(params, tx.init(params), sio.device_dataset(ds, dev),
                          idx.to(dev), **{k: None if m is None else m.to(dev)
                                          for k, m in masks.items()})
        out[str(dev)] = (loss, params)
    torch.cuda.synchronize()
    cpu_loss, cpu_p = out["cpu"]
    card_loss, card_p = out[str(device)]
    torch.testing.assert_close(card_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    for k in cpu_p:
        torch.testing.assert_close(card_p[k].cpu(), cpu_p[k], rtol=0,
                                   atol=1e-4)


def test_cuda_entry_points_turn_tf32_off(device):
    """Building a CUDA engine (and any entry point that resolves a CUDA
    device) leaves both TF32 flags False."""
    from icee_tpu_torch.core.config import DecoderConfig, EncoderConfig
    from icee_tpu_torch.serve.config import ServeConfig
    from icee_tpu_torch.serve.engine import CaptionEngine

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    CaptionEngine(ServeConfig(), smoke_mode=True, device=device,
                  dec_cfg=DecoderConfig(vocab_size=8, embed_size=4,
                                        hidden_size=4, factored_size=4),
                  enc_cfg=EncoderConfig(embed_size=4))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# K9's and K10's products alone, at the decode's shapes (64 images x beam
# 20 rows) and ragged ones (M, N, K off the tiles): (paths, M, K, N, bias)
SB_PRODUCT_CASES = {
    "k9_cell": (1, 1280, 1024, 2048, False),
    "k9_head": (1, 1280, 512, 8800, True),
    "k10_cells": (2, 1280, 1024, 2048, False),
    "k10_heads": (2, 1280, 512, 8800, True),
    "ragged": (1, 77, 45, 130, True),
    "ragged_two": (2, 129, 33, 65, True),
}


@pytest.mark.parametrize("case", sorted(SB_PRODUCT_CASES))
@pytest.mark.parametrize("splits", [1, 2])
def test_senticap_products_match_float64_and_keep_their_bits(device, case,
                                                             splits):
    """The product K9 and K10 launch every step (planes of the weights,
    3xTF32 by wgmma) against float64, in one k range or two (the cells'
    split, its partial sums added in range order; no bias then): its error
    at most 4x that of gemm_f32.cuh's product on the same inputs, the same
    bits twice, the planes the plain layout's bits, and within that bound
    plus the emulation's own error of its plain emulation."""
    from icee_tpu_torch.ops import senticap_decode as sd

    paths, m, k, n, bias = SB_PRODUCT_CASES[case]
    bias = bias and splits == 1
    rng = np.random.default_rng(m + k + n)
    a = torch.tensor(rng.uniform(-1, 1, (paths, m, k)), dtype=torch.float32,
                     device=device)
    w = torch.tensor(0.05 * rng.standard_normal((paths, k, n)),
                     dtype=torch.float32, device=device)
    b = (torch.tensor(rng.standard_normal((paths, n)), dtype=torch.float32,
                      device=device) if bias else None)
    before = sd.prepare_weights.launches
    planes = torch.stack([sd.prepare_weights(w[z]) for z in range(paths)])
    assert sd.prepare_weights.launches == before + paths
    assert torch.equal(planes[-1].cpu(),
                       sd.prepare_weights_plain(w[-1].cpu()))
    if paths == 1:
        a, w, planes = a[0], w[0], planes[0]
        b = b[0] if bias else None
    before = sd.planes_product.launches
    got = sd.planes_product(a, planes, n, b, splits=splits)
    again = sd.planes_product(a, planes, n, b, splits=splits)
    f32 = att_scan.f32_product(a, w, "N", b)
    plain = sd.planes_product_plain(a.cpu(), planes.cpu(), n,
                                    None if b is None else b.cpu())
    ref = a.double() @ w.double()
    if bias:
        ref = ref + (b.double()[:, None] if paths == 2 else b.double())
    torch.cuda.synchronize()
    assert sd.planes_product.launches == before + 2
    assert torch.equal(got, again)
    err = (got.double() - ref).abs().max().item()
    err_f32 = (f32.double() - ref).abs().max().item()
    err_plain = (plain.double() - ref.cpu()).abs().max().item()
    assert 0.0 < err_f32 and err <= 4.0 * err_f32, (err, err_f32)
    assert (got.cpu() - plain).abs().max().item() <= 4.0 * err_f32 + err_plain


def _selection_rows(vocab):
    """nll rows: random softmax rows of several sharpnesses (saturated on
    the plateau), the whole plateau, three tokens off it, equal nll at
    scattered tokens, -0 beside +0, integer values with many repeats."""
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((4, vocab)) * np.array([[1], [8], [60],
                                                         [200]])
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    rows = list(-np.log2(p.astype(np.float32) + np.float32(1e-37)))
    plateau = np.float32(-np.log2(np.float32(1e-37)))
    rows.append(np.full(vocab, plateau))
    r = np.full(vocab, plateau)
    r[[vocab - 1, 4, vocab // 2]] = [2.0, 9.0, 2.0]
    rows.append(r)
    r = rng.uniform(3.0, 30.0, vocab)
    r[rng.choice(vocab, 5, replace=False)] = 1.25
    rows.append(r)
    r = rng.uniform(1.0, 30.0, vocab)
    r[[vocab // 3, 5]] = [-0.0, 0.0]
    rows.append(r)
    rows.append(rng.integers(0, 4, vocab).astype(np.float64))
    return torch.tensor(np.stack(rows), dtype=torch.float32)


@pytest.mark.parametrize("vocab,k", [(40, 1), (40, 5), (40, 40), (300, 20),
                                     (8800, 1), (8800, 20), (8800, 164),
                                     (257, 256)])
def test_row_selection_kernel_matches_its_emulation(device, vocab, k):
    """The row selection K9 and K10 run (one block a row: the threads'
    minima, the threshold, the survivors, their order), alone, against
    its plain emulation and a stable sort: the same tokens and nll bits."""
    from icee_tpu_torch.ops import senticap_decode as sd

    nll = _selection_rows(vocab)
    before = sd.row_topk.launches
    got_nll, got_tok = sd.row_topk(nll.to(device), k)
    torch.cuda.synchronize()
    assert sd.row_topk.launches == before + 1
    want_nll, want_tok = sd.row_topk_plain(nll, k)
    s = torch.sort(nll, dim=1, stable=True)
    assert torch.equal(want_tok.long(), s.indices[:, :k])
    assert torch.equal(got_tok.cpu(), want_tok)
    assert torch.equal(got_nll.cpu(), want_nll)


def test_senticap_wrappers_raise_on_what_the_kernels_do_not_take(device):
    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_scan as ss

    w = torch.randn((20, 32), device=device)
    x = torch.randn((2, 3, 12), device=device)
    h_seq, c_seq, gates = ss.senticap_scan_fwd(w, x)
    with pytest.raises(ValueError, match="gates"):
        ss.senticap_scan_bwd(w, x, h_seq, c_seq, h_seq, 5.0)
    with pytest.raises(ValueError, match="expected cuda"):
        ss.senticap_scan_fwd(w.cpu(), x)
    params = _senticap_params(device, 40, 16, 16)
    with pytest.raises(ValueError, match="expected cuda"):
        sd.mega_senticap_beam_decode(params, torch.zeros((1, 24)), 1,
                                     beam_size=2)
    with pytest.raises(ValueError, match="BATCH_NORM"):
        sd.mega_senticap_beam_decode(
            dict(params, gamma_h=torch.ones(32, device=device)),
            torch.zeros((1, 24), device=device), 1, beam_size=2)


def test_senticap_searches_refuse_a_beam_above_the_row_pass(device):
    """A beam above the row top-k's 256 threads, or one whose selection
    block would need more shared memory than a block has, raises on the
    card before any launch (the CPU route takes it)."""
    from icee_tpu_torch.ops import senticap_decode as sd
    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    params = _senticap_params(device, 400, 16, 16)
    v = torch.zeros((1, 24), device=device)
    before = sd.mega_senticap_beam_decode.launches
    with pytest.raises(ValueError, match="row top-k"):
        sd.mega_senticap_beam_decode(params, v, 1, beam_size=300)
    with pytest.raises(ValueError, match="shared memory"):
        sd.mega_senticap_beam_decode(params, v, 1, beam_size=200)
    assert sd.mega_senticap_beam_decode.launches == before
    sw = _switched_params(device, 400, 16, 16)
    with pytest.raises(ValueError, match="row top-k"):
        ssd.mega_senticap_switched_decode(sw, v, 1, beam_size=300)


def _switched_params(device, vocab, e, h, seed=0, vis=24, stop_bias=2.0,
                     zero_head=False):
    """Switched weights: the base set, duplicates + 0.3 N(0, 1), a gate
    spread off 0.5."""
    base = {k: t.cpu().numpy() for k, t in _senticap_params(
        "cpu", vocab, e, h, seed, vis, stop_bias, zero_head).items()}
    rng = np.random.default_rng(seed + 1)
    p = dict(base)
    for k, a in base.items():
        p[f"{k}_sw"] = (a + (0 if zero_head and k in ("w", "b") else 0.3)
                        * rng.standard_normal(a.shape)).astype(np.float32)
    p["att_w"] = (0.5 * rng.standard_normal((2 * h, 1))).astype(np.float32)
    p["att_b"] = np.zeros(1, np.float32)
    return bridge.to_torch(p, device=device)


@pytest.mark.parametrize("case", ["ragged", "one_image", "tied", "saturated",
                                  "beam1"])
def test_senticap_switched_beam_kernel_matches_plain(device, case):
    """K10 against its plain search, margin-aware: a ragged vocabulary and
    E != H over several images, one image at beam 20, all-tied zero heads
    (every step picks tokens 0, 1, 2, ... in index order) and saturated
    tails (the nll plateau ranked by index).  Where the tokens agree, the
    trace within 1e-5; where they differ, the kernel's sequence must tie
    the plain winner within 1e-4 (its score re-scored by the plain
    search's own step)."""
    from icee_tpu_torch.ops import senticap_switched_decode as ssd

    vocab, beam, batch, max_len, stop, e = 515, 5, 6, 7, 0, 12
    kw = dict(seed=3, stop_bias=4.0)
    if case == "one_image":
        vocab, beam, batch, e = 300, 20, 1, 16
    elif case == "beam1":
        beam = 1
    elif case == "tied":
        vocab, stop, e, kw = 64, 63, 16, dict(zero_head=True)
    params = _switched_params(device, vocab, e, 16, **kw)
    if case == "saturated":
        for k in ("b", "b_sw"):
            params[k].fill_(-200.0)
            params[k][:4] = torch.tensor([50.0, 49.0, 48.0, 47.0])
    g = torch.Generator(device=device).manual_seed(5)
    v = torch.randn((batch, 24), generator=g, device=device)
    before = ssd.mega_senticap_switched_decode.launches
    got = ssd.mega_senticap_switched_decode(
        params, v, batch, beam_size=beam, max_len=max_len, stop_token=stop)
    torch.cuda.synchronize()
    assert ssd.mega_senticap_switched_decode.launches == before + 1
    want = ssd.mega_senticap_switched_decode_plain(params, v, batch, beam,
                                                   max_len, stop)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    for i in range(batch):
        n = int(got[2][i])
        if n == int(want[2][i]) and torch.equal(got[1][i, :n],
                                                want[1][i, :n]):
            torch.testing.assert_close(got[3][i, :n], want[3][i, :n],
                                       rtol=0, atol=1e-5)
            assert not got[3][i, n:].any()
        else:
            assert abs(float(got[0][i]) - float(want[0][i])) <= 1e-4, i
    if case == "tied":
        assert got[1].tolist() == [[0] * (max_len + 1)] * batch
    if case == "ragged":
        assert len(set(got[2].tolist())) > 1
    again = ssd.mega_senticap_switched_decode(
        params, v, batch, beam_size=beam, max_len=max_len, stop_token=stop)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("v,t_chunk", [(301, None), (64, 3)])
def test_mixture_ce_kernel_path_matches_plain(device, v, t_chunk):
    """The mixture CE on the card (the forward row kernel and the CE grad
    rows) against its materialized plain version: the value, a sum, rtol
    1e-5, each gradient within 1e-5 x its largest magnitude, a floored
    token with zero gradient, the same bits twice; a frozen background
    head leaves the other gradients as they were."""
    from icee_tpu_torch.ops import chunked_loss as cl

    rng = np.random.default_rng(9)
    b, t, h = 5, 7, 12
    att = rng.uniform(0.05, 0.95, (b, t))
    a = [2 * rng.standard_normal((b, t, h)), 2 * rng.standard_normal(
        (b, t, h)), 1 - att, att, rng.standard_normal((h, v)),
         rng.standard_normal(v), rng.standard_normal((h, v)),
         rng.standard_normal(v)]
    a = [torch.tensor(x, dtype=torch.float32, device=device) for x in a]
    y = torch.tensor(rng.integers(0, v, (b, t)), device=device)
    w = torch.tensor(rng.uniform(0, 2, (b, t)), dtype=torch.float32,
                     device=device)
    a[5][3] = a[7][3] = -600.0
    y[0, 0] = 3
    out = {}
    for name, fn in (("kernel", cl.mixture_ce_from_hiddens),
                     ("again", cl.mixture_ce_from_hiddens),
                     ("plain", cl.mixture_ce_plain)):
        ta = [x.clone().requires_grad_(True) for x in a]
        before = (cl.mixture_ce_rows.launches, cl.ce_grad_rows.launches)
        loss = fn(*ta, y, w, t_chunk)
        out[name] = (loss, torch.autograd.grad(loss, ta))
        if name == "kernel":   # the backward row pass is ce_grad_rows
            assert cl.mixture_ce_rows.launches > before[0]
            assert cl.ce_grad_rows.launches > before[1]
    torch.cuda.synchronize()
    (kl, kg), (al, ag), (pl, pg) = out["kernel"], out["again"], out["plain"]
    assert torch.equal(kl, al) and all(torch.equal(x, z)
                                       for x, z in zip(kg, ag))
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0)
    for i, (x, z) in enumerate(zip(kg, pg)):
        assert (x - z).abs().max() <= 1e-5 * z.abs().max(), i
    assert kg[2][0, 0] == 0 and kg[3][0, 0] == 0
    ta = [x.clone().requires_grad_(i not in (0, 4, 5))
          for i, x in enumerate(a)]
    loss = cl.mixture_ce_from_hiddens(*ta, y, w, t_chunk)
    live = [i for i in range(8) if ta[i].requires_grad]
    for i, g in zip(live, torch.autograd.grad(loss, [ta[i] for i in live])):
        torch.testing.assert_close(g, kg[i], rtol=0, atol=0)


def test_senticap_switched_step_on_the_card_matches_the_cpu(device):
    """One switch-training step on the card (two K8 scans, the background
    one without autograd, and the mixture CE kernels) against the same
    step on the CPU with the same masks.  Tolerances: loss rtol 1e-5;
    params atol 1e-4 (the RMSProp update magnifies grad rounding by up to
    10); the frozen weights bit-identical."""
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import solver as ssolver
    from icee_tpu_torch.senticap import switched as sw
    from icee_tpu_torch.senticap.config import senticap_conf
    from icee_tpu_torch.senticap.train import make_switched_step

    conf = senticap_conf(emb_size=12, lstm_hidden_size=16, visual_size=24,
                         MAX_SENTENCE_LEN=6, batch_size_val=5)
    rng = np.random.default_rng(7)
    n, t, vocab = 9, 7, 40
    ds = sio.SentiDataset(
        X=rng.integers(0, vocab, (n, t)).astype(np.int32),
        Y=rng.integers(0, vocab, (n, t)).astype(np.int32),
        Xlen=(np.arange(t)[None] < rng.integers(2, t, (n, 1))).astype(
            np.float32),
        V=rng.standard_normal((n, 24)).astype(np.float32),
        SW=(rng.random((n, t)) < 0.2).astype(np.float32),
        senti=np.ones(n, np.float32), ids=list(range(n)))
    masks = dict(
        x_drop=torch.tensor((rng.random((5, t, 12)) < 0.5) * 2.0,
                            dtype=torch.float32),
        y_drop=torch.tensor((rng.random((5, t, 16)) < 0.5) * 2.0,
                            dtype=torch.float32))
    idx = torch.tensor([4, 0, 8, 2, 6])
    out = {}
    for dev in ("cpu", device):
        params = _switched_params(dev, vocab, 12, 16, seed=8)
        tx = ssolver.make_solver(conf, sw.switch_param_mask(params))
        step = make_switched_step(conf, tx, device=dev)
        _, _, loss = step(params, tx.init(params),
                          sio.device_dataset(ds, dev), idx.to(dev),
                          **{k: m.to(dev) for k, m in masks.items()})
        out[str(dev)] = (loss, params)
    torch.cuda.synchronize()
    cpu_loss, cpu_p = out["cpu"]
    card_loss, card_p = out[str(device)]
    torch.testing.assert_close(card_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    start = _switched_params("cpu", vocab, 12, 16, seed=8)
    for k in cpu_p:
        torch.testing.assert_close(card_p[k].cpu(), cpu_p[k], rtol=0,
                                   atol=1e-4)
        if k in sw.BASE_NAMES:
            assert torch.equal(card_p[k].cpu(), start[k]), k


def test_switched_wrapper_raises_on_what_the_kernel_does_not_take(device):
    """On CUDA tensors K10's wrapper launches or raises: a wrong dtype, a
    conf outside DA_SUM, a tensor left on the CPU."""
    from icee_tpu_torch.ops import senticap_switched_decode as ssd
    from icee_tpu_torch.senticap.config import senticap_conf

    params = _switched_params(device, 40, 16, 16)
    v = torch.zeros((1, 24), device=device)
    before = ssd.mega_senticap_switched_decode.launches
    with pytest.raises(TypeError, match="w_sw"):
        ssd.mega_senticap_switched_decode(
            dict(params, w_sw=params["w_sw"].double()), v, 1, beam_size=2)
    with pytest.raises(ValueError, match="DA_SUM"):
        ssd.mega_senticap_switched_decode(
            params, v, 1, beam_size=2,
            conf=senticap_conf(DOMAIN_ADAPT="da_similar_param"))
    with pytest.raises(ValueError, match="expected cuda"):
        ssd.mega_senticap_switched_decode(dict(params, att_w=params[
            "att_w"].cpu()), v, 1, beam_size=2)
    assert ssd.mega_senticap_switched_decode.launches == before
