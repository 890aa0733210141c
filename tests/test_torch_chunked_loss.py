"""The chunked cross-entropy: the port's vs the JAX package's.

Value and grads (hiddens, C_w, C_b) of ``masked_ce_from_hiddens`` against
JAX's, with a ``t_chunk`` that does not divide T, a False ``sample_mask``
row and a length of 0; the clamp variant through
``masked_sum_ce_from_hiddens``; and equality with the port's materialized
``masked_cross_entropy``.  On the CPU the row-pass wrappers take their plain
versions (the CUDA kernels are held against them on the card).

Tolerances: float32 on both sides, sums in other orders: the value to 1e-6,
grads to 1e-6 absolute (they are O(1e-2) for a token mean).
"""

import jax
import numpy as np
import pytest
import torch

from icee_tpu.ops import chunked_loss as jcl
from icee_tpu_torch.evaluation.metrics import masked_cross_entropy
from icee_tpu_torch.ops import chunked_loss as cl

torch.set_num_threads(2)
B, T, HD, V = 5, 7, 12, 37
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    hid = rng.standard_normal((B, T, HD)).astype(np.float32)
    w = (0.5 * rng.standard_normal((HD, V))).astype(np.float32)
    b = (0.1 * rng.standard_normal((V,))).astype(np.float32)
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    lens = np.array([7, 3, 0, 5, 6], np.int32)
    smask = np.array([True, True, True, False, True])
    return hid, w, b, tgt, lens, smask


def _torch_grads(fn, hid, w, b):
    th, tw, tb = (torch.tensor(a, requires_grad=True) for a in (hid, w, b))
    loss = fn(th, tw, tb)
    loss.backward()
    return loss.detach().numpy(), th.grad.numpy(), tw.grad.numpy(), \
        tb.grad.numpy()


@pytest.mark.parametrize("t_chunk", [None, 3, 7])
def test_masked_ce_matches_jax_and_materialized(t_chunk):
    hid, w, b, tgt, lens, smask = _inputs(t_chunk or 0)

    def jloss(h, w_, b_):
        return jcl.masked_ce_from_hiddens(h, w_, b_, tgt, lens, smask,
                                          t_chunk)

    want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(hid, w, b)
    tt, tl, ts = (torch.tensor(a) for a in (tgt, lens, smask))
    got = _torch_grads(lambda h, w_, b_: cl.masked_ce_from_hiddens(
        h, w_, b_, tt, tl, ts, t_chunk), hid, w, b)
    mat = _torch_grads(lambda h, w_, b_: masked_cross_entropy(
        h @ w_ + b_, tt, tl, ts), hid, w, b)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[0], mat[0], **TOL)
    for g, jg, mg in zip(got[1:], want[1], mat[1:]):
        np.testing.assert_allclose(g, np.asarray(jg), **TOL)
        np.testing.assert_allclose(g, mg, **TOL)
    # the padded and masked rows get no gradient
    assert not got[1][2].any() and not got[1][3].any()


def test_clamped_sum_ce_matches_jax():
    hid, w, b, tgt, lens, _ = _inputs(11)
    hid = 4.0 * hid                      # some nll above the clamp
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    clamp = 3.0

    def jloss(h, w_, b_):
        return jcl.masked_sum_ce_from_hiddens(h, w_, b_, tgt, mask, clamp, 4)

    want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(hid, w, b)
    tt, tm = torch.tensor(tgt), torch.tensor(mask)
    got = _torch_grads(lambda h, w_, b_: cl.masked_sum_ce_from_hiddens(
        h, w_, b_, tt, tm, clamp, 4), hid, w, b)
    logits = hid @ w + b
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    nll = lse - np.take_along_axis(logits, tgt[..., None], -1)[..., 0]
    assert ((nll > clamp) & (mask > 0)).any()     # the clamp bites
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6,
                               atol=1e-5)
    for g, jg in zip(got[1:], want[1]):
        np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_row_pass_wrappers_match_plain_and_check_inputs():
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.standard_normal((6, 10)).astype(np.float32))
    tgt = torch.tensor([0, 9, 3, 10, -1, 4])        # two outside [0, V)
    wts = torch.tensor(rng.random(6).astype(np.float32))
    lse, contrib = cl.ce_rows(logits, tgt, wts)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    assert contrib[3] == wts[3] * lse[3] and contrib[4] == wts[4] * lse[4]
    db = torch.zeros(10)
    dl = cl.ce_grad_rows(logits.clone(), tgt, wts, lse,
                         torch.tensor([2.0]), db)
    want = (torch.softmax(logits, -1) - torch.nn.functional.one_hot(
        tgt.clamp(0, 9), 10) * ((tgt >= 0) & (tgt < 10))[:, None]) \
        * (2.0 * wts)[:, None]
    torch.testing.assert_close(dl, want)
    torch.testing.assert_close(db, want.sum(0))
    with pytest.raises(TypeError, match="dtype"):
        cl.ce_rows(logits, tgt.int(), wts)
    assert cl.auto_t_chunk(96, 25) == 22 and cl.auto_t_chunk(64, 25) == 25
