"""K1 (``icee_tpu_torch.ops.decode_step``) on the CPU — its plain version —
vs the JAX kernel ``fused_decode_step_topk`` in interpret mode and the XLA
oracle ``reference_step_topk``, on the same weights and inputs.

Top-k ids are exact (ties to the lowest index on both sides); values, h'
and c' to atol = rtol = 1e-5 (float32, different CPU summation orders).
The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.ops.pallas_decode import (fused_decode_step_topk,
                                        reference_step_topk)
from icee_tpu_torch import bridge
from icee_tpu_torch.ops.decode_step import decode_step_topk

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(vocab, seed=0, e=32, h=64, rows=16):
    cfg = DecoderConfig(vocab_size=vocab, embed_size=e, hidden_size=h,
                        factored_size=h)
    jp = jax.tree.map(np.asarray, jfl.init_params(jax.random.PRNGKey(seed),
                                                  cfg))
    rng = np.random.default_rng(seed)
    x, hh, c = (rng.standard_normal((rows, d)).astype(np.float32)
                for d in (e, h, h))
    return jp, x, hh, c


def _port(jp, x, h, c, style, ktop=5):
    tp = bridge.to_torch(jp)
    out = decode_step_topk(tp, torch.tensor(x), torch.tensor(h),
                           torch.tensor(c), style, ktop=ktop)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("style", [0, 3])
@pytest.mark.parametrize("vocab,v_tile", [(512, 128), (520, 128)])
def test_plain_step_matches_jax_kernel_and_reference(style, vocab, v_tile):
    """Includes a ragged vocab (520 is not a multiple of the tile)."""
    jp, x, h, c = _setup(vocab, seed=style)
    got_v, got_i, got_h, got_c = _port(jp, x, h, c, style)
    for want in (
            fused_decode_step_topk(jp, x, h, c, jnp.asarray(style), ktop=5,
                                   row_block=16, v_tile=v_tile,
                                   interpret=True),
            reference_step_topk(jp, x, h, c, jnp.asarray(style))):
        want_v, want_i, want_h, want_c = map(np.asarray, want)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, want_v, **TOL)
        np.testing.assert_allclose(got_h, want_h, **TOL)
        np.testing.assert_allclose(got_c, want_c, **TOL)
    assert got_i.dtype == np.int32 and got_v.dtype == np.float32


def test_plain_step_takes_ktop_10_as_the_jax_kernel_does():
    """Above the CUDA kernels' narrow paths (K_MAX = 8): the CPU route
    answers as JAX."""
    jp, x, h, c = _setup(512, seed=4)
    got_v, got_i, got_h, got_c = _port(jp, x, h, c, 1, ktop=10)
    want_v, want_i, want_h, want_c = map(np.asarray, fused_decode_step_topk(
        jp, x, h, c, jnp.asarray(1), ktop=10, row_block=16, v_tile=128,
        interpret=True))
    assert got_i.shape == (16, 10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, **TOL)
    np.testing.assert_allclose(got_h, want_h, **TOL)
    np.testing.assert_allclose(got_c, want_c, **TOL)


def _tie_pairs(jp):
    """Copies of the head's columns in pairs (2j + 1 := 2j): every row's
    logits tie in pairs, so each top-k crosses ties it breaks by the
    lowest id."""
    jp = dict(jp, C_w=np.array(jp["C_w"]), C_b=np.array(jp["C_b"]))
    jp["C_w"][:, 1::2] = jp["C_w"][:, 0::2]
    jp["C_b"][1::2] = jp["C_b"][0::2]
    return jp


@pytest.mark.parametrize("ktop", [20, 64])
def test_wide_top_k_on_tied_rows_matches_the_jax_kernel(ktop):
    """The widths the CUDA kernel takes on its wide paths (9 to 256): the
    CPU route's ids equal the JAX kernel's (interpret mode, V = 128) on
    rows whose logits tie in pairs, values within 1e-5."""
    jp, x, h, c = _setup(128, seed=8)
    jp = _tie_pairs(jp)
    got_v, got_i, got_h, got_c = _port(jp, x, h, c, 2, ktop=ktop)
    want_v, want_i, want_h, want_c = map(np.asarray, fused_decode_step_topk(
        jp, x, h, c, jnp.asarray(2), ktop=ktop, row_block=16, v_tile=128,
        interpret=True))
    assert got_i.shape == (16, ktop)
    # the ties are there: each pair's ids side by side, the lower first
    assert (got_v[:, 0::2] == got_v[:, 1::2]).all()
    assert (got_i[:, 1::2] == got_i[:, 0::2] + 1).all()
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_h, want_h, **TOL)
    np.testing.assert_allclose(got_c, want_c, **TOL)


@pytest.mark.parametrize("ktop", [300, 512])
def test_top_k_past_one_block_matches_the_jax_reference(ktop):
    """Top-ks the CUDA kernel selects with its survivors in device memory
    (above 256, up to V = 512): the CPU route's ids equal JAX's XLA
    ``reference_step_topk`` on rows whose logits tie in pairs (the lower id
    first), values within 1e-5."""
    jp, x, h, c = _setup(512, seed=9, rows=6)
    jp = _tie_pairs(jp)
    got_v, got_i, got_h, got_c = _port(jp, x, h, c, 1, ktop=ktop)
    want_v, want_i, want_h, want_c = map(np.asarray, reference_step_topk(
        jp, x, h, c, jnp.asarray(1), ktop=ktop))
    assert got_i.shape == (6, ktop)
    assert (got_i[:, 1::2] == got_i[:, 0::2] + 1).all()
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_h, want_h, **TOL)
    np.testing.assert_allclose(got_c, want_c, **TOL)


def test_all_tied_logits_pick_lowest_ids():
    """Zero head: every vocab entry ties; ids must be 0..k-1 like lax.top_k
    (as tests/test_pallas.py::test_fused_step_tie_breaking)."""
    jp, x, _, _ = _setup(256, seed=1, e=16, h=32, rows=8)
    jp["C_w"] = np.zeros_like(jp["C_w"])
    jp["C_b"] = np.zeros_like(jp["C_b"])
    h = np.zeros((8, 32), np.float32)
    got_v, got_i, _, _ = _port(jp, x, h, h, 0)
    want_v, want_i, _, _ = fused_decode_step_topk(
        jp, x, h, h, jnp.asarray(0), ktop=5, row_block=8, v_tile=64,
        interpret=True)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_array_equal(got_i, np.tile(np.arange(5), (8, 1)))
    np.testing.assert_allclose(got_v, -np.log(256.0), rtol=1e-5)


def test_wrapper_rejects_bad_inputs():
    jp, x, h, c = _setup(128, rows=4)
    tp = bridge.to_torch(jp)
    xt, ht, ct = torch.tensor(x), torch.tensor(h), torch.tensor(c)
    with pytest.raises(TypeError):
        decode_step_topk(tp, xt.double(), ht, ct, 0)
    with pytest.raises(ValueError):
        decode_step_topk(tp, xt[:, :10], ht, ct, 0)
    with pytest.raises(ValueError):
        decode_step_topk(tp, xt, ht.t().contiguous().t(), ct, 0)
    with pytest.raises(ValueError):
        decode_step_topk(tp, xt, ht, ct, 4)      # no such style
    with pytest.raises(ValueError):
        decode_step_topk(tp, xt, ht, ct, 0, ktop=0)
    # every route decodes any ktop up to V (the card's above 256:
    # tests/test_torch_cuda.py)
    vals, idx, _, _ = decode_step_topk(tp, xt, ht, ct, 0, ktop=9)
    assert vals.shape == idx.shape == (4, 9)
    bad = dict(tp, C_w=tp["C_w"].t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        decode_step_topk(bad, xt, ht, ct, 0)
