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
        decode_step_topk(tp, xt, ht, ct, 0, ktop=9)
    bad = dict(tp, C_w=tp["C_w"].t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        decode_step_topk(bad, xt, ht, ct, 0)
