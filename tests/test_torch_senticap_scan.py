"""K8: the port's SentiCap training scan vs the JAX package's.

The JAX side runs its Pallas kernel ``fused_senticap_scan`` in interpret mode
(``interpret=True``) where the batch is a multiple of 8, and its XLA oracle
``reference_senticap_scan`` always (at b % 8 != 0 there is no JAX kernel);
gradients come from ``jax.vjp``, at gclip 5.0 and at 0.01, where the clamp
on the recurrent dh binds.  On the CPU the port's wrappers take their plain
versions (the CUDA kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Inputs come from
``numpy.random.default_rng``.

Tolerances: the forward atol = rtol = 1e-5 (float32 on both sides, BLAS sums
in other orders); gradients atol = rtol = 2e-4 (errors grow through T
reverse steps of products, as for K3 and K4); the plain explicit backward
against autograd of the plain forward 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops.pallas_senticap_train import fused_senticap_scan as jscan
from icee_tpu.ops.pallas_senticap_train import reference_senticap_scan
from icee_tpu_torch.ops import senticap_scan

torch.set_num_threads(2)
T, E, H = 5, 12, 8
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, b, scale=0.4, t=T, e=E, h=H):
    rng = np.random.default_rng(seed)
    w = (scale * rng.standard_normal((e + h, 4 * h))).astype(np.float32)
    x = rng.standard_normal((b, t, e)).astype(np.float32)
    dh = rng.standard_normal((b, t, h)).astype(np.float32)
    return w, x, dh


@pytest.mark.parametrize("b", [16, 3])
def test_forward_matches_pallas_and_reference(b):
    w, x, _ = _inputs(b, b)
    want_r = np.asarray(reference_senticap_scan(jnp.asarray(w),
                                                jnp.asarray(x)))
    got = senticap_scan.fused_senticap_scan(torch.tensor(w), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want_r, rtol=1e-5, atol=1e-5)
    if b % 8 == 0:
        want_k = np.asarray(jscan(jnp.asarray(w), jnp.asarray(x), 5.0, None,
                                  True))
        np.testing.assert_allclose(got.numpy(), want_k, rtol=1e-5, atol=1e-5)
    h_seq, c_seq, gates = senticap_scan.senticap_scan_fwd(torch.tensor(w),
                                                          torch.tensor(x))
    assert gates is None    # the CPU runs the plain scan
    np.testing.assert_array_equal(h_seq.numpy(), got.numpy())
    assert c_seq.shape == h_seq.shape


@pytest.mark.parametrize("b,gclip", [(16, 5.0), (16, 0.01), (3, 0.01)])
def test_grads_match_jax_vjp(b, gclip):
    """dw and dx of the port's autograd Function (its explicit plain
    backward on the CPU) vs ``jax.vjp`` of the Pallas kernel (b % 8 == 0)
    and of the XLA oracle."""
    w, x, dh = _inputs(10 + b, b, scale=1.2)
    fns = [lambda w_, x_: reference_senticap_scan(w_, x_, gclip)]
    if b % 8 == 0:
        fns.append(lambda w_, x_: jscan(w_, x_, gclip, 8, True))
    tw = torch.tensor(w, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    h = senticap_scan.fused_senticap_scan(tw, tx, gclip)
    got_w, got_x = torch.autograd.grad(h, (tw, tx), torch.tensor(dh))
    for fn in fns:
        _, vjp = jax.vjp(fn, jnp.asarray(w), jnp.asarray(x))
        want_w, want_x = vjp(jnp.asarray(dh))
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   **GRAD_TOL)


def test_clamp_binds_at_small_gclip():
    """At gclip 0.01 the clamp changes the gradient (so a misplaced clamp
    cannot pass the test above), and at 5.0 the output cotangent is not
    clamped: dh of the last step reaches dx unclipped."""
    w, x, dh = _inputs(26, 16, scale=1.2)
    tw, tx = torch.tensor(w), torch.tensor(x)
    h_seq, c_seq, _ = senticap_scan.senticap_scan_fwd(tw, tx)
    tight = senticap_scan.senticap_scan_bwd_plain(tw, tx, h_seq, c_seq,
                                                  torch.tensor(dh), 0.01)
    loose = senticap_scan.senticap_scan_bwd_plain(tw, tx, h_seq, c_seq,
                                                  torch.tensor(dh), 1e9)
    assert not torch.allclose(tight[1], loose[1])
    # the last step's dx sees only the output cotangent: equal in both
    np.testing.assert_allclose(tight[0][:, -1].numpy(),
                               loose[0][:, -1].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("gclip", [5.0, 0.01])
def test_plain_backward_matches_autograd_of_plain_forward(gclip):
    w, x, dh = _inputs(31, 5, scale=1.2)
    tw = torch.tensor(w, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    h_seq, c_seq = senticap_scan.fused_senticap_scan_plain(tw, tx, gclip)
    want_w, want_x = torch.autograd.grad(h_seq, (tw, tx), torch.tensor(dh))
    got_x, got_w = senticap_scan.senticap_scan_bwd(
        tw.detach(), tx.detach(), h_seq.detach(), c_seq.detach(),
        torch.tensor(dh), gclip)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), want_x.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_check_inputs():
    w, x, _ = _inputs(40, 4)
    with pytest.raises(ValueError, match="w_lstm"):
        senticap_scan.senticap_scan_fwd(torch.tensor(w[:-1]), torch.tensor(x))
    with pytest.raises(TypeError, match="dtype"):
        senticap_scan.senticap_scan_fwd(torch.tensor(w).double(),
                                        torch.tensor(x))
