"""K4: the port's NIC training scan vs the JAX package's.

The JAX side runs its Pallas kernel in interpret mode (``interpret=True``)
and its XLA oracle ``reference_nic_scan``; on the CPU the port's wrappers take
their plain versions (the CUDA kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``), and the kernels' own
arithmetic (``scan_grid.nic_scan_tc_plain``) is held against the Pallas
kernel through 25 steps.  Inputs come from
``numpy.random.default_rng``.

Tolerances: the forward atol 1e-5 (float32 on both sides, BLAS sums in other
orders); gradients atol = rtol = 2e-4, as for K3 (errors grow through T
reverse steps of products); the plain backward against autograd of the plain
forward 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops.pallas_nic_train import fused_nic_scan as jscan
from icee_tpu.ops.pallas_nic_train import reference_nic_scan
from icee_tpu_torch import bridge
from icee_tpu_torch.ops import nic_scan

torch.set_num_threads(2)
KEYS = nic_scan.CELL_KEYS
T, E, H = 6, 24, 32
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _cell(seed, e=E, h=H):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"W_ih": w(e, 4 * h), "W_hh": w(h, 4 * h),
            "b_ih": w(4 * h, scale=0.1), "b_hh": w(4 * h, scale=0.1)}


def _x(seed, b, t=T, e=E):
    return np.random.default_rng(seed).standard_normal((b, t, e)).astype(
        np.float32)


@pytest.mark.parametrize("b", [16, 8])
def test_forward_matches_pallas_and_reference(b):
    cell, x = _cell(b), _x(b + 1, b)
    want_k = np.asarray(jscan(cell, jnp.asarray(x), None, True))
    want_r = np.asarray(reference_nic_scan(cell, jnp.asarray(x)))
    tc = bridge.to_torch(cell)
    got = nic_scan.fused_nic_scan(tc, torch.tensor(x)).numpy()
    h_plain, c_plain = nic_scan.fused_nic_scan_plain(tc, torch.tensor(x))
    np.testing.assert_allclose(got, want_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, h_plain.numpy())
    h_seq, c_seq, gates = nic_scan.nic_scan_fwd(tc, torch.tensor(x))
    assert gates is None    # the CPU runs the plain scan
    np.testing.assert_array_equal(c_seq.numpy(), c_plain.numpy())


@pytest.mark.parametrize("b,t", [(16, T), (5, 1)])
def test_grads_match_jax_grad_of_pallas_and_reference(b, t):
    """B = 5, T = 1: a batch that is no multiple of 8, and a single step."""
    cell, x = _cell(3 + b), _x(4 + b, b, t)
    kh = np.random.default_rng(5).standard_normal((b, t, H)).astype(
        np.float32)

    def loss(fn):
        return lambda c, xx: jnp.sum(fn(c, xx) * kh)

    wants = [jax.grad(loss(lambda c, xx: jscan(c, xx, None, True)),
                      argnums=(0, 1))(cell, jnp.asarray(x)),
             jax.grad(loss(reference_nic_scan), argnums=(0, 1))(
                 cell, jnp.asarray(x))]
    tc = {k: v.requires_grad_(True) for k, v in bridge.to_torch(cell).items()}
    tx = torch.tensor(x, requires_grad=True)
    (nic_scan.fused_nic_scan(tc, tx) * torch.tensor(kh)).sum().backward()
    for want in wants:
        for k in KEYS:
            np.testing.assert_allclose(tc[k].grad.numpy(),
                                       np.asarray(want[0][k]), err_msg=k,
                                       **GRAD_TOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[1]),
                                   **GRAD_TOL)


def test_scan_at_h_768_matches_pallas_forward_and_grads():
    """H = 768, a width past the card's resident plan (there the CUDA
    recurrence streams W_hh; on the CPU the wrapper's plain version runs):
    h against the Pallas kernel in interpret mode and the XLA oracle, the
    grads against ``jax.grad`` of the kernel, at the tolerances above.
    The weights' scale shrinks as 1 / sqrt(H) from ``_cell``'s at H = 32,
    so the gates see pre-activations of the same size."""
    h_dim, b = 768, 8
    rng = np.random.default_rng(31)

    def w(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    scale = 0.3 * (H / h_dim) ** 0.5
    cell = {"W_ih": w(E, 4 * h_dim, scale=0.3),
            "W_hh": w(h_dim, 4 * h_dim, scale=scale),
            "b_ih": w(4 * h_dim, scale=0.1), "b_hh": w(4 * h_dim, scale=0.1)}
    x = _x(32, b)
    kh = rng.standard_normal((b, T, h_dim)).astype(np.float32)
    want_k = np.asarray(jscan(cell, jnp.asarray(x), None, True))
    want_r = np.asarray(reference_nic_scan(cell, jnp.asarray(x)))
    want_g = jax.grad(lambda c, xx: jnp.sum(jscan(c, xx, None, True) * kh),
                      argnums=(0, 1))(cell, jnp.asarray(x))
    tc = {k: v.requires_grad_(True) for k, v in bridge.to_torch(cell).items()}
    tx = torch.tensor(x, requires_grad=True)
    h = nic_scan.fused_nic_scan(tc, tx)
    np.testing.assert_allclose(h.detach().numpy(), want_k, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), want_r, rtol=1e-5,
                               atol=1e-5)
    (h * torch.tensor(kh)).sum().backward()
    for k in KEYS:
        np.testing.assert_allclose(tc[k].grad.numpy(),
                                   np.asarray(want_g[0][k]), err_msg=k,
                                   **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[1]),
                               **GRAD_TOL)


def test_bias_grads_are_shared():
    """b_ih and b_hh receive the same gradient (z sees their sum), through
    the autograd function as through the JAX custom_vjp."""
    cell, x = _cell(6), _x(7, 8)
    tc = {k: v.requires_grad_(True) for k, v in bridge.to_torch(cell).items()}
    (nic_scan.fused_nic_scan(tc, torch.tensor(x)) ** 2).sum().backward()
    np.testing.assert_array_equal(tc["b_ih"].grad.numpy(),
                                  tc["b_hh"].grad.numpy())
    assert np.abs(tc["b_ih"].grad.numpy()).max() > 0
    g = jax.grad(lambda c: jnp.sum(jscan(c, jnp.asarray(x), None, True) ** 2))(
        cell)
    np.testing.assert_allclose(tc["b_hh"].grad.numpy(), np.asarray(g["b_hh"]),
                               **GRAD_TOL)


def test_plain_backward_matches_autograd_of_plain_forward():
    cell, x = _cell(8), _x(9, 12)
    dh = np.random.default_rng(10).standard_normal((12, T, H)).astype(
        np.float32)
    tc = {k: v.requires_grad_(True) for k, v in bridge.to_torch(cell).items()}
    tx = torch.tensor(x, requires_grad=True)
    h_seq, c_seq = nic_scan.fused_nic_scan_plain(tc, tx)
    (h_seq * torch.tensor(dh)).sum().backward()
    dx, grads = nic_scan.nic_scan_bwd_plain(
        {k: v.detach() for k, v in tc.items()}, tx.detach(), h_seq.detach(),
        c_seq.detach(), torch.tensor(dh))
    np.testing.assert_allclose(dx.numpy(), tx.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    for k in KEYS:
        np.testing.assert_allclose(grads[k].numpy(), tc[k].grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_kernel_arithmetic_matches_pallas_through_25_steps():
    """The CUDA kernels' arithmetic (``scan_grid.nic_scan_tc_plain`` and
    ``nic_scan_bwd_tc_plain``: 3xTF32 products, the recurrent dh as the
    plan's k ranges added in order) against the Pallas kernel in
    interpret mode and ``jax.grad`` of it, through T = 25 steps: h atol
    1e-4, each gradient within 1e-3 of its largest magnitude (K3's)."""
    from icee_tpu_torch.ops import scan_grid

    b, t = 6, 25
    cell, x = _cell(21), _x(22, b, t)
    cell["W_hh"] = (cell["W_hh"] * 0.5).astype(np.float32)
    kh = np.random.default_rng(23).standard_normal((b, t, H)).astype(
        np.float32)
    want_h = np.asarray(jscan(cell, jnp.asarray(x), None, True))
    want_g = jax.grad(lambda c, xx: jnp.sum(jscan(c, xx, None, True) * kh),
                      argnums=(0, 1))(cell, jnp.asarray(x))
    tc = bridge.to_torch(cell)
    h_seq, c_seq, acts = scan_grid.nic_scan_tc_plain(tc, torch.tensor(x))
    np.testing.assert_allclose(h_seq.numpy(), want_h, rtol=0, atol=1e-4)
    plan = scan_grid.scan_plan("K4", b, H)
    dx, grads = scan_grid.nic_scan_bwd_tc_plain(
        tc, torch.tensor(x), h_seq, c_seq, torch.tensor(kh), acts, plan)
    for got, want in [(dx, want_g[1])] + [(grads[k], want_g[0][k])
                                          for k in KEYS]:
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max(), err


def test_wrappers_check_their_inputs():
    tc = bridge.to_torch(_cell(11))
    with pytest.raises(ValueError, match="expected"):
        nic_scan.nic_scan_fwd(tc, torch.zeros((2, 3, E + 1)))
    with pytest.raises(ValueError, match="B, T, E"):
        nic_scan.nic_scan_fwd(tc, torch.zeros((2, E)))
    with pytest.raises(TypeError, match="dtype"):
        nic_scan.nic_scan_fwd(tc, torch.zeros((2, 3, E), dtype=torch.float64))
