"""K3: the port's fused training scan vs the JAX package's.

The JAX side runs its Pallas kernel in interpret mode (``interpret=True``)
and its XLA oracle ``reference_scan``; on the CPU the port's wrappers take
their plain versions (the CUDA kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Inputs come from
``numpy.random.default_rng``; weights move through ``icee_tpu_torch.bridge``.

Tolerances: the forward atol 1e-5 (float32 on both sides, BLAS sums in other
orders); gradients atol = rtol = 2e-4, as ``tests/test_pallas_lstm.py`` holds
the Pallas backward against ``jax.grad`` (errors grow through T reverse
steps of products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.ops.pallas_lstm import fused_factored_scan as jscan
from icee_tpu.ops.pallas_lstm import reference_scan
from icee_tpu_torch import bridge
from icee_tpu_torch.ops import lstm_scan

torch.set_num_threads(2)
KEYS = lstm_scan.CELL_KEYS
B, T, E, F, H = 8, 5, 24, 32, 40
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _params(seed, style=1, e=E, f=F, h=H, styles=4):
    cfg = JDecoderConfig(vocab_size=64, embed_size=e, hidden_size=h,
                         factored_size=f, num_styles=styles)
    full = jax.tree.map(np.asarray,
                        jfl.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("V_b", "S_b", "U_b", "W_b"):   # non-zero biases
        full[name] = (0.1 * rng.standard_normal(full[name].shape)
                      ).astype(np.float32)
    sliced = {k: full[k] for k in KEYS}
    sliced["S_w"] = full["S_w"][style]
    sliced["S_b"] = full["S_b"][style]
    return full, sliced


def test_scan_forward_matches_pallas_and_reference():
    _, p = _params(0)
    x = np.random.default_rng(1).standard_normal((B, T, E)).astype(np.float32)
    want_k = np.asarray(jscan(p, jnp.asarray(x), True))
    want_r = np.asarray(reference_scan(p, jnp.asarray(x)))
    tp = bridge.to_torch(p)
    got = lstm_scan.fused_factored_scan(tp, torch.tensor(x)).numpy()
    h_plain, _ = lstm_scan.fused_factored_scan_plain(tp, torch.tensor(x))
    np.testing.assert_allclose(got, want_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, h_plain.numpy())


def test_scan_grads_match_pallas_backward():
    _, p = _params(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    tgt = rng.standard_normal((B, T, H)).astype(np.float32)

    def jloss(p, x):
        h = jscan(p, x, True)
        return jnp.sum((h - tgt) ** 2) + 0.1 * jnp.sum(h[:, -1] ** 3)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in bridge.to_torch(p).items()}
    tx = torch.tensor(x, requires_grad=True)
    h = lstm_scan.fused_factored_scan(tp, tx)
    tt = torch.tensor(tgt)
    (((h - tt) ** 2).sum() + 0.1 * (h[:, -1] ** 3).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for k in KEYS:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   err_msg=k, **GRAD_TOL)


def test_plain_backward_matches_autograd_of_plain_scan():
    _, p = _params(4)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((3, 6, E)).astype(np.float32))
    dh = torch.tensor(rng.standard_normal((3, 6, H)).astype(np.float32))
    tp = {k: v.requires_grad_(True) for k, v in bridge.to_torch(p).items()}
    tx = x.clone().requires_grad_(True)
    h_seq, c_seq = lstm_scan.fused_factored_scan_plain(tp, tx)
    (h_seq * dh).sum().backward()
    with torch.no_grad():
        dx, grads = lstm_scan.factored_scan_bwd(
            {k: v.detach() for k, v in tp.items()}, x, h_seq.detach(),
            c_seq.detach(), dh)
    torch.testing.assert_close(dx, tx.grad, rtol=1e-5, atol=1e-5)
    for k in KEYS:
        torch.testing.assert_close(grads[k], tp[k].grad, rtol=1e-5,
                                   atol=1e-5, msg=k)


def test_style_slice_grads_scatter_into_the_stack():
    full, _ = _params(6, e=16, f=16, h=24)
    style = 2
    tfull = {k: v.requires_grad_(True)
             for k, v in bridge.to_torch(full).items()}
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (3, 4, 16)).astype(np.float32))
    sliced = {k: tfull[k] for k in KEYS}
    sliced["S_w"] = tfull["S_w"][style]
    sliced["S_b"] = tfull["S_b"][style]
    (lstm_scan.fused_factored_scan(sliced, x) ** 2).sum().backward()
    for name in ("S_w", "S_b"):
        g = tfull[name].grad
        assert torch.count_nonzero(g[style]) > 0
        others = [s for s in range(g.shape[0]) if s != style]
        assert torch.count_nonzero(g[others]) == 0


def test_scan_wrappers_check_their_inputs():
    _, p = _params(0)
    tp = bridge.to_torch(p)
    with pytest.raises(ValueError, match="shape"):
        lstm_scan.factored_scan_fwd(tp, torch.zeros((2, 3, E + 1)))
    with pytest.raises(TypeError, match="dtype"):
        lstm_scan.factored_scan_fwd(tp, torch.zeros((2, 3, E),
                                                    dtype=torch.float64))
