"""K5: the port's attention training scan vs the JAX package's.

The JAX side runs its Pallas kernels in interpret mode (``interpret=True``)
at batch tiles 8 and 16, and its XLA oracles ``reference_att_scan*``; on the
CPU the port's wrappers take their plain versions (the CUDA kernels are held
against those on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Sizes are the JAX test's
(``tests/test_pallas_att_train.py``), and T = 60 at A = 1024 (past one
block's d_att1 plane on the card); inputs come from
``numpy.random.default_rng``.

Tolerances: h atol = rtol 1e-5 and alpha atol 1e-6, rtol 1e-5 (float32 on
both sides, sums in other orders); the argmax trace exactly; gradients
atol = rtol = 2e-4, as the JAX test holds its backward (errors grow through
the reverse chain); the explicit backward against autograd of the plain
forward 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops import pallas_att_train as jat
from icee_tpu_torch import bridge
from icee_tpu_torch.ops import att_scan

torch.set_num_threads(2)
B, T, P, A, FS, E, F, H, V = 16, 4, 5, 8, 12, 6, 8, 8, 11
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _params(kind, seed):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    att = {"dec_w": n(H, A), "dec_b": n(A), "full_w": n(A, 1),
           "full_b": n(1), "fb_w": n(H, FS), "fb_b": n(FS)}
    if kind == "factored":
        cell = {"V_we": n(E, 4 * F), "V_wc": n(FS, 4 * F), "V_b": n(4, F),
                "S_w": n(4, F, F), "S_b": n(4, F), "U_w": n(4, F, H),
                "U_b": n(4, H), "W_w": n(H, 4 * H), "W_b": n(4, H)}
    else:
        cell = {"W_ihe": n(E, 4 * H), "W_ihc": n(FS, 4 * H),
                "W_hh": n(H, 4 * H), "b_ih": n(4 * H), "b_hh": n(4 * H)}
    head = {"C_w": n(H, V), "C_b": n(V), "B": n(V, E)}
    return cell, att, head


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"emb": f(B, T, E), "att1": f(B, P, A), "feats": f(B, P, FS),
            "h0": 0.5 * f(B, H), "c0": 0.5 * f(B, H),
            "emb_raw": f(B, 1, E),
            "coins": np.array([0, 1, 0, 0], np.float32)}


def _jax_sampled(cell, att, head, x, kind, tile):
    """JAX's sampled kernel in interpret mode -> (h, alphas, pidx (T, B))."""
    h, a, (_, _, _, pidx) = jat._fwd_impl(
        cell, att, x["emb"], x["att1"], x["feats"], x["h0"], x["c0"], kind,
        tile, True, samp={"head": head, "emb_raw": x["emb_raw"],
                          "coins": x["coins"]})
    return np.asarray(h), np.asarray(a), np.asarray(pidx)[:, :, 0]


def _torch(tree):
    return bridge.to_torch(tree)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_forward_matches_pallas_and_reference(kind, tile):
    cell, att, _ = _params(kind, 0)
    x = _inputs(1)
    args = (x["emb"], x["att1"], x["feats"], x["h0"], x["c0"])
    want_k = jat.fused_att_scan(cell, att, *args, kind, tile, True)
    want_r = jat.reference_att_scan(cell, att, *args, kind)
    h, a, res = att_scan.att_scan_fwd(_torch(cell), _torch(att),
                                      *map(torch.tensor, args), kind)
    assert res["pidx"] is None
    for want in (want_k, want_r):
        np.testing.assert_allclose(h.numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_sampled_forward_matches_pallas_and_reference(kind, tile):
    cell, att, head = _params(kind, 2)
    x = _inputs(3)
    want_h, want_a, want_pidx = _jax_sampled(cell, att, head, x, kind, tile)
    ref_h, ref_a = jat.reference_att_scan_sampled(
        cell, att, head, x["emb"], x["emb_raw"], x["att1"], x["feats"],
        x["h0"], x["c0"], x["coins"], kind)
    tx = {k: torch.tensor(v) for k, v in x.items()}
    samp = {"head": _torch(head), "emb_raw": tx["emb_raw"],
            "coins": tx["coins"]}
    h, a, res = att_scan.att_scan_fwd(
        _torch(cell), _torch(att), tx["emb"], tx["att1"], tx["feats"],
        tx["h0"], tx["c0"], kind, samp)
    np.testing.assert_array_equal(res["pidx"].numpy(), want_pidx)
    for wh, wa in ((want_h, want_a), (ref_h, ref_a)):
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(wa), rtol=1e-5,
                                   atol=1e-6)
    # a forced trace equal to the scan's own changes nothing
    h2, a2, _, p2 = att_scan.fused_att_scan_sampled_plain(
        _torch(cell), _torch(att), samp["head"], tx["emb"], tx["emb_raw"],
        tx["att1"], tx["feats"], tx["h0"], tx["c0"], tx["coins"], kind,
        forced_pidx=res["pidx"])
    assert torch.equal(h2, h) and torch.equal(a2, a)
    assert torch.equal(p2, res["pidx"])


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_backward_matches_pallas_vjp(kind, sampled):
    """The port's autograd (plain backward on the CPU) against ``jax.vjp``
    of the interpret-mode kernels, for random (dh, dalpha) cotangents;
    every cotangent, the zero ones included."""
    cell, att, head = _params(kind, 4)
    x = _inputs(5)
    rng = np.random.default_rng(6)
    dh = rng.standard_normal((B, T, H)).astype(np.float32)
    da = rng.standard_normal((B, T, P)).astype(np.float32)
    if sampled:
        def jfn(cell, att, head, emb, emb_raw, att1, feats, h0, c0, coins):
            return jat.fused_att_scan_sampled(
                cell, att, head, emb, emb_raw, att1, feats, h0, c0, coins,
                kind, 8, True)
        jargs = (cell, att, head, x["emb"], x["emb_raw"], x["att1"],
                 x["feats"], x["h0"], x["c0"], x["coins"])
        names = ("cell", "att", "head", "emb", "emb_raw", "att1", "feats",
                 "h0", "c0", "coins")
    else:
        def jfn(cell, att, emb, att1, feats, h0, c0):
            return jat.fused_att_scan(cell, att, emb, att1, feats, h0, c0,
                                      kind, 8, True)
        jargs = (cell, att, x["emb"], x["att1"], x["feats"], x["h0"],
                 x["c0"])
        names = ("cell", "att", "emb", "att1", "feats", "h0", "c0")
    _, vjp = jax.vjp(jfn, *jargs)
    want = dict(zip(names, vjp((jnp.asarray(dh), jnp.asarray(da)))))

    got_in = {name: bridge.to_torch(v) for name, v in zip(names, jargs)}
    for name, v in got_in.items():
        for leaf in (v.values() if isinstance(v, dict) else (v,)):
            leaf.requires_grad_(True)
    if sampled:
        out = att_scan.fused_att_scan_sampled(*got_in.values(), kind)
    else:
        out = att_scan.fused_att_scan(*got_in.values(), kind)
    torch.autograd.backward(out, (torch.tensor(dh), torch.tensor(da)))
    for name in names:
        w, g = want[name], got_in[name]
        if isinstance(g, dict):
            for key, leaf in g.items():
                np.testing.assert_allclose(
                    leaf.grad.numpy(), np.asarray(w[key]),
                    err_msg=f"{name}.{key}", **GRAD_TOL)
        else:
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                       err_msg=name, **GRAD_TOL)
    assert not got_in["feats"].grad.any()
    if sampled:
        assert not got_in["coins"].grad.any()
        assert not got_in["head"]["C_w"].grad.any()
        assert not got_in["head"]["C_b"].grad.any()
        assert got_in["head"]["B"].grad.any()


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_explicit_backward_matches_autograd_of_plain(kind, sampled):
    """``att_scan_bwd_plain`` (through ``att_scan_bwd``) against torch's
    autograd of the plain forward, the sampled one following its own
    trace; every grad but the features' (autograd of the plain forward
    differentiates through them, the scan's contract drops them)."""
    cell, att, head = _params(kind, 7)
    x = {k: torch.tensor(v) for k, v in _inputs(8).items()}
    rng = np.random.default_rng(9)
    dh = torch.tensor(rng.standard_normal((B, T, H)).astype(np.float32))
    da = torch.tensor(rng.standard_normal((B, T, P)).astype(np.float32))
    tc, ta, th = _torch(cell), _torch(att), _torch(head)
    samp = ({"head": th, "emb_raw": x["emb_raw"], "coins": x["coins"]}
            if sampled else None)
    h, a, res = att_scan.att_scan_fwd(tc, ta, x["emb"], x["att1"],
                                      x["feats"], x["h0"], x["c0"], kind,
                                      samp)
    got = att_scan.att_scan_bwd(tc, ta, x["emb"], x["att1"], x["feats"],
                                x["h0"], x["c0"], h, a, res, dh, da, kind,
                                samp)

    leaves = {"emb_seq": x["emb"], "att1": x["att1"], "h0": x["h0"],
              "c0": x["c0"]}
    leaves.update({f"cell.{k}": v for k, v in tc.items()})
    leaves.update({f"att.{k}": v for k, v in ta.items()})
    if sampled:
        leaves.update({"emb_raw": x["emb_raw"], "head.B": th["B"]})
    for v in leaves.values():
        v.requires_grad_(True)
    if sampled:
        h2, a2, _, _ = att_scan.fused_att_scan_sampled_plain(
            tc, ta, th, x["emb"], x["emb_raw"], x["att1"], x["feats"],
            x["h0"], x["c0"], x["coins"], kind, forced_pidx=res["pidx"])
    else:
        h2, a2, _ = att_scan.fused_att_scan_plain(
            tc, ta, x["emb"], x["att1"], x["feats"], x["h0"], x["c0"], kind)
    grads = torch.autograd.grad((h2 * dh).sum() + (a2 * da).sum(),
                                list(leaves.values()))
    for (name, _), want in zip(leaves.items(), grads):
        part, _, key = name.partition(".")
        g = got[part][key] if key else got[part]
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5, msg=name)
    if sampled:
        assert not got["head"]["C_w"].any() and not got["head"]["C_b"].any()


def test_sampled_full_width_emb_raw_gets_step_0_only():
    """``emb_raw`` given (B, T, E): only column 0 is consumed, so only it
    gets a cotangent (the JAX package's ``_bwd_impl`` :867-872)."""
    cell, att, head = _params("factored", 10)
    x = {k: torch.tensor(v) for k, v in _inputs(11).items()}
    x["coins"] = torch.tensor([0.0, 1.0, 0.0, 0.0])
    raw = torch.randn((B, T, E), generator=torch.Generator().manual_seed(0))
    raw.requires_grad_(True)
    h, _ = att_scan.fused_att_scan_sampled(
        _torch(cell), _torch(att), _torch(head), x["emb"], raw, x["att1"],
        x["feats"], x["h0"], x["c0"], x["coins"])
    h.sum().backward()
    assert raw.grad[:, 0].abs().sum() > 0
    assert not raw.grad[:, 1:].any()


def test_wrappers_check_their_inputs():
    cell, att, head = _params("lstm", 12)
    x = {k: torch.tensor(v) for k, v in _inputs(13).items()}
    tc, ta = _torch(cell), _torch(att)
    with pytest.raises(ValueError, match="shape"):
        att_scan.att_scan_fwd(tc, ta, x["emb"][..., :-1], x["att1"],
                              x["feats"], x["h0"], x["c0"], "lstm")
    with pytest.raises(TypeError, match="dtype"):
        att_scan.att_scan_fwd(tc, ta, x["emb"].double(), x["att1"],
                              x["feats"], x["h0"], x["c0"], "lstm")
    with pytest.raises(ValueError, match="unknown kind"):
        att_scan.att_scan_fwd(tc, ta, x["emb"], x["att1"], x["feats"],
                              x["h0"], x["c0"], "gru")
    samp = {"head": _torch(head), "emb_raw": x["emb_raw"],
            "coins": x["coins"][:-1]}
    with pytest.raises(ValueError, match="coins"):
        att_scan.att_scan_fwd(tc, ta, x["emb"], x["att1"], x["feats"],
                              x["h0"], x["c0"], "lstm", samp)
    h, a, res = att_scan.att_scan_fwd(tc, ta, x["emb"], x["att1"],
                                      x["feats"], x["h0"], x["c0"], "lstm")
    samp["coins"] = x["coins"]
    with pytest.raises(ValueError, match="token trace"):
        att_scan.att_scan_bwd(tc, ta, x["emb"], x["att1"], x["feats"],
                              x["h0"], x["c0"], h, a, res, h, a, "lstm",
                              samp)


@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_past_the_d_att1_plane_matches_pallas_vjp(kind):
    """T = 60 steps at A = 1024, T (A + 28) = 63,120 floats: past what one
    block of the card's d_att1 pass held (58,112), where it now splits A
    into column blocks (``att_scan.datt1_plan``: 2 of 512).  The plain
    forward and backward (what the card is held to) against JAX's
    interpret-mode kernels and ``jax.vjp``, the other widths narrow."""
    t, a = 60, 1024
    assert att_scan.datt1_plan(t, a) == (512, 2)
    rng = np.random.default_rng(11)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    att = {"dec_w": n(H, a, scale=0.05), "dec_b": n(a), "full_w": n(a, 1,
           scale=0.05), "full_b": n(1), "fb_w": n(H, FS), "fb_b": n(FS)}
    if kind == "factored":
        cell = {"V_we": n(E, 4 * F), "V_wc": n(FS, 4 * F), "V_b": n(4, F),
                "S_w": n(4, F, F), "S_b": n(4, F), "U_w": n(4, F, H),
                "U_b": n(4, H), "W_w": n(H, 4 * H), "W_b": n(4, H)}
    else:
        cell = {"W_ihe": n(E, 4 * H), "W_ihc": n(FS, 4 * H),
                "W_hh": n(H, 4 * H), "b_ih": n(4 * H), "b_hh": n(4 * H)}
    args = (n(2, t, E, scale=1.0), n(2, P, a, scale=1.0),
            n(2, P, FS, scale=1.0), n(2, H), n(2, H))
    dh, da = n(2, t, H, scale=1.0), n(2, t, P, scale=1.0)

    def jfn(cell, att, emb, att1, feats, h0, c0):
        return jat.fused_att_scan(cell, att, emb, att1, feats, h0, c0, kind,
                                  2, True)

    (want_h, want_a), vjp = jax.vjp(jfn, cell, att, *args)
    want = vjp((jnp.asarray(dh), jnp.asarray(da)))
    got_in = [bridge.to_torch(v) for v in (cell, att, *args)]
    for v in got_in:
        for leaf in (v.values() if isinstance(v, dict) else (v,)):
            leaf.requires_grad_(True)
    h, al = att_scan.fused_att_scan(*got_in, kind)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(al.detach().numpy(), np.asarray(want_a),
                               rtol=1e-5, atol=1e-6)
    torch.autograd.backward((h, al), (torch.tensor(dh), torch.tensor(da)))
    for name, g, w in zip(("cell", "att", "emb", "att1", "feats", "h0",
                           "c0"), got_in, want):
        for key, leaf in (g.items() if isinstance(g, dict) else (("", g),)):
            ww = w[key] if key else w
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ww),
                                       err_msg=f"{name}.{key}", **GRAD_TOL)
