"""The padded layout (``icee_tpu_torch/ops/widths.py``) that K1, K2, K5, K6
and K7 run on at widths that are not a multiple of 4: the launch setups
(``decode_step.step_layout``, ``beam.nic_layout``,
``att_decode_step.step_layout``, ``att_beam.search_layout`` /
``init_layout``, ``att_scan.card_layout``) at ragged F, H, V, A and FS,
the plain version run on that layout and cut back, against the JAX
package at the unpadded widths.  The kernels read exactly this layout on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 25).

Inputs and weights come from ``numpy.random.default_rng``.  Tolerances:
ids and tokens exact; log-probs, h', c', alpha and scores atol 1e-5 (1e-4
for scores summed over a search), as the unpadded tests hold them; K5's
h atol 1e-5, alpha 1e-6 and its gradients atol = rtol = 2e-4, as
``tests/test_torch_att_scan.py`` holds them.  Every padded entry of h',
c' and h0 / c0 is exactly 0, and a padded vocabulary column never enters
a top-k or a beam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import AttentionDecoderConfig as JAttCfg
from icee_tpu.core.config import DecoderConfig
from icee_tpu.decode.beam import beam_search_batched as jbeam_batched
from icee_tpu.models import attention as ja
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.models import lstm as jnic
from icee_tpu.ops import pallas_att_train as jat
from icee_tpu.ops.pallas_att_decode import fused_att_decode_step_topk
from icee_tpu.ops.pallas_decode import (fused_decode_step_topk,
                                        reference_step_topk)
from icee_tpu_torch import bridge
from icee_tpu_torch.ops import att_beam, att_scan, beam, widths
from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk_plain,
                                                step_layout as att_layout,
                                                step_params)
from icee_tpu_torch.ops.beam import mega_beam_decode_plain, nic_layout
from icee_tpu_torch.ops.decode_step import decode_step_topk_plain, step_layout

torch.set_num_threads(2)
TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
# (E, F, H, V): every residue of V mod 4, ragged F and H
RAGGED = [(30, 21, 23, 129), (16, 24, 22, 130), (13, 18, 25, 131),
          (20, 24, 24, 133)]


def test_pad_and_quad():
    """Rounding, the corner copy, gate blocks, the stack axis, the head's
    fill, no copy where nothing grows, and the cut back."""
    assert [widths.quad(n) for n in (1, 4, 5, 8189, 8191, 8192)] == \
        [4, 4, 8, 8192, 8192, 8192]
    w = widths.widths(E=3, F=5, H=6, V=7)
    assert w == {"E": (3, 3), "F": (5, 8), "H": (6, 8), "V": (7, 8),
                 "X": (3, 3)}
    assert widths.widths(E=3, FS=6)["X"] == (9, 11)
    v_w = torch.arange(3 * 20, dtype=torch.float32).view(3, 20)
    got = got_vw = widths.pad(v_w, "X 4F", w)
    assert got.shape == (3, 32) and got.is_contiguous()
    for g in range(4):
        assert torch.equal(got[:, 8 * g:8 * g + 5], v_w[:, 5 * g:5 * g + 5])
        assert not got[:, 8 * g + 5:8 * g + 8].any()
    s_w = torch.randn(4, 4, 5, 5)    # stacked styles: the lead axis kept
    got = widths.pad(s_w, "4 F F", w)
    assert got.shape == (4, 4, 8, 8) and torch.equal(got[:, :, :5, :5], s_w)
    assert torch.equal(widths.cut(got, "4 F F", w), s_w)
    cut = widths.pad_tree({"V_w": got_vw, "cell": {"b_ih": torch.ones(32)}},
                          w, widths.cut)
    assert torch.equal(cut["V_w"], v_w) and cut["cell"]["b_ih"].shape == (24,)
    tree = widths.pad_tree({"C_b": torch.zeros(7), "B": torch.zeros(7, 3),
                            "cell": {"b_ih": torch.ones(24)}}, w)
    assert tree["C_b"][7].item() == np.float32(widths.LOGIT_FILL)
    assert tree["B"].shape == (8, 3) and tree["cell"]["b_ih"].shape == (32,)
    same = widths.widths(E=3, F=8, H=8, V=8)
    assert not widths.ragged(same) and widths.ragged(w)
    t = torch.ones(2, 8)
    assert widths.pad(t, "H V", same) is t
    assert widths.pad_last(t, 8) is t and widths.cut_last(t, 8) is t


def _decoder(e, f, h, v, seed):
    cfg = DecoderConfig(vocab_size=v, embed_size=e, hidden_size=h,
                        factored_size=f)
    return jax.tree.map(np.asarray, jfl.init_params(jax.random.PRNGKey(seed),
                                                    cfg))


@pytest.mark.parametrize("e,f,h,v", RAGGED)
@pytest.mark.parametrize("ktop", [5, 20])
def test_k1_layout_cut_back_matches_jax(e, f, h, v, ktop):
    """K1's launch setup at ragged widths: the plain step on the padded
    weights with h and c padded by zeros, its h' and c' cut back, against
    its XLA oracle at the true widths (and, at the first shape, the JAX
    kernel in interpret mode); the padded units of h' and c' exactly 0."""
    jp = _decoder(e, f, h, v, seed=v)
    rng = np.random.default_rng(v)
    rows = 12
    x, hh, c = (rng.standard_normal((rows, d)).astype(np.float32)
                for d in (e, h, h))
    style = 2
    w, kern = step_layout(bridge.to_torch(jp), style)
    hp = widths.quad(h)
    assert kern["C_w"].shape == (hp, widths.quad(v))
    assert kern["V_w"].shape == (e, 4 * widths.quad(f))
    stacked = dict(kern, S_w=kern["S_w"][None], S_b=kern["S_b"][None])
    pv, pi, ph, pc = decode_step_topk_plain(
        stacked, torch.tensor(x), widths.pad_last(torch.tensor(hh), hp),
        widths.pad_last(torch.tensor(c), hp), 0, ktop)
    assert not ph[:, h:].any() and not pc[:, h:].any()
    assert int(pi.max()) < v
    wants = [reference_step_topk(jp, x, hh, c, jnp.asarray(style),
                                 ktop=ktop)]
    if (e, f, h, v) == RAGGED[0]:   # the kernel's compile is the cost
        wants.append(fused_decode_step_topk(
            jp, x, hh, c, jnp.asarray(style), ktop=ktop, row_block=rows,
            v_tile=128, interpret=True))
    for want in wants:
        wv, wi, wh, wc = map(np.asarray, want)
        np.testing.assert_array_equal(pi.numpy(), wi)
        np.testing.assert_allclose(pv.numpy(), wv, **TOL)
        np.testing.assert_allclose(widths.cut_last(ph, h).numpy(), wh, **TOL)
        np.testing.assert_allclose(widths.cut_last(pc, h).numpy(), wc, **TOL)


def test_a_padded_column_loses_every_tie():
    """A zero head (every logit 0, V = 129): the padded columns' -1e30
    stays out of the top-k and out of logZ; ids 0..k-1, log-probs
    -log V."""
    jp = _decoder(8, 6, 7, 129, seed=1)
    jp = dict(jp, C_w=np.zeros_like(jp["C_w"]), C_b=np.zeros_like(jp["C_b"]))
    w, kern = step_layout(bridge.to_torch(jp), 0)
    stacked = dict(kern, S_w=kern["S_w"][None], S_b=kern["S_b"][None])
    rows = torch.zeros((3, 8))
    hp = torch.zeros((3, widths.quad(7)))
    vals, idx, _, _ = decode_step_topk_plain(stacked, rows, hp, hp, 0, 128)
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(128), (3, 1)))
    np.testing.assert_allclose(vals.numpy(), -np.log(129.0), rtol=1e-6)


def _jax_beam(jp, feats, style, batch, k, steps, cell):
    first = None if feats is None else jnp.asarray(feats)
    if cell == "factored":
        hd = jp["W_w"].shape[0]
        embed = lambda t: jfl.embed(jp, t)  # noqa: E731
        step = lambda x, s: jfl.decode_step(jp, x, s, style)  # noqa: E731
        vocab = jp["C_w"].shape[1]
    else:
        hd = jp["cell"]["W_hh"].shape[0]
        embed = lambda t: jnic.embed(jp, t)  # noqa: E731
        step = lambda x, s: jnic.decode_step(jp, x, s)  # noqa: E731
        vocab = jp["linear_w"].shape[1]
    zeros = jnp.zeros((batch * k, hd), jnp.float32)
    return jbeam_batched(embed_fn=embed, step_fn=step,
                         init_model_state=(zeros, zeros), start_token=1,
                         end_token=2, k=k, max_seq_length=steps,
                         vocab_size=vocab, batch=batch, first_input=first)


def _nic(e, h, v, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"embed": n(v, e), "cell": {"W_ih": n(e, 4 * h), "W_hh": n(h, 4 * h),
                                    "b_ih": n(4 * h), "b_hh": n(4 * h)},
         "linear_w": n(h, v, scale=2.0), "linear_b": n(v, scale=0.1)}
    p["linear_b"][2] = 3.0
    return p


@pytest.mark.parametrize("cell", ["factored", "lstm"])
@pytest.mark.parametrize("e,f,h,v", RAGGED[:3])
def test_k2_layout_matches_jax(cell, e, f, h, v):
    """K2's launch setup: the plain search over the padded weights (the
    padded vocabulary included) gives the JAX beam's tokens, lengths and
    scores at the true widths, both feature modes; its factored layout is
    K1's, tensor for tensor."""
    k, batch, steps = 5, 4, 8
    if cell == "factored":
        jp = _decoder(e, f, h, v, seed=3 * v)
        jp = dict(jp, C_w=jp["C_w"] * np.float32(4.0))
        jp["C_b"] = jp["C_b"].copy()
        jp["C_b"][2] = 1.5
        tp = bridge.to_torch(jp)
        w = step_layout(tp, 0)[0]
        padded = widths.pad_tree(tp, w)
        for n, t in step_layout(tp, 1)[1].items():
            want = padded[n][1] if n in ("S_w", "S_b") else padded[n]
            assert torch.equal(t, want), n
    else:
        jp = _nic(e, h, v, seed=v)
        tp = bridge.to_torch(jp)
        w, kern = nic_layout(tp)
        padded = widths.pad_tree(tp, w)
        for n, t in kern.items():
            src = padded["cell"] if n in padded["cell"] else padded
            assert torch.equal(t, src[n]), n
    assert padded["C_w" if cell == "factored" else "linear_w"].shape[1] == \
        widths.quad(v)
    feats = np.random.default_rng(v).standard_normal(
        (batch, 1, e)).astype(np.float32).repeat(k, axis=1)
    for mode_feats in (feats, None):
        got = mega_beam_decode_plain(
            padded, None if mode_feats is None else torch.tensor(mode_feats),
            1, batch, k=k, max_seq_length=steps, cell=cell)
        want = _jax_beam(jp, mode_feats, 1, batch, k, steps, cell)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_array_equal(got.length.numpy(),
                                      np.asarray(want.length))
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                                   rtol=0, atol=1e-4)
        assert int(got.tokens.max()) < v


ATT_RAGGED = [  # (E, F, H, V, A, FS)
    (14, 21, 23, 129, 17, 30), (16, 24, 22, 131, 20, 33),
    (13, 18, 25, 130, 19, 31)]
P = 9


def _att(kind, e, f, h, v, a, fs, seed):
    cfg = JAttCfg(vocab_size=v, embed_size=e, hidden_size=h,
                  factored_size=f if kind == "factored" else h,
                  attention_size=a, feature_size=fs)
    init = (ja.init_factored_att_params if kind == "factored"
            else ja.init_rnn_att_params)
    rng = np.random.default_rng(seed)

    def redraw(x):
        x = np.asarray(x)
        scale = 2.0 / np.sqrt(x.shape[-2]) if x.ndim >= 2 else 0.3
        return (scale * rng.standard_normal(x.shape)).astype(np.float32)

    tree = jax.tree.map(redraw, init(jax.random.PRNGKey(seed), cfg))
    wn, bn = ("C_w", "C_b") if kind == "factored" else ("linear_w",
                                                         "linear_b")
    tree[wn] = tree[wn] * np.float32(3.0)
    tree[bn][2] = 2.0
    return tree


@pytest.mark.parametrize("kind", ["factored", "lstm"])
@pytest.mark.parametrize("dims", ATT_RAGGED[:2])
def test_k6_layout_cut_back_matches_jax(kind, dims):
    """K6's launch setup at ragged F, H, V, A and FS: the plain step on the
    padded weights with h, c, the features and att1 padded by zeros, h'
    and c' cut back, against the JAX kernel (interpret mode) at the true
    widths; alpha unchanged; the padded units exactly 0."""
    e, f, h, v, a, fs = dims
    jp = _att(kind, *dims, seed=v + 7 * (kind == "lstm"))
    style = 1 if kind == "factored" else 0
    tp = bridge.to_torch(jp)
    cell, att, gate = step_params(tp, kind, style)
    rng = np.random.default_rng(v)
    n_img, k = 3, 4
    x = rng.standard_normal((n_img * k, e)).astype(np.float32)
    hh, c = (rng.standard_normal((n_img * k, h)).astype(np.float32)
             for _ in range(2))
    feats = rng.standard_normal((n_img, P, fs)).astype(np.float32)
    att1 = feats @ att["enc_w"].numpy() + att["enc_b"].numpy()
    w, kern = att_layout(cell, att, gate, kind, e)
    hp, ap, fsp = (w[n][1] for n in ("H", "A", "FS"))
    assert kern["dec_w"].shape == (hp, ap) and kern["f_beta_w"].shape == \
        (hp, fsp)
    pad = widths.pad_last
    got = att_decode_step_topk_plain(
        kern, kern, kern, torch.tensor(x), pad(torch.tensor(hh), hp),
        pad(torch.tensor(c), hp), pad(torch.tensor(feats), fsp),
        pad(torch.tensor(att1), ap), kind, k, k)
    assert not got[2][:, h:].any() and not got[3][:, h:].any()
    jcell, jatt, jgate = (jax.tree.map(jnp.asarray, bridge.to_numpy(t))
                          for t in (cell, att, gate))
    want = [np.asarray(t) for t in fused_att_decode_step_topk(
        jcell, jatt, jgate, x, hh, c, feats, att1, kind=kind, k=k, ktop=k,
        n_img_block=1, v_tile=128, interpret=True)]
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for i, t in ((0, got[0]), (2, widths.cut_last(got[2], h)),
                 (3, widths.cut_last(got[3], h)), (4, got[4])):
        np.testing.assert_allclose(t.numpy(), want[i], **TOL)


def _xla_att_beam(jp, feats, style, kind, k, steps):
    att = (ja._select_attention(jp["attention"], style)
           if kind == "factored" else jp["attention"])
    att1 = feats @ att["enc_w"] + att["enc_b"]
    feats_k = jnp.repeat(feats, k, axis=0)
    att1_k = jnp.repeat(att1, k, axis=0)
    if kind == "factored":
        def step(x, s):
            logits, _, s2 = ja.factored_att_decode_step(
                jp, x, feats_k, s, style, att1=att1_k)
            return logits, s2
        embed = lambda t: jfl.embed(jp, t)  # noqa: E731
        vocab = jp["C_w"].shape[1]
    else:
        def step(x, s):
            logits, _, s2 = ja.rnn_att_decode_step(jp, x, feats_k, s,
                                                   att1=att1_k)
            return logits, s2
        embed = lambda t: jnp.take(jp["embed"], t, axis=0)  # noqa: E731
        vocab = jp["linear_w"].shape[1]
    return jbeam_batched(
        embed_fn=embed, step_fn=step,
        init_model_state=ja.init_hidden_state(jp, feats_k), start_token=1,
        end_token=2, k=k, max_seq_length=steps, vocab_size=vocab,
        batch=feats.shape[0])


@pytest.mark.parametrize("kind", ["factored", "lstm"])
@pytest.mark.parametrize("dims", ATT_RAGGED[:2])
def test_k7_layout_matches_jax(kind, dims):
    """K7's launch setup: its weights are K6's layout of the style's trees
    and the h0/c0 weights padded alike, tensor for tensor; the plain search
    over the whole decoder padded so, with the features padded by zeros,
    gives the JAX XLA beam's tokens, lengths and scores at the true widths;
    the h0 / c0 of the padded layout, cut back, are JAX's
    ``init_hidden_state``, the padded units exactly 0."""
    e, f, h, v, a, fs = dims
    jp = _att(kind, *dims, seed=2 * v + (kind == "lstm"))
    style = 2 if kind == "factored" else 0
    tp = bridge.to_torch(jp)
    w, kern = att_beam.search_layout(tp, kind, style, e)
    cell, att, gate = step_params(tp, kind, style)
    _, step_kern = att_layout(cell, att, gate, kind, e)
    for n, t in step_kern.items():
        assert torch.equal(kern[n], t), n
    padded = widths.pad_tree(tp, w)
    p_cell, p_att, _ = step_params(padded, kind, style)
    for n in ("dec_w", "full_w", "C_w", "C_b", "f_beta_w", "init_h_w",
              "init_c_b"):
        src = p_att if n in p_att else p_cell if n in p_cell else padded
        assert torch.equal(kern[n], src[n]), n
    feats = np.random.default_rng(v).standard_normal(
        (3, P, fs)).astype(np.float32)
    fsp = w["FS"][1]
    pf = widths.pad_last(torch.tensor(feats), fsp)
    got = att_beam.mega_att_beam_decode_plain(padded, pf, style, 3, k=4,
                                              max_seq_length=7, kind=kind)
    want = _xla_att_beam(jax.tree.map(jnp.asarray, jp), jnp.asarray(feats),
                         jnp.asarray(style), kind, 4, 7)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=0, atol=1e-4)
    iw, ik = att_beam.init_layout(tp, fs)
    assert iw["H"] == w["H"] and iw["FS"] == w["FS"]
    h0, c0 = ta_init(ik, pf)
    wh0, wc0 = map(np.asarray, ja.init_hidden_state(jp, feats))
    for got_s, want_s in ((h0, wh0), (c0, wc0)):
        assert not got_s[:, h:].any()
        np.testing.assert_allclose(widths.cut_last(got_s, h).numpy(),
                                   want_s, **TOL)


def ta_init(kern, features):
    from icee_tpu_torch.models.attention import init_hidden_state

    return init_hidden_state(kern, features)


K5_DIMS = dict(B=8, T=4, P=5, A=9, FS=13, E=6, F=7, H=8, V=11)


def _k5(kind, seed):
    d = K5_DIMS
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    e, f, h, a, fs, v = d["E"], d["F"], d["H"], d["A"], d["FS"], d["V"]
    att = {"dec_w": n(h, a), "dec_b": n(a), "full_w": n(a, 1),
           "full_b": n(1), "fb_w": n(h, fs), "fb_b": n(fs)}
    if kind == "factored":
        cell = {"V_we": n(e, 4 * f), "V_wc": n(fs, 4 * f), "V_b": n(4, f),
                "S_w": n(4, f, f), "S_b": n(4, f), "U_w": n(4, f, h),
                "U_b": n(4, h), "W_w": n(h, 4 * h), "W_b": n(4, h)}
    else:
        cell = {"W_ihe": n(e, 4 * h), "W_ihc": n(fs, 4 * h),
                "W_hh": n(h, 4 * h), "b_ih": n(4 * h), "b_hh": n(4 * h)}
    head = {"C_w": n(h, v), "C_b": n(v), "B": n(v, e)}
    b, t, p = d["B"], d["T"], d["P"]
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = {"emb": f32(b, t, e), "att1": f32(b, p, a), "feats": f32(b, p, fs),
         "h0": 0.5 * f32(b, h), "c0": 0.5 * f32(b, h),
         "emb_raw": f32(b, 1, e), "coins": np.array([0, 1, 0, 1], np.float32),
         "dh": f32(b, t, h), "da": f32(b, t, p)}
    return cell, att, head, x


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_k5_layout_cut_back_matches_jax(kind, sampled):
    """K5's launch setup at A = 9, FS = 13: the plain scan and its explicit
    backward on the padded layout, every gradient cut back, against JAX's
    XLA oracle and ``jax.vjp`` of it at the true widths; the argmax trace
    exact."""
    cell, att, head, x = _k5(kind, 11 + sampled + 2 * (kind == "lstm"))
    tc, ta_, th = (bridge.to_torch(t) for t in (cell, att, head))
    tx = {k: torch.tensor(v) for k, v in x.items()}
    dims = att_scan.check_scan_inputs(tc, ta_, tx["emb"], tx["att1"],
                                      tx["feats"], tx["h0"], tx["c0"], kind)
    pc, pa, p1, pf, pdims = att_scan.card_layout(tc, ta_, tx["att1"],
                                                 tx["feats"], dims)
    assert (pdims[5], pdims[7]) == (12, 16)
    assert pa["dec_w"].shape == (8, 12) and pf.shape[-1] == 16
    assert (pc["V_wc"] if kind == "factored" else pc["W_ihc"]).shape[0] == 16
    samp = None if not sampled else {"head": th, "emb_raw": tx["emb_raw"],
                                     "coins": tx["coins"]}
    pargs = (pc, pa, tx["emb"], p1, pf, tx["h0"], tx["c0"])
    h, a, res = att_scan.att_scan_fwd(*pargs, kind, samp)
    g = att_scan.att_scan_bwd(*pargs, h, a, res, tx["dh"], tx["da"], kind,
                              samp)
    w = widths.widths(pad=("A", "FS"), E=6, F=7, H=8, A=9, FS=13)
    jargs = (x["emb"], x["att1"], x["feats"], x["h0"], x["c0"])
    if sampled:
        def jfn(cell, att, emb, att1):
            return jat.reference_att_scan_sampled(
                cell, att, head, emb, x["emb_raw"], att1, x["feats"],
                x["h0"], x["c0"], x["coins"], kind)
        _, _, (_, _, _, jpidx) = jat._fwd_impl(
            cell, att, *jargs, kind, 8, True,
            samp={"head": head, "emb_raw": x["emb_raw"],
                  "coins": x["coins"]})
        np.testing.assert_array_equal(res["pidx"].numpy(),
                                      np.asarray(jpidx)[:, :, 0])
    else:
        def jfn(cell, att, emb, att1):
            return jat.reference_att_scan(cell, att, emb, att1, x["feats"],
                                          x["h0"], x["c0"], kind)
    (wh, wa), vjp = jax.vjp(jfn, cell, att, x["emb"], x["att1"])
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(wa), rtol=1e-5,
                               atol=1e-6)
    dcell, datt, demb, datt1 = vjp((jnp.asarray(x["dh"]),
                                    jnp.asarray(x["da"])))
    for tree, want_tree in ((g["cell"], dcell), (g["att"], datt)):
        for n, want in want_tree.items():
            got = widths.cut(tree[n], widths.AXES[n], w)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=n, **GRAD_TOL)
    np.testing.assert_allclose(g["emb_seq"].numpy(), np.asarray(demb),
                               **GRAD_TOL)
    np.testing.assert_allclose(widths.cut_last(g["att1"], 9).numpy(),
                               np.asarray(datt1), **GRAD_TOL)


def test_a_padded_copy_is_kept_while_its_weights_are_unchanged():
    """``cuda_lib.checked_weights`` keeps a result that holds a padded copy
    (``widths.checked``) while every tensor is the same object at the same
    version: made anew after a change in place, never kept for an
    inference tensor (no version counter); a result of aligned widths
    holds no copy."""
    from icee_tpu_torch.ops import cuda_lib

    made = []

    def check(tree):
        w = widths.widths(E=3, H=tree["W_hh"].shape[0])
        made.append(1)
        return widths.checked(w, widths.pad_tree(tree, w))

    tree = {"W_hh": torch.ones(6, 24), "b_ih": torch.ones(24)}
    get = lambda t: cuda_lib.checked_weights(  # noqa: E731
        (t,), ("test",), lambda: check(t))
    first = get(tree)
    assert isinstance(first, cuda_lib.Copies)
    assert get(tree) is first and len(made) == 1
    assert first[1]["W_hh"].shape == (8, 32)
    tree["b_ih"].add_(1.0)                 # a change in place: a new copy
    again = get(tree)
    assert again is not first and len(made) == 2
    assert torch.equal(again[1]["b_ih"][:6], torch.full((6,), 2.0))
    with torch.inference_mode():
        frozen = {"W_hh": torch.ones(6, 24), "b_ih": torch.ones(24)}
    get(frozen)
    get(frozen)
    assert len(made) == 4                  # an inference tensor: never kept
    aligned = {"W_hh": torch.ones(8, 32)}
    got = get(aligned)
    assert not isinstance(got, cuda_lib.Copies)
    assert got[1]["W_hh"] is aligned["W_hh"]
