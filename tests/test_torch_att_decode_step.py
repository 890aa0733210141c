"""K6 (``icee_tpu_torch/ops/att_decode_step.py``) on the CPU, where the
wrapper takes its plain version, against the JAX package's
``fused_att_decode_step_topk`` run in interpret mode (as
``tests/test_pallas_att.py`` runs it), for both cells and a style other
than 0, at that file's small sizes (P = 9, narrow widths, ``v_tile`` 128);
and the search's h0/c0 (``att_init_state``, and the order of its kernel's
sums) against JAX's ``init_hidden_state``.

Tolerances: logp, h', c' and alpha atol 1e-5 (float32; the TPU kernel tiles
the score over A and the vocabulary in its own order); ids exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import AttentionDecoderConfig as JAttCfg
from icee_tpu.models import attention as ja
from icee_tpu.ops.pallas_att_decode import fused_att_decode_step_topk
from icee_tpu_torch import bridge
from icee_tpu_torch.models import attention as ta
from icee_tpu_torch.ops.att_decode_step import (att_decode_step_topk,
                                                att_decode_step_topk_plain,
                                                att_init_state, step_params)

torch.set_num_threads(2)
CFG = JAttCfg(vocab_size=300, embed_size=16, hidden_size=24, factored_size=24,
              attention_size=20, feature_size=32)
B, K, P = 6, 4, 9   # images, beam width, spatial positions
ATOL = 1e-5


def _case(kind, style, seed):
    init = (ja.init_factored_att_params if kind == "factored"
            else ja.init_rnn_att_params)
    jp = init(jax.random.PRNGKey(seed), CFG)
    rng = np.random.default_rng(seed)

    def rows(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, h, c = rows(B * K, 16), rows(B * K, 24), rows(B * K, 24)
    feats = rows(B, P, 32)
    att = (ja._select_attention(jp["attention"], jnp.asarray(style))
           if kind == "factored" else jp["attention"])
    att1 = np.asarray(feats @ att["enc_w"] + att["enc_b"])
    if kind == "factored":
        cell = {k_: jp[k_] for k_ in ("V_w", "V_b", "U_w", "U_b", "W_w",
                                      "W_b", "C_w", "C_b")}
        cell["S_w"] = jp["S_w"][style]
        cell["S_b"] = jp["S_b"][style]
    else:
        cell = dict(jp["cell"], C_w=jp["linear_w"], C_b=jp["linear_b"])
    gate = {"f_beta_w": jp["f_beta_w"], "f_beta_b": jp["f_beta_b"]}
    want = fused_att_decode_step_topk(
        cell, att, gate, x, h, c, feats, att1, kind=kind, k=K, ktop=K,
        n_img_block=3, v_tile=128, interpret=True)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    inputs = tuple(torch.tensor(a) for a in (x, h, c, feats, att1))
    return tp, inputs, [np.asarray(w) for w in want]


@pytest.mark.parametrize("kind,style", [("factored", 2), ("lstm", 0)])
def test_plain_version_matches_the_jax_kernel(kind, style):
    tp, inputs, want = _case(kind, style, seed=3 if kind == "lstm" else 0)
    cell, att, gate = step_params(tp, kind, style)
    before = (att_decode_step_topk.launches,
              att_decode_step_topk.lstm_launches)
    got = att_decode_step_topk(cell, att, gate, *inputs, kind=kind, k=K,
                               ktop=K)
    plain = att_decode_step_topk_plain(cell, att, gate, *inputs, kind=kind,
                                       k=K, ktop=K)
    # a CPU tensor takes the plain version; no kernel launched
    assert (att_decode_step_topk.launches,
            att_decode_step_topk.lstm_launches) == before
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for i in (0, 2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                   atol=ATOL)
        torch.testing.assert_close(got[i], plain[i], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_plain_version_takes_k_10_as_the_jax_kernel_does(kind):
    """Ten rows an image and a top-10, above the CUDA kernels' narrow
    paths (K_MAX = 8): the CPU route answers as the JAX kernel."""
    k = 10
    init = (ja.init_factored_att_params if kind == "factored"
            else ja.init_rnn_att_params)
    jp = init(jax.random.PRNGKey(7), CFG)
    rng = np.random.default_rng(7)
    x, h, c = (rng.standard_normal((2 * k, d)).astype(np.float32)
               for d in (16, 24, 24))
    feats = rng.standard_normal((2, P, 32)).astype(np.float32)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp))
    cell, att, gate = step_params(tp, kind, 1 if kind == "factored" else 0)
    jcell, jatt, jgate = (jax.tree.map(jnp.asarray, t)
                          for t in (cell, att, gate))
    att1 = np.asarray(feats @ np.asarray(jatt["enc_w"])
                      + np.asarray(jatt["enc_b"]))
    want = [np.asarray(w) for w in fused_att_decode_step_topk(
        jcell, jatt, jgate, x, h, c, feats, att1, kind=kind, k=k, ktop=k,
        n_img_block=1, v_tile=128, interpret=True)]
    got = att_decode_step_topk(cell, att, gate, *(
        torch.tensor(a) for a in (x, h, c, feats, att1)), kind=kind, k=k,
        ktop=k)
    assert got[1].shape == (2 * k, k)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for i in (0, 2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("kind,k", [("lstm", 20), ("factored", 64)])
def test_wide_step_on_tied_rows_matches_the_jax_kernel(kind, k):
    """k rows an image and a top-k at the CUDA kernel's wide widths (9 to
    256), V = 128, the head's columns copied in pairs so that every row's
    logits tie: the CPU route's ids equal the JAX kernel's (interpret
    mode), values within 1e-5."""
    cfg = JAttCfg(vocab_size=128, embed_size=16, hidden_size=24,
                  factored_size=24, attention_size=20, feature_size=32)
    init = (ja.init_factored_att_params if kind == "factored"
            else ja.init_rnn_att_params)
    jp = jax.tree.map(np.array, init(jax.random.PRNGKey(9), cfg))
    head = ("C_w", "C_b") if kind == "factored" else ("linear_w", "linear_b")
    jp[head[0]][:, 1::2] = jp[head[0]][:, 0::2]
    jp[head[1]][1::2] = jp[head[1]][0::2]
    rng = np.random.default_rng(9)
    x, h, c = (rng.standard_normal((2 * k, d)).astype(np.float32)
               for d in (16, 24, 24))
    feats = rng.standard_normal((2, P, 32)).astype(np.float32)
    tp = bridge.to_torch(jp)
    cell, att, gate = step_params(tp, kind, 1 if kind == "factored" else 0)
    jcell, jatt, jgate = (jax.tree.map(jnp.asarray, t)
                          for t in (cell, att, gate))
    att1 = np.asarray(feats @ np.asarray(jatt["enc_w"])
                      + np.asarray(jatt["enc_b"]))
    want = [np.asarray(w) for w in fused_att_decode_step_topk(
        jcell, jatt, jgate, x, h, c, feats, att1, kind=kind, k=k, ktop=k,
        n_img_block=1, v_tile=128, interpret=True)]
    got = att_decode_step_topk(cell, att, gate, *(
        torch.tensor(a) for a in (x, h, c, feats, att1)), kind=kind, k=k,
        ktop=k)
    gv, gi = got[0].numpy(), got[1].numpy()
    assert gi.shape == (2 * k, k)
    assert (gv[:, 0::2] == gv[:, 1::2]).all()        # the ties are there
    assert (gi[:, 1::2] == gi[:, 0::2] + 1).all()    # ... the lower id first
    np.testing.assert_array_equal(gi, want[1])
    for i in (0, 2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                   atol=ATOL)


def test_init_state_on_the_cpu_is_init_hidden_state():
    tp, inputs, _ = _case("lstm", 0, seed=4)
    feats = inputs[3]
    h0, c0 = att_init_state(tp, feats)
    want_h, want_c = ta.init_hidden_state(tp, feats)
    torch.testing.assert_close(h0, want_h, rtol=0, atol=0)
    torch.testing.assert_close(c0, want_c, rtol=0, atol=0)
    assert att_init_state.launches == 0


def _init_state_in_kernel_order(params, feats):
    """h0, c0 in the arithmetic of K7's mean and init stages (which
    ``att_init_state`` runs on the card): each mean column the float32 sum
    over P in order from 0 (a chain of fmaf(1, f, s) = s + f), then / P;
    each output column one float32 fmaf chain over FS in order from 0,
    then + the bias.  Python loops over k, vectorized over the columns;
    numpy float32 keeps every step in float32 (fmaf is a rounded mul-add,
    here a rounded product then a rounded add: the same within 1e-5 at
    these sizes)."""
    f = feats.numpy()
    s = np.zeros(f.shape[::2], np.float32)
    for p_ in range(f.shape[1]):
        s = s + f[:, p_]
    mean = s / np.float32(f.shape[1])
    out = []
    for w, b in (("init_h_w", "init_h_b"), ("init_c_w", "init_c_b")):
        wt, bt = params[w].numpy(), params[b].numpy()
        acc = np.zeros((f.shape[0], wt.shape[1]), np.float32)
        for k_ in range(wt.shape[0]):
            acc = acc + mean[:, k_:k_ + 1] * wt[k_]
        out.append(acc + bt)
    return out


@pytest.mark.parametrize("n_img", [1, 3])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_init_state_matches_jax_init_hidden_state(kind, n_img):
    """att_init_state on the CPU, and the arithmetic its kernel runs (the
    search's mean and init stages), against JAX's ``init_hidden_state``
    (``icee_tpu/models/attention.py:155``) at P = 196 positions of FS = 32
    features, atol 1e-5."""
    tp, _, _ = _case(kind, 0, seed=7 + n_img)
    jp = jax.tree.map(np.asarray, bridge.to_numpy(tp))
    rng = np.random.default_rng(n_img)
    feats = rng.uniform(0, 1, (n_img, 196, 32)).astype(np.float32)
    want_h, want_c = ja.init_hidden_state(jp, jnp.asarray(feats))
    h0, c0 = att_init_state(tp, torch.tensor(feats))
    np.testing.assert_allclose(h0.numpy(), np.asarray(want_h), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(c0.numpy(), np.asarray(want_c), rtol=0,
                               atol=ATOL)
    kh, kc = _init_state_in_kernel_order(tp, torch.tensor(feats))
    np.testing.assert_allclose(kh, np.asarray(want_h), rtol=0, atol=ATOL)
    np.testing.assert_allclose(kc, np.asarray(want_c), rtol=0, atol=ATOL)
    assert att_init_state.launches == 0


def test_wrapper_raises_on_what_it_does_not_take():
    tp, (x, h, c, feats, att1), _ = _case("factored", 1, seed=5)
    cell, att, gate = step_params(tp, "factored", 1)
    with pytest.raises(ValueError, match="rows"):
        att_decode_step_topk(cell, att, gate, x[:-1], h[:-1], c[:-1], feats,
                             att1, k=K, ktop=K)
    with pytest.raises(ValueError, match="shape"):
        att_decode_step_topk(cell, att, gate, x, h, c, feats, att1[:, :, :5],
                             k=K, ktop=K)
    with pytest.raises(TypeError, match="dtype"):
        att_decode_step_topk(cell, att, gate, x.double(), h, c, feats, att1,
                             k=K, ktop=K)
    with pytest.raises(ValueError, match="ktop"):
        att_decode_step_topk(cell, att, gate, x, h, c, feats, att1, k=K,
                             ktop=0)
    # every route decodes any k up to V (the card's:
    # tests/test_torch_cuda.py)
    got = att_decode_step_topk(cell, att, gate, x, h, c, feats, att1, k=K,
                               ktop=9)
    assert got[0].shape == got[1].shape == (B * K, 9)
    with pytest.raises(ValueError, match="unknown kind"):
        att_decode_step_topk(cell, att, gate, x, h, c, feats, att1,
                             kind="gru", k=K, ktop=K)
