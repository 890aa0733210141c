"""K6 (``icee_tpu_torch/ops/att_decode_step.py``) on the CPU, where the
wrapper takes its plain version, against the JAX package's
``fused_att_decode_step_topk`` run in interpret mode (as
``tests/test_pallas_att.py`` runs it), for both cells and a style other
than 0, at that file's small sizes (P = 9, narrow widths, ``v_tile`` 128).

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


def test_init_state_on_the_cpu_is_init_hidden_state():
    tp, inputs, _ = _case("lstm", 0, seed=4)
    feats = inputs[3]
    h0, c0 = att_init_state(tp, feats)
    want_h, want_c = ta.init_hidden_state(tp, feats)
    torch.testing.assert_close(h0, want_h, rtol=0, atol=0)
    torch.testing.assert_close(c0, want_c, rtol=0, atol=0)
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
                             ktop=9)
    with pytest.raises(ValueError, match="unknown kind"):
        att_decode_step_topk(cell, att, gate, x, h, c, feats, att1,
                             kind="gru", k=K, ktop=K)
