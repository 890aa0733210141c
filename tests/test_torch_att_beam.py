"""K7 (``icee_tpu_torch/ops/att_beam.py``) on the CPU, where the wrapper
takes its plain version, against the JAX package's
``mega_att_beam_decode``, both its resident call and its P-streamed call
(``p_stream=True``, two P tiles), in interpret mode, and against the XLA
``beam_search_batched`` attention beam, for both cells; plus the port's two
decode paths (``decode/fast.py``), which must agree with each other.

Weights are JAX's init shapes redrawn as N(0, gain^2 / fan_in) with a
sharpened head and a bias on ``<end>``, so that beams complete at lengths
from 1 to 7: the raw init gives every image the bare [<end>] fallback,
which would compare nothing.  Sizes are ``tests/test_pallas_att.py``'s
(P = 9, narrow widths), with a batch of 5 over blocks of 3 (padded).

Tokens and lengths exact; scores atol 1e-4 (float32 sums of up to 8 step
log-probs, each from sums in each framework's own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import AttentionDecoderConfig as JAttCfg
from icee_tpu.decode.beam import beam_search_batched
from icee_tpu.models import attention as ja
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.ops.pallas_att_decode import mega_att_beam_decode as jmega
from icee_tpu_torch import bridge
from icee_tpu_torch.decode.fast import attention_decode, nic_att_decode
from icee_tpu_torch.ops.att_beam import (mega_att_beam_decode,
                                         mega_att_beam_decode_plain,
                                         mega_att_beam_decode_steps)

torch.set_num_threads(2)
CFG = JAttCfg(vocab_size=300, embed_size=16, hidden_size=24, factored_size=24,
              attention_size=20, feature_size=32)
K, P, BATCH, STEPS = 4, 9, 5, 7
SHAPE = {"factored": (2.0, 2.0), "lstm": (1.5, 3.0)}  # (gain, <end> bias)


def _params(kind):
    init = (ja.init_factored_att_params if kind == "factored"
            else ja.init_rnn_att_params)
    gain, end_bias = SHAPE[kind]
    rng = np.random.default_rng(5)

    def redraw(a):
        a = np.asarray(a)
        scale = gain / np.sqrt(a.shape[-2]) if a.ndim >= 2 else 0.3
        return (scale * rng.standard_normal(a.shape)).astype(np.float32)

    tree = jax.tree.map(redraw, init(jax.random.PRNGKey(4), CFG))
    w, b = ("C_w", "C_b") if kind == "factored" else ("linear_w", "linear_b")
    tree[w] = tree[w] * np.float32(3.0)
    tree[b][2] = end_bias
    return tree


def _xla_beam(jp, feats, style, kind):
    att = (ja._select_attention(jp["attention"], style)
           if kind == "factored" else jp["attention"])
    att1 = feats @ att["enc_w"] + att["enc_b"]
    feats_k = jnp.repeat(feats, K, axis=0)
    att1_k = jnp.repeat(att1, K, axis=0)
    if kind == "factored":
        def step(x, s):
            logits, _, s2 = ja.factored_att_decode_step(
                jp, x, feats_k, s, style, att1=att1_k)
            return logits, s2
        embed = lambda t: jfl.embed(jp, t)  # noqa: E731
    else:
        def step(x, s):
            logits, _, s2 = ja.rnn_att_decode_step(jp, x, feats_k, s,
                                                   att1=att1_k)
            return logits, s2
        embed = lambda t: jnp.take(jp["embed"], t, axis=0)  # noqa: E731
    return beam_search_batched(
        embed_fn=embed, step_fn=step,
        init_model_state=ja.init_hidden_state(jp, feats_k), start_token=1,
        end_token=2, k=K, max_seq_length=STEPS,
        vocab_size=CFG.vocab_size, batch=BATCH)


@pytest.mark.filterwarnings("ignore:mega_att_beam_decode")
@pytest.mark.parametrize("kind,style", [("factored", 2), ("lstm", 0)])
def test_plain_version_matches_both_jax_calls_and_the_xla_beam(kind, style):
    tree = _params(kind)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.to_torch(tree)
    feats = np.random.default_rng(1).standard_normal(
        (BATCH, P, CFG.feature_size)).astype(np.float32)
    jstyle = jnp.asarray(style)
    common = dict(start_token=1, end_token=2, k=K, max_seq_length=STEPS,
                  n_img_block=3, v_tile=128, kind=kind, interpret=True)
    wants = {"resident": jmega(jp, feats, jstyle, BATCH, **common),
             "p-streamed": jmega(jp, feats, jstyle, BATCH, p_stream=True,
                                 p_tile=8, **common),
             "xla": _xla_beam(jp, feats, jstyle, kind)}
    got, steps = mega_att_beam_decode_steps(
        tp, torch.tensor(feats), style, BATCH, start_token=1, end_token=2,
        k=K, max_seq_length=STEPS, kind=kind)
    assert steps is None     # the plain version ran: no kernel, no counts
    assert got.tokens.dtype == got.length.dtype == torch.int32
    for name, want in wants.items():
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens), err_msg=name)
        np.testing.assert_array_equal(got.length.numpy(),
                                      np.asarray(want.length), err_msg=name)
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                                   rtol=0, atol=1e-4, err_msg=name)
    lengths = got.length.tolist()
    assert len(set(lengths)) >= 3 and max(lengths) >= 3, lengths


@pytest.mark.parametrize("kind,style", [("factored", 1), ("lstm", 0)])
def test_k_10_matches_the_jax_resident_call(kind, style):
    """Ten beams, above the CUDA kernels' K_MAX = 8: the CPU route answers
    as the JAX kernel's resident call (interpret mode)."""
    k, batch, steps = 10, 2, 5
    tree = _params(kind)
    jp = jax.tree.map(jnp.asarray, tree)
    feats = np.random.default_rng(3).standard_normal(
        (batch, P, CFG.feature_size)).astype(np.float32)
    want = jmega(jp, feats, jnp.asarray(style), batch, start_token=1,
                 end_token=2, k=k, max_seq_length=steps, n_img_block=2,
                 v_tile=128, kind=kind, interpret=True)
    got = mega_att_beam_decode(bridge.to_torch(tree), torch.tensor(feats),
                               style, batch, start_token=1, end_token=2, k=k,
                               max_seq_length=steps, kind=kind)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_both_decode_paths_agree_on_the_cpu(kind):
    tp = bridge.to_torch(_params(kind))
    feats = torch.tensor(np.random.default_rng(2).standard_normal(
        (BATCH, P, CFG.feature_size)).astype(np.float32))
    args = (BATCH, K, STEPS, 1, 2)
    if kind == "factored":
        runs = [attention_decode(path, tp, feats, 1, *args)
                for path in ("mega", "fused-step")]
    else:
        runs = [nic_att_decode(path, tp, feats, *args)
                for path in ("mega", "fused-step")]
    want = mega_att_beam_decode_plain(tp, feats, 1, BATCH, k=K,
                                      max_seq_length=STEPS, kind=kind)
    for got in runs + [mega_att_beam_decode(tp, feats, 1, BATCH, k=K,
                                            max_seq_length=STEPS,
                                            kind=kind)]:
        torch.testing.assert_close(got.tokens, want.tokens, rtol=0, atol=0)
        torch.testing.assert_close(got.length, want.length, rtol=0, atol=0)
        torch.testing.assert_close(got.score, want.score, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown decode path"):
        attention_decode("xla", tp, feats, 1, *args)


def test_wrapper_raises_on_what_it_does_not_take():
    tp = bridge.to_torch(_params("factored"))
    feats = torch.zeros((BATCH, P, CFG.feature_size))
    with pytest.raises(ValueError, match="shape"):
        mega_att_beam_decode(tp, feats[:, :, :8], 0, BATCH, k=K)
    with pytest.raises(ValueError, match="shape"):
        mega_att_beam_decode(tp, feats, 0, BATCH + 1, k=K)
    with pytest.raises(ValueError, match="style"):
        mega_att_beam_decode(tp, feats, 4, BATCH, k=K)
    with pytest.raises(ValueError, match="k=0"):
        mega_att_beam_decode(tp, feats, 0, BATCH, k=0)
    # above the CUDA kernel's K_MAX = 8 the plain route still decodes (the
    # card refuses: tests/test_torch_cuda.py)
    got = mega_att_beam_decode(tp, feats, 0, BATCH, k=9, max_seq_length=3)
    assert got.tokens.shape == (BATCH, 5)
    with pytest.raises(ValueError, match="unknown kind"):
        mega_att_beam_decode(tp, feats, 0, BATCH, k=K, kind="gru")
