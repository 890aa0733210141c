"""K2 (``icee_tpu_torch.ops.beam.mega_beam_decode``) on the CPU — its plain
version, ``beam_search_batched`` over the full-vocab step — and the port's
fused-step path (``beam_search_batched`` + K1's plain version) vs the JAX
``mega_beam_decode`` kernel in interpret mode, mirroring
``tests/test_pallas_beam.py``.

The same for K2's ``cell="lstm"`` mode (the NIC decoder), whose port path
is ``decode/fast.py::nic_decode``.

Tokens and lengths exact; scores to atol 1e-4 (float32 sums in different
orders over up to 9 steps).  The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig
from icee_tpu.decode.beam import beam_search_batched as jbeam_batched
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.models import lstm as jnic
from icee_tpu.ops.pallas_beam import mega_beam_decode as jmega
from icee_tpu_torch import bridge
from icee_tpu_torch.decode.fast import PATHS, factored_decode, nic_decode
from icee_tpu_torch.ops.beam import mega_beam_decode

torch.set_num_threads(2)


def _params(vocab=512, e=32, h=64, seed=0):
    cfg = DecoderConfig(vocab_size=vocab, embed_size=e, hidden_size=h,
                        factored_size=h)
    return jax.tree.map(np.asarray,
                        jfl.init_params(jax.random.PRNGKey(seed), cfg))


def _feats(batch, k, e, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, k, e)).astype(np.float32)


def _port_all(jp, feats, style, batch, k, steps):
    """Both port paths; they must agree with each other token-exactly."""
    tp = bridge.to_torch(jp)
    ft = None if feats is None else torch.tensor(feats)
    outs = [factored_decode(path, tp, ft, style, batch, k, steps, 1, 2)
            for path in PATHS]
    direct = mega_beam_decode(tp, ft, style, batch, k=k, max_seq_length=steps)
    for o in outs[1:] + [direct]:
        np.testing.assert_array_equal(o.tokens.numpy(), outs[0].tokens.numpy())
        np.testing.assert_array_equal(o.length.numpy(), outs[0].length.numpy())
        np.testing.assert_allclose(o.score.numpy(), outs[0].score.numpy(),
                                   rtol=0, atol=1e-6)
    return outs[0]


def _assert_same(got, want, scores=True):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    if scores:
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("style", [0, 2])
def test_serving_mode_matches_jax_mega(style):
    jp = _params()
    batch, k, steps = 6, 5, 8
    feats = _feats(batch, k, 32)
    want = jmega(jp, jnp.asarray(feats), jnp.asarray(style), batch,
                 start_token=1, end_token=2, k=k, max_seq_length=steps,
                 n_img_block=3, v_tile=128, interpret=True)
    _assert_same(_port_all(jp, feats, style, batch, k, steps), want)


def test_research_mode_and_batch_padding():
    """feed_feature=False, and a batch that does not fill the image blocks."""
    jp = _params(seed=3)
    batch, k, steps = 5, 4, 7
    want = jmega(jp, None, jnp.asarray(1), batch, start_token=1, end_token=2,
                 k=k, max_seq_length=steps, n_img_block=4, v_tile=128,
                 feed_feature=False, interpret=True)
    _assert_same(_port_all(jp, None, 1, batch, k, steps), want)


def test_ragged_vocab():
    jp = _params(vocab=520, seed=5)
    batch, k, steps = 4, 3, 6
    feats = _feats(batch, k, 32, seed=1)
    want = jmega(jp, jnp.asarray(feats), jnp.asarray(3), batch, k=k,
                 max_seq_length=steps, n_img_block=4, v_tile=128,
                 interpret=True)
    got = _port_all(jp, feats, 3, batch, k, steps)
    _assert_same(got, want)
    assert int(got.tokens.max()) < 520


def test_early_termination():
    """<end> dominates: every beam completes at step 1."""
    jp = _params(seed=7)
    jp["C_b"] = jp["C_b"].copy()
    jp["C_b"][2] = 50.0
    batch, k, steps = 4, 5, 8
    feats = _feats(batch, k, 32, seed=2)
    want = jmega(jp, jnp.asarray(feats), jnp.asarray(0), batch, k=k,
                 max_seq_length=steps, n_img_block=4, v_tile=128,
                 interpret=True)
    got = _port_all(jp, feats, 0, batch, k, steps)
    _assert_same(got, want)
    assert np.all(got.length.numpy() == 2)  # <start> <end>


@pytest.mark.parametrize("feed", [True, False])
def test_k_10_matches_jax_mega(feed):
    """Ten beams, above the CUDA kernels' narrow paths (K_MAX = 8): the
    CPU route answers as the JAX kernel, in both feature modes."""
    jp = _params(seed=12)
    batch, k, steps = 3, 10, 6
    feats = _feats(batch, k, 32, seed=4) if feed else None
    want = jmega(jp, None if feats is None else jnp.asarray(feats),
                 jnp.asarray(2), batch, start_token=1, end_token=2, k=k,
                 max_seq_length=steps, n_img_block=2, v_tile=128,
                 feed_feature=feed, interpret=True)
    _assert_same(_port_all(jp, feats, 2, batch, k, steps), want)


@pytest.mark.parametrize("k", [20, 64])
def test_wide_beam_on_tied_rows_matches_jax_mega(k):
    """Beam widths the CUDA kernel takes on its wide paths (9 to 256): the
    CPU route (both port paths) answers as JAX, V = 128, with the head's
    columns copied in pairs so that every step's rows and k x k candidates
    tie: tokens and lengths equal, scores within 1e-5.  At k = 20 the JAX
    kernel in interpret mode; at k = 64, where interpret mode takes about
    a minute an image on the CPU, the XLA ``beam_search_batched`` that
    ``tests/test_pallas_beam.py`` holds the kernel to."""
    jp = _params(vocab=128, seed=14)
    jp["C_w"] = np.array(jp["C_w"]) * np.float32(8.0)
    jp["C_w"][:, 1::2] = jp["C_w"][:, 0::2]
    jp["C_b"] = np.array(jp["C_b"])
    jp["C_b"][1::2] = jp["C_b"][0::2]
    jp["C_b"][2] = 4.0                    # <end> (ties token 3) ends beams
    batch, steps = 2, 4
    feats = _feats(batch, k, 32, seed=6)
    if k == 20:
        want = jmega(jp, jnp.asarray(feats), jnp.asarray(1), batch,
                     start_token=1, end_token=2, k=k, max_seq_length=steps,
                     n_img_block=2, v_tile=128, interpret=True)
    else:
        jparams = jax.tree.map(jnp.asarray, jp)
        zeros = jnp.zeros((batch * k, 64), jnp.float32)
        want = jbeam_batched(
            embed_fn=lambda t: jfl.embed(jparams, t),
            step_fn=lambda x, st: jfl.decode_step(jparams, x, st, 1),
            init_model_state=(zeros, zeros), start_token=1, end_token=2,
            k=k, max_seq_length=steps, vocab_size=128, batch=batch,
            first_input=jnp.asarray(feats))
    got = _port_all(jp, feats, 1, batch, k, steps)
    _assert_same(got, want, scores=False)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=0, atol=1e-5)
    assert (got.length.numpy() > 1).all()


@pytest.mark.parametrize("cell", ["factored", "lstm"])
def test_beam_past_one_block_matches_the_xla_beam(cell):
    """A beam width the CUDA kernel runs with its survivors in device
    memory (k = 300 > 256, V = 400): the CPU route (both port paths for
    the factored cell, nic_decode and the wrapper for the LSTM cell)
    answers as JAX's XLA ``beam_search_batched``, the head's columns
    copied in pairs so that rows and candidates tie: tokens and lengths
    equal, scores within 1e-5."""
    k, batch, steps, vocab = 300, 1, 3, 400
    if cell == "factored":
        jp = _params(vocab=vocab, seed=15)
        w, b = "C_w", "C_b"
    else:
        jp = _nic_params(vocab=vocab, seed=16)
        w, b = "linear_w", "linear_b"
    jp[w] = np.array(jp[w]) * np.float32(8.0)
    jp[w][:, 1::2] = jp[w][:, 0::2]
    jp[b] = np.array(jp[b])
    jp[b][1::2] = jp[b][0::2]
    jp[b][2] = 4.0
    feats = _feats(batch, k, 32 if cell == "factored" else 24, seed=7)
    if cell == "factored":
        jparams = jax.tree.map(jnp.asarray, jp)
        zeros = jnp.zeros((batch * k, 64), jnp.float32)
        want = jbeam_batched(
            embed_fn=lambda t: jfl.embed(jparams, t),
            step_fn=lambda x, st: jfl.decode_step(jparams, x, st, 1),
            init_model_state=(zeros, zeros), start_token=1, end_token=2,
            k=k, max_seq_length=steps, vocab_size=vocab, batch=batch,
            first_input=jnp.asarray(feats))
        got = _port_all(jp, feats, 1, batch, k, steps)
    else:
        want = _jax_nic_beam(jax.tree.map(jnp.asarray, jp), feats, batch, k,
                             steps)
        got = _nic_port(jp, feats, batch, k, steps)
    _assert_same(got, want, scores=False)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score),
                               rtol=0, atol=1e-5)


def test_all_tied_logits():
    """Zero head: every word ties every step; the candidate merge, top-k and
    best-completed tracking all resolve ties by the lowest index."""
    jp = _params(seed=9)
    jp["C_w"] = np.zeros_like(jp["C_w"])
    jp["C_b"] = np.zeros_like(jp["C_b"])
    batch, k, steps = 4, 4, 6
    feats = _feats(batch, k, 32, seed=3)
    want = jmega(jp, jnp.asarray(feats), jnp.asarray(1), batch, k=k,
                 max_seq_length=steps, n_img_block=2, v_tile=128,
                 interpret=True)
    _assert_same(_port_all(jp, feats, 1, batch, k, steps), want)


def test_fuzz_random_configs_match_jax_beam():
    """Random (dims, k, vocab, batch, steps, feature mode) against the JAX
    XLA ``beam_search_batched`` (itself proved equal to the mega kernel)."""
    rng = np.random.default_rng(11)
    for trial in range(4):
        vocab = int(rng.integers(130, 700))
        e, h = int(rng.integers(8, 40)), int(rng.integers(16, 80))
        k, batch = int(rng.integers(2, 6)), int(rng.integers(2, 9))
        steps, feed = int(rng.integers(3, 9)), bool(rng.random() < 0.7)
        style = int(rng.integers(0, 4))
        cfg = DecoderConfig(vocab_size=vocab, embed_size=e, hidden_size=h,
                            factored_size=h, max_seq_length=steps)
        jparams = jfl.init_params(jax.random.PRNGKey(trial), cfg)
        jp = jax.tree.map(np.asarray, jparams)
        feats = _feats(batch, k, e, seed=trial) if feed else None
        zeros = jnp.zeros((batch * k, h), jnp.float32)
        want = jbeam_batched(
            embed_fn=lambda t: jfl.embed(jparams, t),
            step_fn=lambda x, s: jfl.decode_step(jparams, x, s, style),
            init_model_state=(zeros, zeros), start_token=1, end_token=2,
            k=k, max_seq_length=steps, vocab_size=vocab, batch=batch,
            first_input=None if feats is None else jnp.asarray(feats))
        _assert_same(_port_all(jp, feats, style, batch, k, steps), want)


def test_unknown_path_and_bad_block_raise():
    jp = bridge.to_torch(_params(vocab=130))
    feats = torch.zeros((2, 5, 32))
    with pytest.raises(ValueError):
        factored_decode("xla", jp, feats, 0, 2, 5, 4, 1, 2)
    # 9 beams, on the CUDA kernel's wide path: every route decodes any k up
    # to V (the card's: tests/test_torch_cuda.py)
    got = mega_beam_decode(jp, torch.zeros((2, 9, 32)), 0, 2, k=9,
                           max_seq_length=3)
    assert got.tokens.shape == (2, 5)


# --- cell="lstm": the NIC decoder ---------------------------------------------

def _nic_params(vocab=256, e=24, h=32, seed=2, end_bias=3.0):
    """Random NIC weights made with numpy, sharp enough that beams end at
    varied lengths in serving mode."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"embed": w(vocab, e),
         "cell": {"W_ih": w(e, 4 * h), "W_hh": w(h, 4 * h),
                  "b_ih": w(4 * h, scale=0.1), "b_hh": w(4 * h, scale=0.1)},
         "linear_w": w(h, vocab, scale=2.0), "linear_b": w(vocab, scale=0.1)}
    p["linear_b"][2] = end_bias
    return p


def _nic_port(jp, feats, batch, k, steps):
    """nic_decode and the K2 wrapper called directly agree exactly."""
    tp = bridge.to_torch(jp)
    ft = None if feats is None else torch.tensor(feats)
    got = nic_decode(tp, ft, batch, k, steps, 1, 2)
    direct = mega_beam_decode(tp, ft, 0, batch, k=k, max_seq_length=steps,
                              cell="lstm")
    for a, b in zip(got, direct):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    return got


def _jax_nic_beam(jp, feats, batch, k, steps):
    zeros = jnp.zeros((batch * k, jp["cell"]["W_hh"].shape[0]), jnp.float32)
    return jbeam_batched(
        embed_fn=lambda t: jnic.embed(jp, t),
        step_fn=lambda x, s: jnic.decode_step(jp, x, s),
        init_model_state=(zeros, zeros), start_token=1, end_token=2, k=k,
        max_seq_length=steps, vocab_size=jp["linear_w"].shape[1],
        batch=batch, first_input=None if feats is None else jnp.asarray(feats))


@pytest.mark.parametrize("feed", [True, False])
def test_lstm_cell_matches_jax_mega_and_beam(feed):
    """Both feature modes; 5 images in blocks of 2 pad the last block."""
    jp = _nic_params()
    batch, k, steps = 5, 3, 8
    feats = _feats(batch, k, 24, seed=4) if feed else None
    want = jmega(jp, None if feats is None else jnp.asarray(feats),
                 jnp.asarray(0), batch, start_token=1, end_token=2, k=k,
                 max_seq_length=steps, n_img_block=2, v_tile=128,
                 feed_feature=feed, cell="lstm", interpret=True)
    got = _nic_port(jp, feats, batch, k, steps)
    _assert_same(got, want)
    _assert_same(got, _jax_nic_beam(jp, feats, batch, k, steps))
    if feed:
        assert len(set(got.length.tolist())) > 2, "lengths alike prove little"


def test_lstm_cell_early_termination():
    jp = _nic_params(seed=3, end_bias=60.0)
    batch, k, steps = 4, 3, 8
    feats = _feats(batch, k, 24, seed=5)
    want = jmega(jp, jnp.asarray(feats), jnp.asarray(0), batch, k=k,
                 max_seq_length=steps, n_img_block=4, v_tile=128,
                 cell="lstm", interpret=True)
    got = _nic_port(jp, feats, batch, k, steps)
    _assert_same(got, want)
    assert np.all(got.length.numpy() == 2)  # <start> <end>
