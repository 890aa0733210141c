"""``icee_tpu_torch.decode.beam.beam_search`` (the single-image search,
the plain function K2 computes for one image) against the JAX package's
``beam_search``, for the StyleNet and NIC decoders, with the image feature
as the step-1 input (serving) and without (research), with the full-vocab
step and with ``step_topk_fn`` (the port's K1 wrapper, its plain version
here; JAX's step followed by ``lax.top_k``).  Weights are N(0, 1) with a
lifted ``<end>`` bias, so that beams end at several lengths.  Tokens and
lengths exact; scores to atol 1e-4 (float32 sums in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.decode.beam import beam_search as jbeam
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.models import lstm as jnic
from icee_tpu_torch import bridge
from icee_tpu_torch.decode.beam import beam_search
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.ops.decode_step import decode_step_topk

V, E, H, K, STEPS = 40, 12, 16, 5, 9


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One CPU thread while this module runs: with more, a thread of the
    intra-op pool can compute a float32 exp up to ~1,800 ulps off in a few
    processes in a hundred (PERF.md section 7), and these tests compare
    float32 values across packages."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(family, seed):
    cfg = JDecoderConfig(vocab_size=V, embed_size=E, hidden_size=H,
                         factored_size=H)
    init = jfl.init_params if family == "factored" else jnic.init_params
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg)))
    p["C_b" if family == "factored" else "linear_b"][2] += 1.0
    return cfg, p


@pytest.mark.parametrize("topk", [False, True])
@pytest.mark.parametrize("feed", [True, False])
@pytest.mark.parametrize("family", ["factored", "nic"])
def test_beam_search_matches_jax(family, feed, topk):
    lengths = set()
    for seed in range(4):
        cfg, jp = _params(family, seed)
        tp = bridge.to_torch(jp)
        feat = np.random.default_rng(seed + 7).standard_normal(
            (1, E)).astype(np.float32)
        if family == "factored":
            jstep = lambda x, s: jfl.decode_step(jp, x, s, 1)  # noqa: E731
            step = lambda x, s: fl.decode_step(tp, x, s, 1)    # noqa: E731
            jinit, init = jfl.initial_state(K, cfg), fl.initial_state(K, cfg)
            jemb = lambda t: jfl.embed(jp, t)                  # noqa: E731
            emb = lambda t: fl.embed(tp, t)                    # noqa: E731
        else:
            jstep = lambda x, s: jnic.decode_step(jp, x, s)    # noqa: E731
            step = lambda x, s: nic.decode_step(tp, x, s)      # noqa: E731
            jinit = jnic.initial_state(K, cfg)
            init = nic.initial_state(K, cfg)
            jemb = lambda t: jnic.embed(jp, t)                 # noqa: E731
            emb = lambda t: nic.embed(tp, t)                   # noqa: E731
        jkw, kw = {}, {}
        if topk:
            def jtop(x, s):
                logits, s = jstep(x, s)
                vals, idx = jax.lax.top_k(jax.nn.log_softmax(logits), K)
                return vals, idx, s

            def top(x, s):
                if family == "factored":
                    vals, idx, h, c = decode_step_topk(tp, x, *s, 1, ktop=K)
                    return vals, idx, (h, c)
                logits, s = step(x, s)
                vals, idx = torch.topk(torch.log_softmax(logits, -1), K)
                return vals, idx, s

            jkw, kw = dict(step_topk_fn=jtop), dict(step_topk_fn=top)
        want = jbeam(embed_fn=jemb, step_fn=jstep, init_model_state=jinit,
                     start_token=1, end_token=2, k=K, max_seq_length=STEPS,
                     vocab_size=V,
                     first_input=jnp.tile(feat, (K, 1)) if feed else None,
                     **jkw)
        got = beam_search(embed_fn=emb, step_fn=step,
                          init_model_state=tuple(init), start_token=1,
                          end_token=2, k=K, max_seq_length=STEPS,
                          vocab_size=V,
                          first_input=(torch.tensor(feat).repeat(K, 1)
                                       if feed else None), **kw)
        assert got.tokens.shape == (STEPS + 2,)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        assert int(got.length) == int(want.length)
        np.testing.assert_allclose(float(got.score), float(want.score),
                                   rtol=0, atol=1e-4)
        lengths.add(int(got.length))
    assert len(lengths) > 1
