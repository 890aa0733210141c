"""The port's ``parallel/`` package (``icee_tpu_torch/parallel``) against the
JAX package's ``icee_tpu/parallel`` on the CPU: the sharding rule, the mesh
helpers, the vocab-parallel losses and the sharded beam searches.

One gloo world of four spawned ranks (``parallel/launch.py``, a file
store under ``tmp_path``, one CPU thread a rank) runs every rank program
of this file once (``parallel/programs.py::several``); the tests read its
results.  The JAX side runs in this process on conftest's eight virtual
devices.

Tolerances: the losses' values rtol 1e-5 and their gradients within 1e-5
x max|g| of JAX's chunked losses (the logsumexp of a split row is combined
from its slices: float32 sums in another order); every rank's results
equal rank 0's at atol 0; the sharded searches' tokens, lengths and
scores equal the one-process search's at atol 0 (a search is independent
per image).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.ops import chunked_loss as jcl
from icee_tpu.parallel import data as jdata
from icee_tpu.parallel import mesh as jmesh
from icee_tpu.parallel import train as jtrain
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import AttentionDecoderConfig, DecoderConfig
from icee_tpu_torch.decode import fast
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.parallel import data as pdata
from icee_tpu_torch.parallel import launch, programs
from icee_tpu_torch.parallel.mesh import (Mesh, data_shards,
                                          decoder_param_shardings,
                                          model_shards)
from icee_tpu_torch.parallel.train import dp_tp_shape

B, T, H, V = 6, 7, 12, 64
SHAPES = [(2, 2), (1, 4)]
CASES = ["mean", "sum_clamp", "mixture"]
DECODES = ["k2_factored", "k2_factored_research", "k2_lstm", "k7_factored",
           "k7_lstm"]
K, MAX_LEN, IMAGES = 3, 6, 4


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _loss_inputs():
    rng = np.random.default_rng(3)
    p = dict(hiddens=_f32(rng, B, T, H), w=_f32(rng, H, V), b=_f32(rng, V),
             targets=rng.integers(0, V, (B, T)).astype(np.int64),
             lengths=np.array([7, 3, 0, 5, 6, 2]),
             sample_mask=np.array([True, True, True, False, True, True]),
             mask=(rng.random((B, T)) < 0.8).astype(np.float32), t_chunk=3,
             hh_o=_f32(rng, B, T, H), hh_n=_f32(rng, B, T, H),
             co=rng.random((B, T)).astype(np.float32),
             cn=rng.random((B, T)).astype(np.float32),
             w_o=_f32(rng, H, V), b_o=_f32(rng, V), w_n=_f32(rng, H, V),
             b_n=_f32(rng, V),
             weights=(rng.random((B, T)) < 0.8).astype(np.float32) * 1.5,
             shapes=SHAPES)
    # the clamp bites on about half the tokens
    logits = p["hiddens"] @ p["w"] + p["b"]
    lse = np.log(np.exp(logits).sum(-1))
    tgt = np.take_along_axis(logits, p["targets"][..., None], -1)[..., 0]
    p["clamp"] = float(np.median(lse - tgt))
    return p


def _decoders():
    gen = torch.Generator().manual_seed(5)
    cfg = DecoderConfig(vocab_size=V, embed_size=8, hidden_size=16,
                        factored_size=16, max_seq_length=MAX_LEN)
    acfg = AttentionDecoderConfig(vocab_size=V, embed_size=8, hidden_size=16,
                                  factored_size=16, feature_size=12,
                                  attention_size=8, max_seq_length=MAX_LEN)
    rng = np.random.default_rng(7)
    feats = _f32(rng, IMAGES, K, 8)
    spatial = rng.random((IMAGES, 5, 12)).astype(np.float32)
    np_ = bridge.to_numpy
    return {
        "k2": {"k2_factored": ("factored", np_(fl.init_params(gen, cfg)),
                               feats),
               "k2_factored_research": ("factored",
                                        np_(fl.init_params(gen, cfg)), None),
               "k2_lstm": ("lstm", np_(nic.init_params(gen, cfg)), feats)},
        "k7": {"k7_factored": ("factored", np_(
            att_mod.init_factored_att_params(gen, acfg)), spatial),
               "k7_lstm": ("lstm", np_(att_mod.init_rnn_att_params(
                   gen, acfg)), spatial)},
        "style": 2, "batch": IMAGES, "k": K, "max_len": MAX_LEN}


def _dec():
    """A seeded StyleNet decoder as numpy (V = 64: the model axis of 2
    splits it)."""
    cfg = DecoderConfig(vocab_size=V, embed_size=8, hidden_size=16,
                        factored_size=16)
    return bridge.to_numpy(fl.init_params(torch.Generator().manual_seed(0),
                                          cfg))


@pytest.fixture(scope="module", autouse=True)
def _world_run(tmp_path_factory):
    """One four-rank world on a (2, 2) mesh running every program here,
    started as the module starts and run in the background while the JAX
    side computes."""
    work = tmp_path_factory.mktemp("parallel_world")
    payload = {"vocab_losses": _loss_inputs(), "decodes": _decoders(),
               "round_trip": {"dec": _dec()}}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(launch.spawn, programs.several, 4, payload,
                          workdir=str(work), shape=(2, 2))


@pytest.fixture(scope="module")
def world(_world_run):
    return _world_run.result()


def _spec_dim(spec, ndim):
    """A JAX PartitionSpec -> the split dimension, or None."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    dims = [i for i, e in enumerate(entries) if e == jmesh.MODEL_AXIS]
    return dims[0] if dims else None


@pytest.mark.parametrize("family,vocab,tp", [
    ("factored", V, 2), ("factored", 31, 2), ("nic", V, 4),
    ("factored_att", V, 2), ("nic_att", 30, 4)])
def test_vocab_sharding_specs_match_jax(family, vocab, tp):
    """The same leaves split along the same dimension as JAX's
    ``decoder_param_shardings`` (``tests/test_parallel.py::
    test_vocab_sharding_specs``); a vocabulary that does not divide the
    model axis replicates."""
    from icee_tpu.core.config import AttentionDecoderConfig as JAtt
    from icee_tpu.models import attention as jatt
    from icee_tpu.models import lstm as jnic

    dims = dict(vocab_size=vocab, embed_size=8, hidden_size=16,
                factored_size=16)
    key = jax.random.PRNGKey(0)
    if family.endswith("_att"):
        cfg = JAtt(feature_size=12, attention_size=8, **dims)
        init = (jatt.init_factored_att_params if family == "factored_att"
                else jatt.init_rnn_att_params)
    else:
        cfg = JDecoderConfig(**dims)
        init = jfl.init_params if family == "factored" else jnic.init_params
    dec = jax.eval_shape(lambda k: init(k, cfg), key)    # shapes suffice
    mesh = jmesh.make_mesh((8 // tp, tp))
    want = jax.tree.map(lambda s, x: _spec_dim(s.spec, np.ndim(x)),
                        jmesh.decoder_param_shardings(dec, mesh), dec,
                        is_leaf=lambda s: hasattr(s, "spec"))
    got = decoder_param_shardings(jax.tree.map(
        lambda x: torch.empty(x.shape), dec), tp)
    assert got == want
    split = [k for k, d in got.items() if isinstance(d, int)]
    assert sorted(split) == ([] if vocab % tp else sorted(
        k for k in dec if k in ("B", "embed", "C_w", "C_b", "linear_w",
                                "linear_b")))


def test_mesh_helpers_match_jax():
    """``dp_tp_shape`` and ``shard_examples`` are JAX's; ``local_rows`` /
    ``row_slice`` cut a data rank's contiguous rows and refuse a batch that
    does not divide the data axis with JAX's message."""
    for n in range(1, 9):
        for tp in (1, 2, 3, 4):
            assert dp_tp_shape(n, tp) == jtrain.dp_tp_shape(n, tp)
    exs = list(range(10))
    for pc in (1, 3, 4):
        for pi in range(pc):
            assert pdata.shard_examples(exs, pi, pc) == \
                jdata.shard_examples(exs, pi, pc)
    mesh = Mesh((2, 2), 3, None, None, torch.device("cpu"), "gloo")
    assert (mesh.data_rank, mesh.model_rank) == (1, 1)
    assert (data_shards(mesh), model_shards(mesh)) == (2, 2)
    assert (data_shards(None), model_shards(None)) == (1, 1)
    assert jmesh.data_shards(None) == 1
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(pdata.local_rows(x, mesh), x[3:])
    assert pdata.local_rows((x, None), mesh)[1] is None
    with pytest.raises(ValueError, match="must divide by the data-axis"):
        pdata.row_slice(5, mesh)


def _jax_losses(p):
    """JAX's chunked losses and their gradients on the same inputs."""
    lengths, smask = jnp.asarray(p["lengths"]), jnp.asarray(p["sample_mask"])
    tg = jnp.asarray(p["targets"], jnp.int32)
    hw = [jnp.asarray(p[k]) for k in ("hiddens", "w", "b")]

    def mean(h, w, b):
        return jcl.masked_ce_from_hiddens(h, w, b, tg, lengths, smask,
                                          t_chunk=p["t_chunk"])

    def clamped(h, w, b):
        return jcl.masked_sum_ce_from_hiddens(h, w, b, tg,
                                              jnp.asarray(p["mask"]),
                                              p["clamp"], p["t_chunk"])

    def mixture(*args):
        return jcl.mixture_ce_from_hiddens(*args, tg,
                                           jnp.asarray(p["weights"]))

    mix = [jnp.asarray(p[k]) for k in ("hh_o", "hh_n", "co", "cn", "w_o",
                                       "b_o", "w_n", "b_n")]
    out = {}
    for name, fn, args in (("mean", mean, hw), ("sum_clamp", clamped, hw),
                           ("mixture", mixture, mix)):
        val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
            *args)
        out[name] = (float(val), [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def jax_losses():
    return _jax_losses(_loss_inputs())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_vocab_parallel_losses_match_jax(jax_losses, world, shape, case):
    """tp = 2 on the (2, 2) mesh and tp = 4 on (1, 4): the masked-mean CE,
    the masked-SUM CE with its clamp (decided on the whole row's nll) and
    the two-head mixture CE, the heads' columns split, against JAX's
    chunked losses: value rtol 1e-5, every gradient (dx, dW, db, d co, d
    cn) within 1e-5 x its max."""
    loss, grads = world[0]["vocab_losses"][shape][case]
    want_loss, want = jax_losses[case]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), \
            np.abs(g - w).max() / np.abs(w).max()


def test_every_rank_computes_the_same(world):
    """Every rank's losses, gradients and searches equal rank 0's at atol
    0 (the collectives end with the same bits on every rank)."""
    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b

    for r in range(1, 4):
        assert same(world[r]["vocab_losses"], world[0]["vocab_losses"])
        assert same(world[r]["decodes"], world[0]["decodes"])
        assert same(world[r]["round_trip"]["whole"],
                    world[0]["round_trip"]["whole"])


def test_shard_and_gather_round_trip(world):
    """A decoder cut into vocabulary slices (``shard_decoder``: B's rows,
    C_w's columns, C_b, each V / 2 on a model axis of 2) and gathered back
    (``gather_decoder``) is the decoder, bit for bit."""
    dec = _dec()
    for r in range(4):
        got = world[r]["round_trip"]
        for k, v in dec.items():
            np.testing.assert_array_equal(got["whole"][k], v)
        assert got["shapes"]["B"] == (V // 2, 8)
        assert got["shapes"]["C_w"] == (16, V // 2)
        assert got["shapes"]["C_b"] == (V // 2,)
        assert got["shapes"]["S_w"] == dec["S_w"].shape


@pytest.mark.parametrize("name", DECODES)
def test_sharded_searches_equal_one_process(world, name):
    """The sharded K2 (factored serving and research semantics, lstm) and
    K7 (factored, lstm) plain searches over the (2, 2) mesh's data axis of
    2 (two images a rank) are the one-process search's tokens, lengths and
    scores (``tests/test_parallel.py::
    test_sharded_mega_decode_matches_single_device`` and its attention
    twin)."""
    p = _decoders()
    with torch.no_grad():
        if name.startswith("k2"):
            cell, dec, feats = p["k2"][name]
            common = (IMAGES, K, MAX_LEN, 1, 2)
            f = None if feats is None else torch.from_numpy(feats)
            if cell == "lstm":
                res = fast.nic_decode(bridge.to_torch(dec), f, *common)
            else:
                res = fast.factored_decode("mega", bridge.to_torch(dec), f,
                                           p["style"], *common)
        else:
            kind, dec, spatial = p["k7"][name]
            res = fast._att_decode("mega", kind, bridge.to_torch(dec),
                                   torch.from_numpy(spatial), p["style"],
                                   IMAGES, K, MAX_LEN, 1, 2)
    got = world[0]["decodes"][name]
    assert got[0].shape[0] == IMAGES
    for g, w in zip(got, res):
        np.testing.assert_array_equal(g, w.numpy())
