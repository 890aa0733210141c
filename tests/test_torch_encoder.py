"""The port's image side vs the JAX package: ResNet-152 + encoder head on
bridged weights, the serving transforms, and the vocabulary pickles.

ResNet-152 pooled features at 32x32 are held to rtol = atol = 1e-4: 50
float32 conv layers deep, the two CPU conv libraries' summation orders
drift further than in the decoder.
"""

import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from icee_tpu.core.config import EncoderConfig as JEncoderConfig
from icee_tpu.data import transforms as jtransforms
from icee_tpu.models import encoder as jenc
from icee_tpu.models import resnet as jresnet
from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import EncoderConfig
from icee_tpu_torch.data import transforms
from icee_tpu_torch.data.vocab import Vocabulary, build_vocab, load_vocab
from icee_tpu_torch.models import encoder as enc
from icee_tpu_torch.models import resnet

torch.set_num_threads(2)


def test_resnet152_and_head_match_jax_on_bridged_weights():
    rng = np.random.default_rng(0)
    jbackbone = jresnet.init_params(jax.random.PRNGKey(0))
    # non-trivial BatchNorm statistics, so eval BN is exercised
    bn_rng = np.random.default_rng(1)

    def perturb(node):
        if isinstance(node, dict):
            if "running_mean" in node:
                c = node["running_mean"].shape[0]
                return {"weight": 1 + 0.1 * bn_rng.standard_normal(c),
                        "bias": 0.1 * bn_rng.standard_normal(c),
                        "running_mean": 0.1 * bn_rng.standard_normal(c),
                        "running_var": 1 + 0.1 * bn_rng.random(c)}
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        return np.asarray(node)

    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      perturb(jax.tree.map(np.asarray, jbackbone)))
    # damp each residual branch so 50 blocks keep activations O(1), the
    # regime trained weights run in (He init with identity BN grows ~1e4x)
    for li in range(1, 5):
        for block in jp[f"layer{li}"]:
            block["bn3"]["weight"] *= np.float32(0.2)
    images = rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)

    jx = jtransforms.normalize(jnp.asarray(images))
    want, _ = jax.jit(lambda p, x: jresnet.global_features(p, x))(jp, jx)
    tx = transforms.normalize(torch.tensor(images))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    got = resnet.global_features(bridge.to_torch(jp), tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    jhead = jax.tree.map(np.asarray, jenc.init_head_params(
        jax.random.PRNGKey(2), JEncoderConfig(embed_size=8)))
    jhead["bn"] = {"weight": np.full(8, 1.5, np.float32),
                   "bias": np.full(8, 0.2, np.float32),
                   "running_mean": np.full(8, 0.1, np.float32),
                   "running_var": np.full(8, 2.0, np.float32)}
    want_f, _ = jenc.encode_global_from_pooled(jhead, want, train=False)
    got_f = enc.encode_global_from_pooled(bridge.to_torch(jhead), got)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-4,
                               atol=1e-4)


def test_resnet_primitives_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)   # odd size
    w = rng.standard_normal((3, 3, 6, 4)).astype(np.float32)   # HWIO
    want = jresnet.conv(jnp.asarray(x), jnp.asarray(w), stride=2)
    got = resnet.conv(torch.tensor(x), torch.tensor(w), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want_p = jresnet.max_pool_3x3_s2(jnp.asarray(x))
    got_p = resnet.max_pool_3x3_s2(torch.tensor(x))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    want_a = jresnet.adaptive_avg_pool(jnp.asarray(x), (4, 4))
    got_a = resnet.adaptive_avg_pool(torch.tensor(x), (4, 4))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2)])
def test_bfloat16_conv_matches_jax_conv(k, stride):
    """A conv with bfloat16 weights (the ``backbone_dtype="bfloat16"`` mode)
    does the JAX conv's arithmetic: bfloat16 operands, float32 products and
    sums, a float32 result.  Held within 2e-6 of the largest magnitude (the
    two summation orders); rounding each output to bfloat16 would be ~2e-3
    off."""
    rng = np.random.default_rng(7 + k + stride)
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, k, 64, 32))).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, w: jresnet.conv(x, w, stride))(
        jnp.asarray(x), jnp.asarray(w).astype(jnp.bfloat16)))
    got = resnet.conv(torch.tensor(x), torch.tensor(w).bfloat16(), stride)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("stride,downsample", [(1, False), (2, True)])
def test_bottleneck_matches_jax(stride, downsample):
    """One block on NHWC input with HWIO weights, the JAX layouts."""
    rng = np.random.default_rng(6)
    c_in, planes = 8, 4
    c_out = planes * resnet.EXPANSION if downsample else c_in

    def bn(c):
        return {"weight": 1 + 0.1 * rng.standard_normal(c),
                "bias": 0.1 * rng.standard_normal(c),
                "running_mean": 0.1 * rng.standard_normal(c),
                "running_var": 1 + 0.1 * rng.random(c)}

    p = {"conv1": rng.standard_normal((1, 1, c_in, planes)), "bn1": bn(planes),
         "conv2": rng.standard_normal((3, 3, planes, planes)),
         "bn2": bn(planes),
         "conv3": rng.standard_normal((1, 1, planes, c_out)),
         "bn3": bn(c_out)}
    if downsample:
        p["downsample_conv"] = rng.standard_normal((1, 1, c_in, c_out))
        p["downsample_bn"] = bn(c_out)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32) * np.float32(0.3), p)
    x = rng.standard_normal((2, 7, 7, c_in)).astype(np.float32)
    want, _ = jresnet.bottleneck(jnp.asarray(x), p, stride, train_bn=False)
    got = resnet.bottleneck(torch.tensor(x), bridge.to_torch(p), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_init_params_layout_matches_jax():
    tp = resnet.init_params(torch.Generator().manual_seed(0))
    jp = jax.eval_shape(lambda: jresnet.init_params(jax.random.PRNGKey(0)))
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: tuple(t.shape), tp,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)),
        is_leaf=lambda t: isinstance(t, tuple))
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda s: tuple(s.shape), jp),
        is_leaf=lambda t: isinstance(t, tuple))
    assert flat_t == flat_j
    head = enc.init_head_params(torch.Generator().manual_seed(0),
                                EncoderConfig(embed_size=8))
    assert tuple(head["linear_w"].shape) == (2048, 8)
    assert float(head["linear_w"].abs().max()) <= 1 / np.sqrt(2048)


def test_host_decode_resize_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    p = str(tmp_path / "img.jpg")
    Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8)).save(p)
    np.testing.assert_array_equal(transforms.host_decode_resize(p, 32),
                                  jtransforms.host_decode_resize(p, 32))


def test_load_vocab_reads_jax_and_reference_pickles(tmp_path, tiny_vocab,
                                                    monkeypatch):
    """A pickle of ``icee_tpu.data.vocab.Vocabulary`` and one of a foreign
    ``build_vocab.Vocabulary`` both load as the port's Vocabulary."""
    path = str(tmp_path / "vocab.pkl")
    tiny_vocab.save(path)
    v = load_vocab(path)
    assert isinstance(v, Vocabulary)
    assert v.word2idx == tiny_vocab.word2idx and v.idx == tiny_vocab.idx
    assert v.encode(["anak", "zzz"]) == tiny_vocab.encode(["anak", "zzz"])

    # the reference's pickle: a ``build_vocab.Vocabulary`` instance, written
    # while a stand-in ``build_vocab`` module exists and loaded without it
    mod = types.ModuleType("build_vocab")
    ref_cls = type("Vocabulary", (), {"__module__": "build_vocab"})
    mod.Vocabulary = ref_cls
    ref = ref_cls()
    ref.word2idx, ref.idx2word, ref.idx = {"<pad>": 0}, {0: "<pad>"}, 1
    ref_path = tmp_path / "ref.pkl"
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "build_vocab", mod)
        ref_path.write_bytes(pickle.dumps(ref))
    r = load_vocab(str(ref_path))
    assert isinstance(r, Vocabulary) and r.word2idx == {"<pad>": 0}


def test_build_vocab_matches_jax(tmp_path):
    from icee_tpu.data.vocab import build_vocab as jbuild

    p = tmp_path / "caps.txt"
    p.write_text("a.jpg#0\tseorang anak bermain bola.\n"
                 "b.jpg#0\tanak anjing bermain, di lapangan.\n"
                 "c.jpg#0\tanak bermain bola dengan senang.\n")
    got, want = build_vocab(str(p), threshold=2), jbuild(str(p), threshold=2)
    assert got.word2idx == want.word2idx


@pytest.mark.parametrize("shape", [(1, 4, 4, 3), (3, 2, 2, 3)])
def test_normalize_matches_jax(shape):
    x = np.random.default_rng(5).integers(0, 255, shape).astype(np.uint8)
    np.testing.assert_allclose(transforms.normalize(torch.tensor(x)).numpy(),
                               np.asarray(jtransforms.normalize(x)),
                               rtol=1e-6, atol=1e-6)
