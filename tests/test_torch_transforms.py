"""The port's training transforms, ``encode_global``, ``greedy_decode`` and
``precompute_features`` against the JAX package's on the CPU.

- ``train_augment``: JAX draws each image's crop offsets and flip coin with
  ``jax.random``, which torch cannot reproduce, so the test draws them as
  JAX's ``train_augment`` does and hands them to the port's ``crop_flip``:
  its uint8 crops equal JAX's (atol 0), and the normalized values agree
  within 1e-6 (XLA's fused normalize rounds differently).  The port's own
  draws keep torchvision's ranges: offsets in [0, dim - crop] inclusive,
  one coin an image.
- ``encode_global`` and ``precompute_features``: both packages read the
  same seeded-NumPy ResNet-152 npz (torchvision's state-dict names, each
  residual branch damped by bn3 x 0.2 so 50 blocks keep activations O(1),
  BatchNorm statistics drawn around 1 and 0).  Held to rtol = atol = 1e-4,
  as ``tests/test_torch_encoder.py`` holds ResNet-152: the two CPU conv
  libraries sum in different orders through 50 float32 layers.
- ``greedy_decode``: the ids equal.
"""

import runpy
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.core.config import DecoderConfig as JDecoderConfig
from icee_tpu.core.config import EncoderConfig as JEncoderConfig
from icee_tpu.data import transforms as jtransforms
from icee_tpu.decode.greedy import greedy_decode as jgreedy
from icee_tpu.models import encoder as jenc
from icee_tpu.models import factored_lstm as jfl
from icee_tpu.models import resnet as jresnet
from icee_tpu_torch import bridge
from icee_tpu_torch.cli import precompute_features
from icee_tpu_torch.data import transforms
from icee_tpu_torch.decode.greedy import greedy_decode
from icee_tpu_torch.models import encoder as enc
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import resnet

IMG_DIR = "examples/data/img"
TOL = dict(rtol=1e-4, atol=1e-4)


def resnet_npz(path, seed=0):
    """A seeded-NumPy ResNet-152 in torchvision's state-dict names (OIHW
    convs, He-normal), BatchNorm statistics around 1 and 0, bn3 x 0.2."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        w = rng.standard_normal((o, i, k, k), dtype=np.float32)
        return w * np.float32(np.sqrt(2.0 / (o * k * k)))

    def bn(prefix, c, scale=1.0):
        return {f"{prefix}.weight": (scale * (1 + 0.1 * rng.standard_normal(
                    c))).astype(np.float32),
                f"{prefix}.bias": (0.1 * rng.standard_normal(c)).astype(
                    np.float32),
                f"{prefix}.running_mean": (0.1 * rng.standard_normal(
                    c)).astype(np.float32),
                f"{prefix}.running_var": (1 + 0.1 * rng.random(c)).astype(
                    np.float32)}

    sd = {"conv1.weight": conv(64, 3, 7), **bn("bn1", 64)}
    in_c = 64
    for li, (nblocks, planes) in enumerate(zip(resnet.LAYERS_152,
                                               resnet.PLANES)):
        out_c = planes * resnet.EXPANSION
        for bi in range(nblocks):
            pre = f"layer{li + 1}.{bi}"
            sd[f"{pre}.conv1.weight"] = conv(planes, in_c, 1)
            sd.update(bn(f"{pre}.bn1", planes))
            sd[f"{pre}.conv2.weight"] = conv(planes, planes, 3)
            sd.update(bn(f"{pre}.bn2", planes))
            sd[f"{pre}.conv3.weight"] = conv(out_c, planes, 1)
            sd.update(bn(f"{pre}.bn3", out_c, scale=0.2))
            if bi == 0:
                sd[f"{pre}.downsample.0.weight"] = conv(out_c, in_c, 1)
                sd.update(bn(f"{pre}.downsample.1", out_c))
            in_c = out_c
    np.savez(path, **sd)
    return sd


@pytest.fixture(scope="module")
def backbone_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("resnet") / "resnet.npz")
    resnet_npz(path)
    return path


def _jax_draws(key, b, h, w, crop):
    """The draws inside JAX's ``train_augment`` for one key."""
    k_y, k_x, k_flip = jax.random.split(key, 3)
    off_y = jax.random.randint(k_y, (b,), 0, h - crop + 1)
    off_x = jax.random.randint(k_x, (b,), 0, w - crop + 1)
    flips = jax.random.bernoulli(k_flip, 0.5, (b,))
    return np.stack([np.asarray(off_y), np.asarray(off_x)], 1), \
        np.asarray(flips)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_flip_with_jax_draws_matches_train_augment(seed):
    """The crop and flip equal JAX's to the last bit: JAX's output mapped
    back to uint8 through its own jitted ``normalize`` of every level (the
    levels lie ~0.017 apart) is the port's uint8 crop.  The normalized
    values differ within 1e-6: XLA's fused normalize rounds differently
    from the plain one, which the port's matches exactly
    (``test_eval_preprocess_matches_jax``)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (6, 20, 17, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jtransforms.train_augment(jnp.asarray(images), key,
                                                crop_size=12))
    offsets, flips = _jax_draws(key, 6, 20, 17, 12)
    assert flips.any() and not flips.all()
    crops = transforms.crop_flip(torch.tensor(images), torch.tensor(offsets),
                                 torch.tensor(flips), crop_size=12)
    assert crops.dtype == torch.uint8 and crops.shape == (6, 12, 12, 3)
    levels = np.asarray(jax.jit(jtransforms.normalize)(jnp.asarray(
        np.arange(256, dtype=np.uint8)[:, None].repeat(3, 1))))  # (256, 3)
    jax_crops = np.abs(want[..., None, :] - levels).argmin(-2)
    np.testing.assert_array_equal(crops.numpy(), jax_crops)
    np.testing.assert_allclose(transforms.normalize(crops).numpy(), want,
                               rtol=0, atol=1e-6)


def test_train_augment_draws_keep_torchvision_ranges():
    """Offsets cover [0, dim - crop] inclusive, both ends reached; one coin
    an image, both sides seen; the draws come from the generator alone."""
    g = torch.Generator().manual_seed(0)
    offsets, flips = transforms.augment_draws(4000, 10, 7, 6, g)
    assert sorted(set(offsets[:, 0].tolist())) == list(range(5))
    assert sorted(set(offsets[:, 1].tolist())) == list(range(2))
    assert 0.45 < flips.float().mean().item() < 0.55
    images = torch.randint(0, 256, (3, 10, 7, 3), dtype=torch.uint8)
    a = transforms.train_augment(images, torch.Generator().manual_seed(5), 6)
    b = transforms.train_augment(images, torch.Generator().manual_seed(5), 6)
    assert a.shape == (3, 6, 6, 3) and torch.equal(a, b)


def test_eval_preprocess_matches_jax():
    """Equal to the last bit to JAX's normalize run op by op (eagerly);
    within 1e-6 of the jitted ``eval_preprocess``, whose fused arithmetic
    rounds differently."""
    images = np.random.default_rng(3).integers(0, 256, (2, 9, 9, 3),
                                               dtype=np.uint8)
    got = transforms.eval_preprocess(torch.tensor(images), crop_size=9)
    with jax.disable_jit():
        eager = np.asarray(jtransforms.normalize(jnp.asarray(images)))
    np.testing.assert_array_equal(got.numpy(), eager)
    jitted = np.asarray(jtransforms.eval_preprocess(jnp.asarray(images),
                                                    crop_size=9))
    np.testing.assert_allclose(got.numpy(), jitted, rtol=0, atol=1e-6)


def test_encode_global_matches_jax(backbone_npz):
    """Training mode with the frozen backbone's BatchNorms on the batch
    statistics (the reference quirk), and eval mode, from one JAX
    compile: the features, the head's and the backbone's new running
    statistics."""
    with np.load(backbone_npz) as f:
        sd = dict(f)
    jbackbone = jax.tree.map(np.asarray, jresnet.import_torch_state_dict(sd))
    jhead = jax.tree.map(np.asarray, jenc.init_head_params(
        jax.random.PRNGKey(2), JEncoderConfig(embed_size=8)))
    images = np.random.default_rng(4).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    x = np.asarray(jtransforms.normalize(jnp.asarray(images)))

    @jax.jit
    def both(p, h, x):
        return (jenc.encode_global(p, h, x, train=True,
                                   backbone_train_bn=True),
                jenc.encode_global(p, h, x, train=False))

    (jf, jb, jh), (jf_eval, _, _) = both(jbackbone, jhead, x)
    backbone = resnet.import_torch_state_dict(sd)
    head = bridge.to_torch(jhead)
    f, b, h = enc.encode_global(backbone, head, torch.tensor(x), train=True,
                                backbone_train_bn=True)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(h["bn"][key].numpy(),
                                   np.asarray(jh["bn"][key]), **TOL)
        for got, want in ((b["bn1"], jb["bn1"]),
                          (b["layer4"][-1]["bn3"], jb["layer4"][-1]["bn3"])):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), **TOL)
    f_eval, b_eval, h_eval = enc.encode_global(backbone, head,
                                               torch.tensor(x), train=False)
    np.testing.assert_allclose(f_eval.numpy(), np.asarray(jf_eval), **TOL)
    assert b_eval is backbone and h_eval is head


def test_greedy_decode_matches_jax():
    cfg = JDecoderConfig(vocab_size=40, embed_size=12, hidden_size=16,
                         factored_size=16, max_seq_length=9)
    jdec = jax.tree.map(np.asarray, jfl.init_params(jax.random.PRNGKey(5),
                                                    cfg))
    feats = np.random.default_rng(6).standard_normal((5, 12)).astype(
        np.float32)

    @partial(jax.jit, static_argnums=2)
    def jrun(dec, feats, style):
        return jgreedy(lambda t: jfl.embed(dec, t),
                       lambda x, s: jfl.decode_step(dec, x, s,
                                                    jnp.asarray(style)),
                       jfl.initial_state(5, cfg), feats, cfg.max_seq_length)

    dec = bridge.to_torch(jdec)
    for style in (0, 2):
        want = np.asarray(jrun(jdec, feats, style))
        got = greedy_decode(lambda t: fl.embed(dec, t),
                            lambda x, s: fl.decode_step(dec, x, s, style),
                            fl.initial_state(5, cfg), torch.tensor(feats),
                            cfg.max_seq_length)
        assert got.shape == (5, cfg.max_seq_length)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(np.unique(want)) > 1


def test_precompute_features_matches_jax(backbone_npz, tmp_path,
                                         monkeypatch):
    """4 images at crop 64 in batches of 3 (the last one padded): the same
    npz keys, the features within the stated tolerance; ``--spatial
    --grid 2`` over the 2 x 2 feature map gives the same positions, whose
    mean is the pooled feature."""
    names = ["i1.jpg", "i2.jpg", "i5.jpg", "i7.jpg"]
    caps = tmp_path / "caps.txt"
    caps.write_text("".join(f"{n}#{j}\tsebuah gambar\n" for n in names
                            for j in range(2)))
    argv = ["--caption_path", str(caps), "--image_dir", IMG_DIR,
            "--resnet_weights", backbone_npz, "--crop_size", "64",
            "--batch_size", "3"]
    monkeypatch.setattr(sys, "argv", ["precompute_features", *argv, "--out",
                                      str(tmp_path / "jax.npz")])
    runpy.run_module("icee_tpu.cli.precompute_features", run_name="__main__")
    p = precompute_features.parser()
    precompute_features.main(p.parse_args(
        argv + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"]))
    precompute_features.main(p.parse_args(
        argv + ["--out", str(tmp_path / "spatial.npz"), "--device", "cpu",
                "--spatial", "--grid", "2"]))
    with np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "port.npz") as t, \
            np.load(tmp_path / "spatial.npz") as s:
        assert sorted(j.files) == sorted(t.files) == names
        for n in names:
            assert t[n].shape == (2048,) and t[n].dtype == np.float32
            np.testing.assert_allclose(t[n], j[n], **TOL)
            assert s[n].shape == (4, 2048)
            np.testing.assert_allclose(s[n].mean(0), t[n], rtol=1e-5,
                                       atol=1e-6)


def test_augmenting_provider_matches_jax_with_its_draws(backbone_npz,
                                                        monkeypatch):
    """``make_feature_provider(augment=True)`` over ``--image_dir``: each
    call crops and flips the cached resized image afresh and runs the
    backbone.  JAX splits its key once a call and draws inside
    ``train_augment``; the same chain hands the port's ``augment_draws``
    JAX's offsets and coins.  Held to the ResNet tolerance; the memoized
    eval provider gives one feature an image."""
    from types import SimpleNamespace

    from icee_tpu.cli import common as jcommon
    from icee_tpu_torch.cli import common

    args = SimpleNamespace(feature_cache=None, image_dir=IMG_DIR,
                           resnet_weights=backbone_npz, crop_size=32,
                           backbone_dtype="float32", device="cpu")
    names = ["i1.jpg", "i4.jpg", "i1.jpg"]
    jprov = jcommon.make_feature_provider(args, augment=True,
                                          resize_size=48, seed=3)
    want = [np.asarray(jprov(n)) for n in names]
    chain = {"key": jax.random.PRNGKey(3)}

    def jax_draws(b, h, w, crop, generator):
        chain["key"], k = jax.random.split(chain["key"])
        offsets, flips = _jax_draws(k, b, h, w, crop)
        return torch.tensor(offsets), torch.tensor(flips)

    monkeypatch.setattr(transforms, "augment_draws", jax_draws)
    prov = common.make_feature_provider(args, augment=True, resize_size=48,
                                        seed=3)
    got = [prov(n) for n in names]
    for g, w in zip(got, want):
        assert g.shape == (2048,)
        np.testing.assert_allclose(g, w, **TOL)
    assert not np.allclose(got[0], got[2])      # a fresh crop every call
    evalp = common.make_feature_provider(args)
    assert evalp("i1.jpg") is evalp("i1.jpg")


def test_native_decode_without_its_library_says_so_and_uses_pil(
        backbone_npz, tmp_path, monkeypatch, capsys):
    """``--native_decode`` where the JPEG decoder did not build (no g++ or
    no libjpeg headers): a warning on stderr, and the features of the PIL
    path."""
    from icee_tpu_torch.native import imagedec

    caps = tmp_path / "caps.txt"
    caps.write_text("i1.jpg#0\tsebuah gambar\ni4.jpg#0\tsebuah gambar\n")
    argv = ["--caption_path", str(caps), "--image_dir", IMG_DIR,
            "--resnet_weights", backbone_npz, "--crop_size", "32",
            "--device", "cpu"]
    p = precompute_features.parser()
    precompute_features.main(p.parse_args(
        argv + ["--out", str(tmp_path / "pil.npz")]))
    monkeypatch.setattr(imagedec, "native_available", lambda: False)
    capsys.readouterr()
    precompute_features.main(p.parse_args(
        argv + ["--out", str(tmp_path / "native.npz"), "--native_decode"]))
    captured = capsys.readouterr()
    assert "--native_decode" in captured.err and "PIL" in captured.err
    assert "native libjpeg" not in captured.out
    with np.load(tmp_path / "pil.npz") as a, \
            np.load(tmp_path / "native.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["i1.jpg", "i4.jpg"]
        for n in a.files:
            np.testing.assert_array_equal(a[n], b[n])
