"""The serving slice as a whole: the port's CaptionEngine (serial: K1 for
stylenet, K2 with the LSTM cell for nic, K6 for the attention variants),
BatchingEngine (one K2 or K7 launch per variant) and HTTP ``POST
/generate`` against the JAX engines' captions of all four variants
(``nic``, ``nic_att``, ``stylenet``, ``stylenet_att``), with the JAX
engine's weights bridged across and the tiny configs of
``tests/test_serve_batching.py``.  Captions must be identical.  Engines
built from reference torch checkpoints (decoder state dicts and full-module
pickles, written here from the same weights) caption as the engines built
from ``params``."""

import json
import sys
import threading
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import AttentionDecoderConfig as AttConfig
from icee_tpu_torch.core.config import DecoderConfig, EncoderConfig
from icee_tpu_torch.serve.config import MODEL_VARIANTS, ServeConfig

torch.set_num_threads(2)
MODES = ("factual", "happy", "sad", "angry")
SERVED = MODEL_VARIANTS
# attention weights: (seed, scale of the weights that read the 2048-wide
# features, <end> bias)
ATT_SHAPE = {"stylenet_att": (8, 0.6, 0.0), "nic_att": (9, 2.0, 1.0)}


def _resnet_npz(path):
    """A random ResNet-152 in torchvision's state-dict keys (OIHW convs) for
    the JAX engine's ``resnet_weights`` loader, which takes it much faster
    than its own random init.  Each residual branch is damped (bn3 x 0.2) so
    50 blocks keep activations O(1), as trained weights do."""
    from icee_tpu_torch.models import resnet

    params = resnet.init_params(torch.Generator().manual_seed(0))

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous()

    sd = {"conv1.weight": oihw(params["conv1"])}
    sd.update({f"bn1.{k}": v for k, v in params["bn1"].items()})
    for li in range(1, 5):
        for bi, block in enumerate(params[f"layer{li}"]):
            pre = f"layer{li}.{bi}"
            block["bn3"]["weight"] = block["bn3"]["weight"] * 0.2
            names = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
                     "downsample_conv": "downsample.0"}
            bns = {"bn1": "bn1", "bn2": "bn2", "bn3": "bn3",
                   "downsample_bn": "downsample.1"}
            for key, name in names.items():
                if key in block:
                    sd[f"{pre}.{name}.weight"] = oihw(block[key])
            for key, name in bns.items():
                if key in block:
                    sd.update({f"{pre}.{name}.{k}": v
                               for k, v in block[key].items()})
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from icee_tpu.core.config import AttentionDecoderConfig
    from icee_tpu.core.config import DecoderConfig as JDecoderConfig
    from icee_tpu.core.config import EncoderConfig as JEncoderConfig
    from icee_tpu.data.vocab import SPECIALS, Vocabulary
    from icee_tpu.serve.config import ServeConfig as JServeConfig
    from icee_tpu.serve.engine import CaptionEngine as JCaptionEngine
    from icee_tpu_torch.serve.engine import CaptionEngine

    tmp = tmp_path_factory.mktemp("serve")
    vocab = Vocabulary()
    for w in SPECIALS + ("seorang", "anak", "bermain", "bola", "di",
                         "lapangan", "anjing", "berlari", "dengan", "senang"):
        vocab.add_word(w)
    vocab.save(str(tmp / "vocab.pkl"))
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = str(tmp / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8),
                        "RGB").save(p)
        paths.append(p)

    v = len(vocab)
    dims = dict(vocab_size=v, embed_size=8, hidden_size=12, factored_size=12,
                max_seq_length=5)
    _resnet_npz(str(tmp / "resnet.npz"))
    att_dims = dict(attention_size=8, **dims)
    jeng = JCaptionEngine(
        JServeConfig(vocab_path=str(tmp / "vocab.pkl"),
                     image_folder=str(tmp),
                     resnet_weights=str(tmp / "resnet.npz")),
        smoke_mode=True, image_size=32, dec_cfg=JDecoderConfig(**dims),
        att_cfg=AttentionDecoderConfig(**att_dims),
        enc_cfg=JEncoderConfig(embed_size=8))
    # Weights that caption: the smoke init gives every image the bare
    # [<end>] fallback (its head logits barely move).  N(0, 1) decoder
    # weights, a stronger encoder head and the damped backbone above give
    # captions of one to five words.  Set before the JAX engine's first call,
    # which captures them.
    wrng = np.random.default_rng(8)
    trees = {}
    for variant, end_b in (("stylenet", "C_b"), ("nic", "linear_b")):
        jpipe = jeng.models[variant]["happy"]
        dec = jax.tree.map(
            lambda a: wrng.standard_normal(a.shape).astype(np.float32),
            jpipe["decoder"])
        dec[end_b][vocab.end] = -1.0
        head = jax.tree.map(np.asarray, jpipe["head"])
        head["linear_w"] = head["linear_w"] * np.float32(30.0)
        head["linear_b"] = head["linear_b"] * np.float32(30.0)
        trees[variant] = {"decoder": dec, "head": head}
    # The attention decoders: N(0, 1) weights too, except where they read
    # the 2048-wide features (init_h/init_c, enc_w and the cell's context
    # rows), scaled so the image moves h0 and the context; with the <end>
    # bias, captions of zero to several words that depend on the image (the
    # attention variants have no encoder head)
    for variant, (seed, scale, end_bias) in ATT_SHAPE.items():
        arng = np.random.default_rng(seed)

        def redraw(a, scale=scale, arng=arng):
            w = arng.standard_normal(a.shape).astype(np.float32)
            return w * np.float32(scale) if a.ndim >= 2 and \
                a.shape[-2] >= 2048 else w

        dec = jax.tree.map(lambda a: redraw(np.asarray(a)),
                           jeng.models[variant]["happy"]["decoder"])
        cell_w, b = ((dec["V_w"], "C_b") if variant == "stylenet_att"
                     else (dec["cell"]["W_ih"], "linear_b"))
        cell_w[dims["embed_size"]:] *= np.float32(scale)
        dec[b][vocab.end] = end_bias
        trees[variant] = {"decoder": dec}
    jeng.models = {}
    for variant, tree in trees.items():
        pipeline = jax.tree.map(jax.numpy.asarray, tree)
        # one shared pipeline: the engine compiles it once
        jeng.models[variant] = {mode: pipeline for mode in MODES}
    backbone = jax.tree.map(np.asarray, jeng.backbone)
    params = bridge.to_torch(dict(trees, backbone=backbone))
    eng = CaptionEngine(
        ServeConfig(vocab_path=str(tmp / "vocab.pkl"),
                    image_folder=str(tmp / "uploads")),
        image_size=32, dec_cfg=DecoderConfig(**dims),
        enc_cfg=EncoderConfig(embed_size=8), device="cpu", params=params,
        att_cfg=AttConfig(**att_dims))
    want = {(p, m): {v: c for v, c in jeng.caption(p, m).items()
                     if v in SERVED}
            for p in paths for m in MODES}
    return jeng, eng, paths, want, params


def test_serial_engine_matches_jax_captions(engines):
    _, eng, paths, want, _ = engines
    for (p, m), captions in want.items():
        got = eng.caption(p, m)
        assert {v: got[v] for v in SERVED} == captions, (p, m)
    for variant in SERVED:
        lengths = {len(c[variant].split()) for c in want.values()}
        assert len(lengths) > 1, f"{variant}: captions of one length"


def test_batching_engine_matches_jax_batching(engines):
    from icee_tpu.serve.batching import BatchingEngine as JBatchingEngine
    from icee_tpu_torch.serve.batching import BatchingEngine

    jeng, eng, paths, want, _ = engines
    requests = [(p, m) for p in paths for m in ("happy", "sad")]
    for engine_cls, inner in ((BatchingEngine, eng), (JBatchingEngine, jeng)):
        batched = engine_cls(inner, window_ms=500.0, max_batch=8)
        results, errors = {}, []

        def worker(p, m):
            try:
                got = batched.caption(p, m)
                results[(p, m)] = {v: got[v] for v in SERVED}
            except Exception as e:  # noqa: BLE001 - collected and asserted
                errors.append(e)

        threads = [threading.Thread(target=worker, args=r) for r in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
        assert results == {r: want[r] for r in requests}, engine_cls
        assert sum(batched.group_sizes) == len(requests)
        assert max(batched.group_sizes) > 1   # 3 images padded to 4


def _factored_state_dict(dec):
    """A params tree -> the reference ``DecoderFactoredLSTM`` state dict
    (the inverse of ``import_factored_decoder_state_dict``)."""
    f, h = dec["U_w"].shape[1], dec["W_w"].shape[0]
    sd = {"B.weight": dec["B"], "C.weight": dec["C_w"].T,
          "C.bias": dec["C_b"]}
    for g, name in enumerate(("i", "f", "o", "c")):
        sd[f"V_{name}.weight"] = dec["V_w"][:, g * f:(g + 1) * f].T
        sd[f"V_{name}.bias"] = dec["V_b"][g]
        sd[f"U_{name}.weight"] = dec["U_w"][g].T
        sd[f"U_{name}.bias"] = dec["U_b"][g]
        sd[f"W_{name}.weight"] = dec["W_w"][:, g * h:(g + 1) * h].T
        sd[f"W_{name}.bias"] = dec["W_b"][g]
        for s, sp in enumerate(("f", "happy_", "sad_", "angry_")):
            sd[f"S_{sp}{name}.weight"] = dec["S_w"][s, g].T
            sd[f"S_{sp}{name}.bias"] = dec["S_b"][s, g]
    return {k: v.contiguous().clone() for k, v in sd.items()}


ATT_NETS = ("attention", "attention_happy", "attention_sad",
            "attention_angry")
ATT_LINEARS = (("enc", "encoder_att"), ("dec", "decoder_att"),
               ("full", "full_att"))


def _att_extras_state_dict(dec, nets):
    """The attention nets, h/c init projections and gate of an attention
    decoder's params -> the reference state dict entries (the inverse of
    the attention importers)."""
    sd = {}
    for s, net in enumerate(nets):
        for ours, theirs in ATT_LINEARS:
            w, b = dec["attention"][f"{ours}_w"], dec["attention"][f"{ours}_b"]
            if w.dim() == 3:   # stacked per style
                w, b = w[s], b[s]
            sd[f"{net}.{theirs}.weight"] = w.T
            sd[f"{net}.{theirs}.bias"] = b
    for name in ("init_h", "init_c", "f_beta"):
        sd[f"{name}.weight"] = dec[f"{name}_w"].T
        sd[f"{name}.bias"] = dec[f"{name}_b"]
    return sd


def _factored_att_state_dict(dec):
    """A StyleNet+Att params tree -> the reference ``DecoderFactoredLSTMAtt``
    state dict."""
    sd = dict(_factored_state_dict(dec), **_att_extras_state_dict(dec,
                                                                  ATT_NETS))
    return {k: v.contiguous().clone() for k, v in sd.items()}


def _save_nic_att_full_pickle(path, dec):
    """The reference's full checkpoint of a NIC+Att model: a spatial
    ``EncoderCNN`` (the ResNet only, no head) and a ``DecoderRNNAtt`` with
    its ``Attention`` submodule, pickled as whole modules whose classes then
    vanish."""
    import torch.nn as nn

    mod = types.ModuleType("model_att")
    v, e = dec["embed"].shape
    h = dec["cell"]["W_hh"].shape[0]
    fs, a = dec["attention"]["enc_w"].shape

    class EncoderCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.resnet = nn.Sequential(nn.Conv2d(3, 4, 1))

    class Attention(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_att = nn.Linear(fs, a)
            self.decoder_att = nn.Linear(h, a)
            self.full_att = nn.Linear(a, 1)

    class DecoderRNNAtt(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(v, e)
            self.lstm = nn.LSTMCell(e + fs, h)
            self.linear = nn.Linear(h, v)
            self.attention = Attention()
            self.init_h = nn.Linear(fs, h)
            self.init_c = nn.Linear(fs, h)
            self.f_beta = nn.Linear(h, fs)

    for cls in (EncoderCNN, Attention, DecoderRNNAtt):
        cls.__module__, cls.__qualname__ = "model_att", cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules["model_att"] = mod
    try:
        d = DecoderRNNAtt()
        c = dec["cell"]
        d.load_state_dict(dict(
            _att_extras_state_dict(dec, ("attention",)),
            **{"embed.weight": dec["embed"], "lstm.weight_ih": c["W_ih"].T,
               "lstm.weight_hh": c["W_hh"].T, "lstm.bias_ih": c["b_ih"],
               "lstm.bias_hh": c["b_hh"], "linear.weight": dec["linear_w"].T,
               "linear.bias": dec["linear_b"]}))
        torch.save({"epoch": 1, "encoder": EncoderCNN(), "decoder": d}, path)
    finally:
        del sys.modules["model_att"]


def _save_nic_full_pickle(path, dec, head):
    """The reference's full checkpoint of a NIC model: ``{"encoder":
    EncoderCNN, "decoder": DecoderRNN, ...}`` pickled as whole modules whose
    classes then vanish, so only the stub unpickler can read it."""
    import torch.nn as nn

    mod = types.ModuleType("model")

    class EncoderCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.resnet = nn.Sequential(nn.Conv2d(3, 4, 1))
            self.linear = nn.Linear(*head["linear_w"].shape)
            self.bn = nn.BatchNorm1d(head["linear_w"].shape[1])

    class DecoderRNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(*dec["embed"].shape)
            self.lstm = nn.LSTMCell(dec["embed"].shape[1],
                                    dec["cell"]["W_hh"].shape[0])
            self.linear = nn.Linear(*dec["linear_w"].shape)

    for cls in (EncoderCNN, DecoderRNN):
        cls.__module__, cls.__qualname__ = "model", cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules["model"] = mod
    try:
        enc, d = EncoderCNN(), DecoderRNN()
        c = dec["cell"]
        d.load_state_dict({
            "embed.weight": dec["embed"], "lstm.weight_ih": c["W_ih"].T,
            "lstm.weight_hh": c["W_hh"].T, "lstm.bias_ih": c["b_ih"],
            "lstm.bias_hh": c["b_hh"], "linear.weight": dec["linear_w"].T,
            "linear.bias": dec["linear_b"]})
        enc.load_state_dict(dict(
            enc.state_dict(), **{"linear.weight": head["linear_w"].T,
                                 "linear.bias": head["linear_b"]},
            **{f"bn.{k}": v for k, v in head["bn"].items()}))
        torch.save({"epoch": 1, "encoder": enc, "decoder": d}, path)
    finally:
        del sys.modules["model"]


def test_engines_from_torch_checkpoints_caption_as_params(engines, tmp_path):
    """stylenet and stylenet_att from decoder state dicts (stylenet's head
    is then the variant's seeded template, as in the JAX engine), nic from
    a full-module pickle with its encoder head and nic_att from one whose
    spatial encoder has no head; the backbone from the torchvision-keyed
    .npz."""
    import dataclasses
    import os

    from icee_tpu_torch.serve.engine import CaptionEngine

    _, eng, paths, want, params = engines
    sty_path = str(tmp_path / "stylenet.pth")
    nic_path = str(tmp_path / "HAP_BEST_checkpoint_nic.pth.tar")
    torch.save(_factored_state_dict(params["stylenet"]["decoder"]), sty_path)
    _save_nic_full_pickle(nic_path, params["nic"]["decoder"],
                          params["nic"]["head"])
    sty_att_path = str(tmp_path / "stylenet_att.pth")
    nic_att_path = str(tmp_path / "HAP_BEST_checkpoint_nic_att.pth.tar")
    torch.save(_factored_att_state_dict(params["stylenet_att"]["decoder"]),
               sty_att_path)
    _save_nic_att_full_pickle(nic_att_path, params["nic_att"]["decoder"])
    paths_by_variant = {"stylenet": sty_path, "nic": nic_path,
                        "stylenet_att": sty_att_path, "nic_att": nic_att_path}
    ckpts = {v: {m: paths_by_variant[v] for m in MODES}
             for v in MODEL_VARIANTS}
    config = dataclasses.replace(
        eng.config, checkpoint_paths=ckpts, resnet_weights=os.path.join(
            os.path.dirname(eng.config.vocab_path), "resnet.npz"))
    kw = dict(image_size=32, dec_cfg=eng.dec_cfg, enc_cfg=eng.enc_cfg,
              att_cfg=eng.att_cfg, device="cpu")
    from_ckpt = CaptionEngine(config, **kw)
    # one decoder per checkpoint file, shared by the four modes
    for variant in MODEL_VARIANTS:
        assert len({id(from_ckpt.models[variant][m]["decoder"])
                    for m in MODES}) == 1
    sty_head = from_ckpt.models["stylenet"]["happy"]["head"]
    from_params = CaptionEngine(dataclasses.replace(eng.config), params=dict(
        params, stylenet={"decoder": params["stylenet"]["decoder"],
                          "head": sty_head}), **kw)
    for p in paths:
        for m in ("factual", "sad"):
            got = from_ckpt.caption(p, m)
            assert got == from_params.caption(p, m), (p, m)
            for variant in ("nic", "nic_att", "stylenet_att"):
                assert got[variant] == want[(p, m)][variant], (p, m, variant)
    orbax = dataclasses.replace(config, checkpoint_paths=dict(
        ckpts, nic={m: str(tmp_path) for m in MODES}))
    with pytest.raises(NotImplementedError, match="orbax"):
        CaptionEngine(orbax, **kw)


def _post(url, path, mode):
    boundary = "icee-test-boundary"
    with open(path, "rb") as f:
        data = f.read()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{path.rsplit('/', 1)[-1]}\"\r\nContent-Type: "
            f"image/jpeg\r\n\r\n").encode() + data + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"{url}/generate?mode={mode}", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_http_generate_matches_jax_captions(engines):
    from icee_tpu_torch.serve.app import serve

    _, eng, paths, want, _ = engines
    config = eng.config
    config.backend_host, config.backend_port = "127.0.0.1", 0
    config.batch_window_ms = 50.0
    httpd = serve(config, engine=eng, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        out = {}

        def worker(p, m):
            out[(p, m)] = _post(url, p, m)

        threads = [threading.Thread(target=worker, args=(p, m))
                   for p in paths for m in MODES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert len(out) == len(want)
        for key, (status, body) in out.items():
            assert status == 200
            assert {v: body[v] for v in SERVED} == want[key], key
            assert body["path_img"].startswith("/images/")
        name = out[(paths[0], "happy")][1]["path_img"]
        with urllib.request.urlopen(url + name, timeout=30) as resp:
            assert resp.read() == open(paths[0], "rb").read()
        status, body = _post(url, paths[0], "nonexistent")
        assert status == 200 and set(body.values()) == {"-"}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_default_device_entry_points_raise_without_cuda():
    """Entry points default to CUDA and raise when it is absent; nothing
    falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is available")
    from icee_tpu_torch.core.device import resolve_device
    from icee_tpu_torch.serve.app import main, serve
    from icee_tpu_torch.serve.engine import CaptionEngine

    small = dict(dec_cfg=DecoderConfig(vocab_size=8, embed_size=4,
                                       hidden_size=4, factored_size=4),
                 enc_cfg=EncoderConfig(embed_size=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        CaptionEngine(ServeConfig(), smoke_mode=True, **small)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(ServeConfig(backend_port=0), smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--port", "1", "--env", "/nonexistent.env"])
    assert resolve_device("cpu").type == "cpu"


def _pooled(engine, path):
    pooled, _ = engine._features(path)
    return np.asarray(pooled, np.float32)


def test_backbone_dtype_bfloat16_matches_jax_engine(engines):
    """``backbone_dtype="bfloat16"`` casts the ResNet's convs as the JAX
    engine does (bf16 conv weights and inputs, float32 BatchNorm and
    result), and float32 stays float32.  Tolerances: each conv does the JAX
    conv's arithmetic (``test_torch_encoder.py``), but bfloat16 keeps 8
    bits of mantissa (2^-8 ~ 4e-3 relative per rounding), so an input that
    the two summation orders leave on either side of a rounding boundary
    rounds one ulp apart, and 50 blocks spread such flips: the pooled
    features agree within 2e-2 of their largest magnitude (4.8e-3 seen);
    the float32 engines within 1e-4 of it."""
    from icee_tpu.serve.config import ServeConfig as JServeConfig
    from icee_tpu.serve.engine import CaptionEngine as JCaptionEngine
    from icee_tpu_torch.serve.engine import CaptionEngine

    jeng, eng, paths, _, _ = engines
    folder = paths[0].rsplit("/", 1)[0]
    common = dict(vocab_path=f"{folder}/vocab.pkl", image_folder=folder,
                  resnet_weights=f"{folder}/resnet.npz")
    small = dict(image_size=32, enc_cfg=EncoderConfig(embed_size=8))
    tiny = dict(vocab_size=16, embed_size=8, hidden_size=8,
                factored_size=8, max_seq_length=3)
    jbf = JCaptionEngine(JServeConfig(backbone_dtype="bfloat16", **common),
                         smoke_mode=True, **small)
    bf = CaptionEngine(ServeConfig(backbone_dtype="bfloat16", **common),
                       smoke_mode=True, device="cpu",
                       dec_cfg=DecoderConfig(**tiny),
                       att_cfg=AttConfig(attention_size=8, **tiny), **small)
    conv = bf.backbone.params["layer1"][0]["conv2"]
    bn = bf.backbone.params["layer1"][0]["bn2"]["weight"]
    assert conv.dtype == torch.bfloat16 and bn.dtype == torch.float32
    got, want = _pooled(bf, paths[0]), _pooled(jbf, paths[0])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    f32_port, f32_jax = _pooled(eng, paths[0]), _pooled(jeng, paths[0])
    assert np.abs(f32_port - f32_jax).max() <= 1e-4 * np.abs(f32_jax).max()
    # bfloat16 really changed the numbers (the cast is not a no-op)
    assert np.abs(got - f32_port).max() > 1e-6 * scale
    with pytest.raises(ValueError, match="backbone_dtype"):
        CaptionEngine(ServeConfig(backbone_dtype="float16", **common),
                      smoke_mode=True, device="cpu",
                      dec_cfg=DecoderConfig(**tiny), **small)


def test_set_float32_precision_turns_tf32_off():
    """The one place the port sets float32 precision: both TF32 flags off
    (``resolve_device`` calls it for every CUDA device)."""
    from icee_tpu_torch.core.device import set_float32_precision

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        set_float32_precision()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
