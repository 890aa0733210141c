"""The serving slice as a whole: the port's CaptionEngine (fused-step path),
BatchingEngine (mega path) and HTTP ``POST /generate`` against the JAX
engines' ``stylenet`` captions, with the JAX engine's weights bridged across
and the tiny configs of ``tests/test_serve_batching.py``.  Captions must be
identical."""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from icee_tpu_torch import bridge
from icee_tpu_torch.core.config import DecoderConfig, EncoderConfig
from icee_tpu_torch.serve.config import MODEL_VARIANTS, ServeConfig

torch.set_num_threads(2)
MODES = ("factual", "happy", "sad", "angry")


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
    jeng = JCaptionEngine(
        JServeConfig(vocab_path=str(tmp / "vocab.pkl"),
                     image_folder=str(tmp),
                     resnet_weights=str(tmp / "resnet.npz")),
        smoke_mode=True, image_size=32, dec_cfg=JDecoderConfig(**dims),
        att_cfg=AttentionDecoderConfig(attention_size=8, **dims),
        enc_cfg=JEncoderConfig(embed_size=8))
    # Weights that caption: the smoke init gives every image the bare
    # [<end>] fallback (its head logits barely move).  N(0, 1) decoder
    # weights, a stronger encoder head and the damped backbone above give
    # captions of one to five words.  Set before the JAX engine's first call,
    # which captures them.
    wrng = np.random.default_rng(8)
    dec = {name: wrng.standard_normal(a.shape).astype(np.float32)
           for name, a in jeng.models["stylenet"]["happy"]["decoder"].items()}
    dec["C_b"][vocab.end] = -1.0
    head = jax.tree.map(np.asarray, jeng.models["stylenet"]["happy"]["head"])
    head["linear_w"] = head["linear_w"] * np.float32(30.0)
    head["linear_b"] = head["linear_b"] * np.float32(30.0)
    pipeline = jax.tree.map(jax.numpy.asarray,
                            {"decoder": dec, "head": head})
    # only stylenet is compared: the JAX engine answers "-" for the other
    # variants, as the port does, instead of compiling their beams
    jeng.models = {"stylenet": {}}
    for mode in MODES:   # one shared pipeline: the engine compiles it once
        jeng.models["stylenet"][mode] = pipeline
    backbone = jax.tree.map(np.asarray, jeng.backbone)
    params = bridge.to_torch({"backbone": backbone, "decoder": dec,
                              "head": head})
    eng = CaptionEngine(
        ServeConfig(vocab_path=str(tmp / "vocab.pkl"),
                    image_folder=str(tmp / "uploads")),
        image_size=32, dec_cfg=DecoderConfig(**dims),
        enc_cfg=EncoderConfig(embed_size=8), device="cpu", params=params)
    want = {(p, m): jeng.caption(p, m)["stylenet"]
            for p in paths for m in MODES}
    return jeng, eng, paths, want


def test_serial_engine_matches_jax_captions(engines):
    _, eng, paths, want = engines
    for (p, m), caption in want.items():
        got = eng.caption(p, m)
        assert got["stylenet"] == caption, (p, m)
        assert all(got[v] == "-" for v in MODEL_VARIANTS if v != "stylenet")
    lengths = {len(c.split()) for c in want.values()}
    assert len(lengths) > 1, "captions of one length prove little"


def test_batching_engine_matches_jax_batching(engines):
    from icee_tpu.serve.batching import BatchingEngine as JBatchingEngine
    from icee_tpu_torch.serve.batching import BatchingEngine

    jeng, eng, paths, want = engines
    requests = [(p, m) for p in paths for m in ("happy", "sad")]
    for engine_cls, inner in ((BatchingEngine, eng), (JBatchingEngine, jeng)):
        batched = engine_cls(inner, window_ms=500.0, max_batch=8)
        results, errors = {}, []

        def worker(p, m):
            try:
                results[(p, m)] = batched.caption(p, m)["stylenet"]
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

    _, eng, paths, want = engines
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
            assert body["stylenet"] == want[key], key
            assert body["nic"] == "-" and body["path_img"].startswith(
                "/images/")
        name = out[(paths[0], "happy")][1]["path_img"]
        with urllib.request.urlopen(url + name, timeout=30) as resp:
            assert resp.read() == open(paths[0], "rb").read()
        status, body = _post(url, paths[0], "nonexistent")
        assert status == 200 and body["stylenet"] == "-"
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
