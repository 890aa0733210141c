"""The port's native host data path (``icee_tpu_torch/native``) against its
NumPy and PIL fallbacks and the JAX package's ``RaggedCaptions``: the C++
batcher and token histogram equal NumPy's, and the JAX package's, exactly;
the libjpeg decoder matches PIL within JPEG IDCT rounding (±1) at the same
size, stays within a mean deviation of 4 levels of PIL's antialiased resize
on smooth content, turns an undecodable JPEG black, and its PIL fallback
keeps the shape and dtype.  The C++ tests skip only where the build fails
here: no ``g++``, or no ``jpeglib.h`` / ``-ljpeg`` for the decoder.
"""

import io
import shutil

import numpy as np
import pytest
from PIL import Image

from icee_tpu.native import RaggedCaptions as JRaggedCaptions
from icee_tpu_torch.native import RaggedCaptions, imagedec, native_available


@pytest.fixture
def batcher():
    """Skips where the C++ batcher does not build (decided when a test
    runs, never while the module is imported)."""
    if shutil.which("g++") is None or not native_available():
        pytest.skip("the C++ batcher did not build: no g++ on this host")


@pytest.fixture
def decoder():
    """Skips where the C++ JPEG decoder does not build."""
    if shutil.which("g++") is None or not imagedec.native_available():
        pytest.skip("the C++ JPEG decoder did not build: no g++, or no "
                    "jpeglib.h / libjpeg on this host")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    caps = [list(rng.integers(1, 50, rng.integers(2, 15)))
            for _ in range(200)]
    return caps, RaggedCaptions(caps)


def test_ragged_layout_matches_jax(corpus):
    caps, rag = corpus
    jrag = JRaggedCaptions(caps)
    assert len(rag) == 200
    np.testing.assert_array_equal(rag.data, jrag.data)
    np.testing.assert_array_equal(rag.offsets, jrag.offsets)
    np.testing.assert_array_equal(rag.data[rag.offsets[3]:rag.offsets[4]],
                                  caps[3])


@pytest.mark.parametrize("n_threads", [1, 4])
def test_batch_matches_numpy_and_jax(batcher, corpus, n_threads):
    caps, rag = corpus
    idx = np.random.default_rng(1).permutation(200)[:64]
    c_nat, l_nat = rag.batch(idx, max_len=12, pad_id=0, n_threads=n_threads)
    c_np, l_np = rag.batch(idx, max_len=12, pad_id=0, force_numpy=True)
    c_jax, l_jax = JRaggedCaptions(caps).batch(idx, max_len=12, pad_id=0)
    for got in ((c_nat, l_nat), (c_np, l_np)):
        np.testing.assert_array_equal(got[0], c_jax)
        np.testing.assert_array_equal(got[1], l_jax)
    assert l_nat.max() <= 12      # cut at max_len


def test_token_counts_match_numpy_and_jax(batcher, corpus):
    caps, rag = corpus
    got = rag.token_counts(50, n_threads=4)
    np.testing.assert_array_equal(got, rag.token_counts(50, force_numpy=True))
    np.testing.assert_array_equal(got, JRaggedCaptions(caps).token_counts(50))
    assert got.sum() == rag.data.size


def test_large_batch_multithreaded(batcher):
    rng = np.random.default_rng(2)
    caps = [list(rng.integers(0, 1000, rng.integers(1, 40)))
            for _ in range(5000)]
    rag = RaggedCaptions(caps)
    idx = rng.permutation(5000)
    c_nat, l_nat = rag.batch(idx, max_len=42, n_threads=8)
    c_np, l_np = rag.batch(idx, max_len=42, force_numpy=True)
    np.testing.assert_array_equal(c_nat, c_np)
    np.testing.assert_array_equal(l_nat, l_np)


def _jpeg_bytes(rng, w, h, quality=92):
    arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_imagedec_matches_pil_decode(decoder, rng):
    """Same-size decode (no resample): within JPEG IDCT rounding (±1) of
    PIL's decode of the same bytes."""
    jpegs = [_jpeg_bytes(rng, 48, 48), _jpeg_bytes(rng, 48, 48, quality=70)]
    out = imagedec.decode_resize_batch(jpegs, 48)
    for i, j in enumerate(jpegs):
        ref = np.asarray(Image.open(io.BytesIO(j)).convert("RGB"))
        diff = np.abs(out[i].astype(int) - ref.astype(int))
        assert diff.max() <= 1, f"img {i}: max IDCT deviation {diff.max()}"


def test_imagedec_resize_close_to_pil(decoder):
    """A resized decode stays within a mean of 4 levels of the PIL
    bilinear path on a smooth gradient (the filters differ)."""
    y, x = np.mgrid[0:64, 0:64]
    arr = np.stack([x * 4, y * 4, (x + y) * 2], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=95)
    jpeg = buf.getvalue()
    out = imagedec.decode_resize_batch([jpeg], 32)[0]
    pil = imagedec.decode_resize_batch([jpeg], 32, force_pil=True)[0]
    assert out.shape == pil.shape == (32, 32, 3)
    assert np.abs(out.astype(float) - pil.astype(float)).mean() < 4.0


@pytest.mark.parametrize("force_pil", [False, True])
def test_bad_jpeg_is_black_and_the_batch_survives(request, rng, force_pil):
    if not force_pil:
        request.getfixturevalue("decoder")
    good = _jpeg_bytes(rng, 24, 24)
    out = imagedec.decode_resize_batch([good, b"not a jpeg"], 24,
                                       n_threads=2, force_pil=force_pil)
    assert out.shape == (2, 24, 24, 3)
    assert out[1].max() == 0          # failed decode -> black
    assert out[0].max() > 0


def test_paths_and_pil_fallback(rng, tmp_path):
    from icee_tpu_torch.data.transforms import host_decode_resize

    p = tmp_path / "a.jpg"
    p.write_bytes(_jpeg_bytes(rng, 20, 28))
    out = imagedec.decode_resize_paths([str(p)], 16)
    assert out.shape == (1, 16, 16, 3) and out.dtype == np.uint8
    pil = imagedec.decode_resize_batch([p.read_bytes()], 16, force_pil=True)
    assert pil.shape == (1, 16, 16, 3) and pil.dtype == np.uint8
    np.testing.assert_array_equal(pil[0], host_decode_resize(str(p), 16))


def test_build_is_atomic_and_failure_is_remembered(tmp_path, monkeypatch):
    """A library that does not build gives None (the fallback), and is not
    rebuilt on every call; the build directory keeps no temporary file."""
    import icee_tpu_torch.native as native

    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.delitem(native._libs, "broken", raising=False)
    try:
        assert native.build_library("broken", {}) is None
        assert "broken" in native._libs
        assert native.build_library("broken", {}) is None
        leftovers = (list((tmp_path / "_build").iterdir())
                     if (tmp_path / "_build").exists() else [])
        assert leftovers == []
    finally:
        native._libs.pop("broken", None)
