"""K9 (the SentiCap base beam search) and the decode path: the port's plain
search, host oracle and ``decode_split`` vs the JAX package's.

The JAX side runs its Pallas kernel ``mega_senticap_beam_decode`` in
interpret mode, its device beam ``make_device_beam`` (vmapped over images)
and its host oracle ``beam_decode``.  On the CPU the port's
``mega_senticap_beam_decode`` takes its plain version, the device beam over
the base model's step (the CUDA kernel is held against it on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Weights are drawn with
numpy: N(0, 1) with a STOP bias, so that beams end at several lengths.

Tolerances: scores atol 1e-5 (float32 sums of at most 21 nll terms, each a
log of a softmax computed in another order); tokens and lengths exact.
Sizes stay small (beam <= 4 or 8 for the saturated case, V <= 64, E = H =
16, max_len <= 6) so that interpret mode takes seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops.pallas_senticap_decode import \
    mega_senticap_beam_decode as jmega
from icee_tpu.senticap.beam import beam_decode as jbeam_decode
from icee_tpu.senticap.beam import make_device_beam as jmake_device_beam
from icee_tpu.senticap.config import senticap_conf as jconf
from icee_tpu.senticap.train import make_beam_step as jmake_beam_step
from icee_tpu_torch import bridge
from icee_tpu_torch.ops import senticap_decode
from icee_tpu_torch.senticap import beam as sbeam
from icee_tpu_torch.senticap.config import senticap_conf
from icee_tpu_torch.senticap.train import make_beam_step

torch.set_num_threads(2)
E = H = 16
VIS = 24


def _params(seed, vocab, stop_bias=2.0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"wemb": n(vocab, E), "w_lstm": n(E + H, 4 * H, scale=0.5),
         "w": n(H, vocab), "b": n(vocab, scale=0.5),
         "wvm": n(VIS, E, scale=0.5), "bmv": n(E, scale=0.1)}
    p["b"][0] += stop_bias
    return p


def _conf(torch_side=True, **kw):
    make = senticap_conf if torch_side else jconf
    return make(emb_size=E, lstm_hidden_size=H, visual_size=VIS, **kw)


def _jax_device_beam(params, v, beam, max_len):
    make = jmake_beam_step(jax.tree.map(jnp.asarray, params),
                           _conf(False), switched=False)
    dec = jmake_device_beam(make(0.0), H, beam_size=beam, max_len=max_len)
    sc, seq, length, _ = jax.jit(jax.vmap(dec.run))(jnp.asarray(v))
    return np.asarray(sc), np.asarray(seq), np.asarray(length)


def _assert_same(got, want, batch):
    got_sc, got_seq, got_len = (np.asarray(a) for a in got)
    want_sc, want_seq, want_len = (np.asarray(a) for a in want)
    for i in range(batch):
        n = int(want_len[i])
        assert int(got_len[i]) == n, f"image {i}: length"
        assert got_seq[i, :n].tolist() == want_seq[i, :n].tolist(), \
            f"image {i}: tokens"
        np.testing.assert_allclose(float(got_sc[i]), float(want_sc[i]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("vocab,beam,batch,max_len,seed,stop_bias", [
    (64, 4, 6, 6, 0, 5.0),    # several images, the longest max_len
    (61, 3, 5, 5, 1, 2.0),    # a vocabulary that is not a multiple of 4
    (40, 1, 3, 4, 2, 2.0),    # a beam of one
])
def test_plain_matches_jax_kernel_and_device_beam(vocab, beam, batch,
                                                  max_len, seed, stop_bias):
    params = _params(seed, vocab, stop_bias)
    v = np.random.default_rng(seed + 100).standard_normal(
        (batch, VIS)).astype(np.float32)
    got = senticap_decode.mega_senticap_beam_decode(
        bridge.to_torch(params), torch.tensor(v), batch, beam_size=beam,
        max_len=max_len)
    assert got[1].dtype == torch.int32 and got[1].shape == (batch,
                                                            max_len + 1)
    want_k = jmega(jax.tree.map(jnp.asarray, params), jnp.asarray(v), batch,
                   beam_size=beam, max_len=max_len, interpret=True)
    want_d = _jax_device_beam(params, v, beam, max_len)
    _assert_same(got, want_k, batch)
    _assert_same(got, want_d, batch)
    # the STOP bias is chosen so that beams end at several lengths
    assert len(set(np.asarray(got[2]).tolist())) > 1


def test_beam_past_one_block_matches_jax_device_beam():
    """A beam the CUDA kernel runs from device memory (300 > the row
    pass's 256 threads, beam^2 candidates past a block; V = 400): the
    CPU route answers as JAX's ``make_device_beam``."""
    params = _params(21, 400, 3.0)
    v = np.random.default_rng(121).standard_normal((2, VIS)).astype(
        np.float32)
    got = senticap_decode.mega_senticap_beam_decode(
        bridge.to_torch(params), torch.tensor(v), 2, beam_size=300,
        max_len=3)
    _assert_same(got, _jax_device_beam(params, v, 300, 3), 2)


def test_plain_matches_jax_on_saturated_tail_ties():
    """A peaked head drives most tokens' probability below ~1e-38, where
    nll plateaus at -log2(1e-37) and ties break by token INDEX, not by
    logit (``tests/test_pallas_senticap_decode.py``'s case)."""
    params = _params(9, 48)
    params["b"][:] = -200.0
    params["b"][:4] = [50.0, 49.0, 48.0, 47.0]
    v = np.random.default_rng(17).standard_normal((2, VIS)).astype(
        np.float32)
    got = senticap_decode.mega_senticap_beam_decode(
        bridge.to_torch(params), torch.tensor(v), 2, beam_size=8, max_len=5)
    want = jmega(jax.tree.map(jnp.asarray, params), jnp.asarray(v), 2,
                 beam_size=8, max_len=5, interpret=True)
    _assert_same(got, want, 2)
    _assert_same(got, _jax_device_beam(params, v, 8, 5), 2)


def test_host_oracle_matches_jax_oracle_and_plain():
    params = _params(3, 64)
    v = np.random.default_rng(11).standard_normal((VIS,)).astype(np.float32)
    jmake = jmake_beam_step(jax.tree.map(jnp.asarray, params), _conf(False),
                            switched=False)

    def jstep(words, use_v, h, c):
        b = np.asarray(words).shape[0]
        hh = jnp.zeros((b, H)) if h is None else h
        cc = jnp.zeros((b, H)) if c is None else c
        return jmake(0.0)(jnp.asarray(words), jnp.asarray(bool(use_v)),
                          jnp.asarray(hh), jnp.asarray(cc), jnp.asarray(v))

    want_sc, want_words = jbeam_decode(jstep, v, beam_size=4, max_len=6)
    tp = bridge.to_torch(params)
    step = make_beam_step(tp, _conf())(0.0)

    def tstep(words, use_v, h, c):
        w = torch.as_tensor(np.asarray(words))[None]
        zero = torch.zeros((1, w.shape[1], H))
        h = zero if h is None else torch.as_tensor(h)[None]
        c = zero if c is None else torch.as_tensor(c)[None]
        s, h2, c2 = step(w, use_v, h, c, torch.tensor(v)[None])
        return s[0], h2[0], c2[0]

    got_sc, got_words = sbeam.beam_decode(tstep, v, beam_size=4, max_len=6)
    assert got_words == want_words
    np.testing.assert_allclose(got_sc, want_sc, rtol=0, atol=1e-5)
    sc, seq, length = senticap_decode.mega_senticap_beam_decode_plain(
        tp, torch.tensor(v)[None], 1, beam_size=4, max_len=6)
    assert seq[0, :int(length[0])].tolist() == got_words
    np.testing.assert_allclose(float(sc[0]), got_sc, rtol=0, atol=1e-5)


def test_decode_split_matches_jax():
    """``decode_split(switched=False)`` on a tiny split: the whole-split
    search (K9's plain version on the CPU) and the host oracle loop, each
    against the JAX package's device-beam and host paths."""
    from icee_tpu.senticap.io import make_split as jmake_split
    from icee_tpu.senticap.train import decode_split as jdecode_split
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap.train import decode_split

    vocab = 24
    params = _params(5, vocab, stop_bias=1.0)
    words = [f"w{i}" for i in range(1, vocab)]
    w2i = {".": 0, **{w: i + 1 for i, w in enumerate(words)}}
    i2w = {i: w for w, i in w2i.items()}
    rng = np.random.default_rng(21)
    records = [{"image": f"img{i}", "tokens": list(rng.choice(words, 4))}
               for i in range(4)]
    feats = {f"img{i}": rng.standard_normal(VIS).astype(np.float32)
             for i in range(4)}
    conf = _conf(MAX_SENTENCE_LEN=5)
    ds = sio.make_split(records, feats, w2i, max_len=5, visual_size=VIS)
    jds = jmake_split(records, feats, w2i, max_len=5, visual_size=VIS)
    tp = bridge.to_torch(params)
    jp = jax.tree.map(jnp.asarray, params)
    jc = _conf(False, MAX_SENTENCE_LEN=5)
    for dev_mode in (True, False):
        got = decode_split(tp, conf, ds, i2w, switched=False, beam_size=4,
                           device=dev_mode, torch_device="cpu")
        want = jdecode_split(jp, jc, jds, i2w, switched=False, beam_size=4,
                             device=dev_mode, mega="off")
        assert got == want, dev_mode
    assert len({len(o["caption"]) for o in got}) > 1
    # the default decodes the switched model, as JAX's decode_split does:
    # base weights lack its *_sw set
    with pytest.raises(KeyError, match="_sw"):
        decode_split(tp, conf, ds, i2w, torch_device="cpu")


def test_wrapper_refuses_the_regimes_it_does_not_compute():
    tp = bridge.to_torch(_params(0, 16))
    v = torch.zeros((1, VIS))
    with pytest.raises(ValueError, match="BATCH_NORM"):
        senticap_decode.mega_senticap_beam_decode(
            dict(tp, gamma_h=torch.ones(E + H)), v, 1, beam_size=2)
    with pytest.raises(ValueError, match="SOFTMAX_OUT"):
        senticap_decode.mega_senticap_beam_decode(
            tp, v, 1, beam_size=2, conf=_conf(SOFTMAX_OUT=False))
    with pytest.raises(ValueError, match="beam_size"):
        senticap_decode.mega_senticap_beam_decode(tp, v, 1, beam_size=17)
