"""K10 (the SentiCap switched model's whole beam search) and the switched
decode path: the port's plain search, host oracle and
``decode_split(switched=True)`` vs the JAX package's.

The JAX side runs its Pallas kernel ``mega_senticap_switched_decode`` in
interpret mode, its device beam ``make_device_beam(with_attention=True)``
(vmapped over images) and its host oracle ``beam_decode(with_attention=
True)``.  On the CPU the port's ``mega_senticap_switched_decode`` takes its
plain version, the device beam over the switched model's step at senti = +1
(the CUDA kernel is held against it on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``).  Weights are drawn with numpy: N(0, 1) with
a STOP bias, so that beams end at several lengths, and sentiment duplicates
perturbed by 0.3 N(0, 1) and a gate spread off 0.5, so that the mixture
matters.

Tolerances: scores atol 1e-5 (float32 sums of at most max_len + 1 nll
terms, each the log of a mixture computed in another order); traces atol
1e-6 (a gate, a sigmoid of a 2H-term sum); tokens and lengths exact.  Sizes
stay small (beam <= 8, V <= 64, E = H = 16, max_len <= 6) so that
interpret mode takes seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops.pallas_senticap_switched_decode import \
    mega_senticap_switched_decode as jmega
from icee_tpu.senticap.beam import beam_decode as jbeam_decode
from icee_tpu.senticap.beam import make_device_beam as jmake_device_beam
from icee_tpu.senticap.config import senticap_conf as jconf
from icee_tpu.senticap.train import make_beam_step as jmake_beam_step
from icee_tpu_torch import bridge
from icee_tpu_torch.ops import senticap_decode
from icee_tpu_torch.ops import senticap_switched_decode as ssd
from icee_tpu_torch.senticap import beam as sbeam
from icee_tpu_torch.senticap.config import senticap_conf
from icee_tpu_torch.senticap.train import make_beam_step

torch.set_num_threads(2)
E = H = 16
VIS = 24
BASE = ("wemb", "w_lstm", "w", "b", "wvm", "bmv")


def _params(seed, vocab, stop_bias=2.0):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"wemb": n(vocab, E), "w_lstm": n(E + H, 4 * H, scale=0.5),
         "w": n(H, vocab), "b": n(vocab, scale=0.5),
         "wvm": n(VIS, E, scale=0.5), "bmv": n(E, scale=0.1)}
    p["b"][0] += stop_bias
    for k in BASE:
        p[f"{k}_sw"] = p[k] + n(*p[k].shape, scale=0.3)
    p.update(att_w=n(2 * H, 1, scale=0.5), att_b=np.zeros(1, np.float32),
             wsenti=n(H, 1), wsenti2=n(H, 1))
    return p


def _conf(torch_side=True, **kw):
    make = senticap_conf if torch_side else jconf
    return make(emb_size=E, lstm_hidden_size=H, visual_size=VIS, **kw)


def _jax_device_beam(params, v, beam, max_len):
    make = jmake_beam_step(jax.tree.map(jnp.asarray, params), _conf(False),
                           switched=True)
    dec = jmake_device_beam(make(1.0), 2 * H, beam_size=beam,
                            max_len=max_len, with_attention=True)
    return tuple(np.asarray(a) for a in jax.jit(jax.vmap(dec.run))(
        jnp.asarray(v)))


def _assert_same(got, want, batch):
    got_sc, got_seq, got_len, got_att = (np.asarray(a) for a in got)
    want_sc, want_seq, want_len, want_att = (np.asarray(a) for a in want)
    for i in range(batch):
        n = int(want_len[i])
        assert int(got_len[i]) == n, f"image {i}: length"
        assert got_seq[i, :n].tolist() == want_seq[i, :n].tolist(), \
            f"image {i}: tokens"
        np.testing.assert_allclose(float(got_sc[i]), float(want_sc[i]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_att[i, :n], want_att[i, :n], rtol=0,
                                   atol=1e-6, err_msg=f"image {i}: trace")


@pytest.mark.parametrize("vocab,beam,batch,max_len,seed,stop_bias", [
    (64, 4, 6, 6, 0, 4.0),    # several images, the longest max_len
    (61, 3, 5, 5, 1, 2.0),    # a vocabulary that is not a multiple of 4
    (40, 1, 3, 4, 2, 2.0),    # a beam of one
    (48, 8, 2, 3, 3, 1.0),    # a wide beam over few images
])
def test_plain_matches_jax_kernel_and_device_beam(vocab, beam, batch,
                                                  max_len, seed, stop_bias):
    params = _params(seed, vocab, stop_bias)
    v = np.random.default_rng(seed + 100).standard_normal(
        (batch, VIS)).astype(np.float32)
    got = ssd.mega_senticap_switched_decode(
        bridge.to_torch(params), torch.tensor(v), batch, beam_size=beam,
        max_len=max_len)
    assert got[1].dtype == torch.int32 and got[1].shape == (batch,
                                                            max_len + 1)
    assert got[3].shape == (batch, max_len + 1)
    want_k = jmega(jax.tree.map(jnp.asarray, params), jnp.asarray(v), batch,
                   beam_size=beam, max_len=max_len, interpret=True)
    _assert_same(got, want_k, batch)
    _assert_same(got, _jax_device_beam(params, v, beam, max_len), batch)
    # past each length the trace stays 0, as JAX's
    for i in range(batch):
        assert not np.asarray(got[3][i, int(got[2][i]):]).any()
    # the gates spread: the trace is not one value
    assert np.ptp(np.asarray(got[3][0, :int(got[2][0])])) > 1e-3 or \
        int(got[2][0]) == 1
    if seed == 0:
        assert len(set(np.asarray(got[2]).tolist())) > 1


def test_plain_matches_jax_on_saturated_tail_ties():
    """Peaked heads drive most tokens' mixed probability below ~1e-38,
    where nll plateaus at -log2(1e-37) and ties break by token INDEX."""
    params = _params(9, 48)
    for k in ("b", "b_sw"):
        params[k][:] = -200.0
        params[k][:4] = [50.0, 49.0, 48.0, 47.0]
    v = np.random.default_rng(17).standard_normal((2, VIS)).astype(
        np.float32)
    got = ssd.mega_senticap_switched_decode(
        bridge.to_torch(params), torch.tensor(v), 2, beam_size=8, max_len=5)
    want = jmega(jax.tree.map(jnp.asarray, params), jnp.asarray(v), 2,
                 beam_size=8, max_len=5, interpret=True)
    _assert_same(got, want, 2)
    _assert_same(got, _jax_device_beam(params, v, 8, 5), 2)


def test_host_oracle_matches_jax_oracle_and_plain():
    params = _params(4, 64)
    v = np.random.default_rng(12).standard_normal((VIS,)).astype(np.float32)
    jmake = jmake_beam_step(jax.tree.map(jnp.asarray, params), _conf(False),
                            switched=True)

    def jstep(words, use_v, h, c):
        b = np.asarray(words).shape[0]
        hh = jnp.zeros((b, 2 * H)) if h is None else h
        cc = jnp.zeros((b, 2 * H)) if c is None else c
        return jmake(1.0)(jnp.asarray(words), jnp.asarray(bool(use_v)),
                          jnp.asarray(hh), jnp.asarray(cc), jnp.asarray(v))

    want_sc, want_words, want_att = jbeam_decode(
        jstep, v, beam_size=4, max_len=6, with_attention=True)
    tp = bridge.to_torch(params)
    step = make_beam_step(tp, _conf(), switched=True)(1.0)

    def tstep(words, use_v, h, c):
        w = torch.as_tensor(np.asarray(words))[None]
        zero = torch.zeros((1, w.shape[1], 2 * H))
        h = zero if h is None else torch.as_tensor(h)[None]
        c = zero if c is None else torch.as_tensor(c)[None]
        return tuple(a[0] for a in step(w, use_v, h, c,
                                        torch.tensor(v)[None]))

    got_sc, got_words, got_att = sbeam.beam_decode(
        tstep, v, beam_size=4, max_len=6, with_attention=True)
    assert got_words == want_words
    np.testing.assert_allclose(got_sc, want_sc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_att, want_att, rtol=0, atol=1e-6)
    sc, seq, length, att = ssd.mega_senticap_switched_decode_plain(
        tp, torch.tensor(v)[None], 1, beam_size=4, max_len=6)
    assert seq[0, :int(length[0])].tolist() == got_words
    np.testing.assert_allclose(float(sc[0]), got_sc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(att[0, :int(length[0])].numpy(), got_att,
                               rtol=0, atol=1e-6)


def test_descriptive_decode_is_the_base_search():
    """senti = -1 decodes EXACTLY as the base model on the background
    weights: ``decode_split`` runs K9 there (its plain version here)."""
    params = _params(5, 40)
    v = torch.tensor(np.random.default_rng(18).standard_normal(
        (3, VIS)).astype(np.float32))
    tp = bridge.to_torch(params)
    run = sbeam.make_device_beam(make_beam_step(tp, _conf(), True)(-1.0),
                                 2 * H, beam_size=4, max_len=5)
    want = run(v)
    got = senticap_decode.mega_senticap_beam_decode(
        {k: tp[k] for k in BASE}, v, 3, beam_size=4, max_len=5)
    for g, w in zip(got, want):
        assert torch.equal(g.to(w.dtype), w)


def test_decode_split_switched_matches_jax():
    """``decode_split(switched=True)`` on a tiny split: the whole-split
    searches (K10's and K9's plain versions on the CPU; the device beams
    outside the kernels' regime) and the host oracle loop, each against
    the JAX package's device-beam and host paths."""
    from icee_tpu.senticap.io import make_split as jmake_split
    from icee_tpu.senticap.train import decode_split as jdecode_split
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap.train import decode_split

    vocab = 24
    params = _params(6, vocab, stop_bias=1.0)
    words = [f"w{i}" for i in range(1, vocab)]
    w2i = {".": 0, **{w: i + 1 for i, w in enumerate(words)}}
    i2w = {i: w for w, i in w2i.items()}
    rng = np.random.default_rng(22)
    records = [{"image": f"img{i}", "tokens": list(rng.choice(words, 4))}
               for i in range(4)]
    feats = {f"img{i}": rng.standard_normal(VIS).astype(np.float32)
             for i in range(4)}
    ds = sio.make_split(records, feats, w2i, max_len=5, visual_size=VIS)
    jds = jmake_split(records, feats, w2i, max_len=5, visual_size=VIS)
    tp = bridge.to_torch(params)
    jp = jax.tree.map(jnp.asarray, params)
    for mode in ("da_sum", "da_fixed_alpha"):     # in and out of the regime
        conf = _conf(MAX_SENTENCE_LEN=5, DOMAIN_ADAPT=mode)
        jc = _conf(False, MAX_SENTENCE_LEN=5, DOMAIN_ADAPT=mode)
        for dev_mode in (True, False):
            got = decode_split(tp, conf, ds, i2w, beam_size=4,
                               device=dev_mode, torch_device="cpu")
            want = jdecode_split(jp, jc, jds, i2w, switched=True,
                                 beam_size=4, device=dev_mode, mega="off")
            assert [sorted(o) for o in got] == [
                ["attention", "descriptive", "image", "positive"]] * 4
            for g, w in zip(got, want):
                assert {k: g[k] for k in ("image", "positive",
                                          "descriptive")} == \
                    {k: w[k] for k in ("image", "positive", "descriptive")}
                np.testing.assert_allclose(g["attention"], w["attention"],
                                           rtol=0, atol=1e-6)
                assert len(g["attention"]) == len(g["positive"]) + 1
    assert any(o["positive"] != o["descriptive"] for o in got)


def test_wrapper_refuses_the_regimes_it_does_not_compute():
    tp = bridge.to_torch(_params(0, 16))
    v = torch.zeros((1, VIS))
    for conf, match in ((_conf(DOMAIN_ADAPT="da_fixed_alpha"), "DA_SUM"),
                        (_conf(SOFTMAX_OUT=False), "SOFTMAX_OUT"),
                        (_conf(BATCH_NORM=True), "BATCH_NORM")):
        with pytest.raises(ValueError, match=match):
            ssd.mega_senticap_switched_decode(tp, v, 1, beam_size=2,
                                              conf=conf)
    with pytest.raises(ValueError, match="beam_size"):
        ssd.mega_senticap_switched_decode(tp, v, 1, beam_size=17)
    with pytest.raises(ValueError, match="att_w"):
        ssd.mega_senticap_switched_decode(
            dict(tp, att_w=torch.zeros(2 * H)), v, 1, beam_size=2)
    with pytest.raises(TypeError, match="w_sw"):
        ssd.mega_senticap_switched_decode(
            dict(tp, w_sw=tp["w_sw"].double()), v, 1, beam_size=2)
