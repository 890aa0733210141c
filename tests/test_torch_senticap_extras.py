"""The SentiCap extras in the port against the JAX package's, on the CPU:
``senticap/sentiment.py`` (every function, both lexicon formats, both
detector-score formats: exactly, as it is NumPy and pickle in both),
``senticap/eval_out.py`` (the files byte for byte, ``score_decodes``
equal), ``senticap/adversarial.py`` (``forward``, both adversarial losses
and ``total_loss``, values and grads; ``grad_reverse``'s gradient is minus
the identity) and ``senticap/encode_decode.py`` (``encode``, ``forward``,
``loss`` and grads), at a tiny width with JAX's parameters moved across
with :mod:`icee_tpu_torch.bridge`.

Tolerances: float32 on both sides, sums in other orders.  Hidden states
and probabilities atol 1e-6; the losses, masked sums of ~30 terms, rtol
1e-5; gradients atol 1e-5.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.senticap import adversarial as jadv
from icee_tpu.senticap import encode_decode as jed
from icee_tpu.senticap import eval_out as jeval
from icee_tpu.senticap import sentiment as jsent
from icee_tpu_torch import bridge
from icee_tpu_torch.senticap import adversarial as adv
from icee_tpu_torch.senticap import encode_decode as ed
from icee_tpu_torch.senticap import eval_out
from icee_tpu_torch.senticap import sentiment as sent

V, E, H, VIS, B, T, SL = 30, 12, 10, 14, 5, 6, 4


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- sentiment.py ---------------------------------------------------------

def _lexicons(tmp_path):
    """The same lexicon as a TSV and as the reference's pickle."""
    tsv = tmp_path / "lex.tsv"
    tsv.write_text("dog\thappy\t0.8\ndog\tangry\t-0.6\ncat\tcute\t0.5\n"
                   "bad line\ncat\tugly\t-0.9\n")
    pik = tmp_path / "lex.pik"
    pik.write_bytes(pickle.dumps({"dog": [("happy", 0.8), ("angry", -0.6)],
                                  "cat": [("cute", 0.5), ("ugly", -0.9)]}))
    return str(tsv), str(pik)


def _detector_files(tmp_path):
    blob = {"anp_pred": np.array([[0.5, 0.2, 0.9, 0.4], [0.1, 0.7, 0.3, 0.6]]),
            "anp_to_id": {"happy_dog": 0, "angry_dog": 1, "cute_cat": 2,
                          "_dog": 3}}
    pkl = tmp_path / "anp.pkl"
    pkl.write_bytes(pickle.dumps(blob))
    npz = tmp_path / "anp.npz"
    np.savez(npz, anp_pred=blob["anp_pred"],
             anp_to_id=np.array(blob["anp_to_id"], dtype=object))
    plain = tmp_path / "plain.pkl"
    plain.write_bytes(pickle.dumps({"img0": {"happy_dog": 0.25}}))
    return str(pkl), str(npz), str(plain)


def _same(got, want):
    """Equal values, recursing through lists, tuples and dicts; arrays by
    their bits."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        if want.size and want.dtype != object and got.dtype == want.dtype:
            assert np.array_equal(got, want)
        return
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got == want and type(got) is type(want)


def test_sentiment_functions_match_jax(tmp_path):
    """Every function of ``sentiment.py`` over both lexicon formats and the
    three detector-score formats: the same values (bit for bit), types and
    orders as the JAX package's."""
    for goal, s in ((1.0, 0.8), (-1.0, 0.3), (0.0, -0.9)):
        _same(sent.reward(goal, s), jsent.reward(goal, s))
    pairs = {"happy_dog": 0.8, "angry_dog": -0.6}
    _same(sent.get_anp_reward(1.0, pairs), jsent.get_anp_reward(1.0, pairs))
    _same(sent.get_anp_reward(-1.0, list(pairs.items())),
          jsent.get_anp_reward(-1.0, list(pairs.items())))
    pkl, npz, plain = _detector_files(tmp_path)
    w2i = {"dog": 0, "cat": 1, "tree": 2}
    noun_pd = np.array([0.6, 0.3, 0.1])
    for lex in _lexicons(tmp_path):
        s, js = sent.SentiScores(lex), jsent.SentiScores(lex)
        _same(s.by_noun, js.by_noun)
        for noun in ("dog", "cat", "tree"):
            _same(s.adjectives_for(noun), js.adjectives_for(noun))
            for adj in ("happy", "ugly", "none"):
                _same(s.sentiment_of(adj, noun), js.sentiment_of(adj, noun))
            for goal in (None, 1.0, -1.0):
                got = s.get_anp_score_from_noun(noun, goal)
                want = js.get_anp_score_from_noun(noun, goal)
                _same(got[0], want[0])
                if want[0]:
                    _same(got[1], want[1])
        for goal in (None, 1.0, -1.0):
            _same(s.get_anp_to_score(["dog", "cat", "tree"], goal),
                  js.get_anp_to_score(["dog", "cat", "tree"], goal))
        # cached per goal; the lexicon is never mutated
        assert s.get_anp_to_score(["dog"], 1.0) is s.cache[1.0]
        _same(s.by_noun, js.by_noun)
        for path in (pkl, npz, plain, None):
            v, jv = sent.ANPVisualScores(path), jsent.ANPVisualScores(path)
            for img in (0, 1, "img0"):
                for anp in ("happy_dog", "cute_cat", "sad_tree"):
                    if path in (pkl, npz) and isinstance(img, str):
                        continue
                    _same(v.get_score(img, anp), jv.get_score(img, anp))
                    _same(v.score(img, anp), jv.score(img, anp))
            if path in (pkl, npz):
                for goal in (1.0, -1.0):
                    for noun in ("dog", "cat", "tree"):
                        for k in (-1, 3):
                            _same(sent.anp_joint_score(goal, noun, 1, s, v,
                                                       k),
                                  jsent.anp_joint_score(goal, noun, 1, js,
                                                        jv, k))
            for c in ((0.0, 1.0, 1.0, 1.0), (1.0, 0.5, 2.0, 2.0)):
                if c[0] and path not in (pkl, npz):
                    continue
                for every in (False, True):
                    _same(sent.anp_joint_score_prob(1.0, w2i, noun_pd, 0, s,
                                                    v, c, every),
                          jsent.anp_joint_score_prob(1.0, w2i, noun_pd, 0,
                                                     js, jv, c, every))
        toks = ["a", "happy", "dog", "near", "cute", "cat", "ugly", "cat"]
        _same(sent.switch_targets(toks, s), jsent.switch_targets(toks, js))


# --- eval_out.py ----------------------------------------------------------

DECODES = [
    {"image": "i1", "positive": ["a", "happy", "dog"],
     "descriptive": ["a", "dog"], "attention": [0.1, 0.9, 0.2]},
    {"image": "i2", "positive": ["sad", "cat"],
     "descriptive": ["cat"], "attention": [0.8, 0.1]},
    {"image": "i3", "caption": ["a", "tree"]},
]
REFS = {"i1": [["a", "happy", "dog"], ["a", "dog", "runs"]],
        "i2": [["a", "sad", "cat"]], "i3": [["a", "tall", "tree"]]}


def test_eval_files_and_scores_match_jax(tmp_path):
    """``write_eval_outputs``' files byte for byte (``output_pos``,
    ``output_des``, ``reference%d`` over ragged reference counts,
    ``highlight.html``), ``switch_highlight_html`` and ``score_decodes``
    (both keys) equal to JAX's."""
    got, want = tmp_path / "port", tmp_path / "jax"
    eval_out.write_eval_outputs(DECODES, REFS, str(got))
    jeval.write_eval_outputs(DECODES, REFS, str(want))
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    assert names == ["highlight.html", "output_des", "output_pos",
                     "reference0", "reference1"]
    for n in names:
        assert (got / n).read_bytes() == (want / n).read_bytes(), n
    assert eval_out.switch_highlight_html(["x", "y"], [0.7], 0.6) == \
        jeval.switch_highlight_html(["x", "y"], [0.7], 0.6)
    for key in ("positive", "descriptive"):
        assert eval_out.score_decodes(DECODES, REFS, key) == \
            jeval.score_decodes(DECODES, REFS, key)


# --- adversarial.py -------------------------------------------------------

def _batch(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(1, V, (B, T)).astype(np.int32)
    words[:, 0] = 0
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    lengths = rng.integers(2, T + 1, (B,))
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    v = rng.standard_normal((B, VIS)).astype(np.float32)
    return words, y, mask, v


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_close(got: dict, want: dict, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   err_msg=k)


def test_grad_reverse_negates_and_grad_ignore_stops():
    x = torch.randn(3, 4, requires_grad=True)
    g = torch.randn(3, 4)
    y = adv.grad_reverse(x)
    assert torch.equal(y, x)
    (got,) = torch.autograd.grad(y, x, g)
    assert torch.equal(got, -g)
    assert not adv.grad_ignore(x).requires_grad
    jg = jax.grad(lambda a: jnp.sum(jadv.grad_reverse(a) * g.numpy()))(
        jnp.asarray(x.detach().numpy()))
    assert np.array_equal(np.asarray(jg), got.numpy())


@pytest.mark.parametrize("loss", ["MSQ_LOSS", "BATCH_IMAGE_LOSS", "none"])
def test_adversarial_matches_jax(loss):
    """``visual_style_embedding``, ``forward``, ``adversarial_loss`` (the
    term and the style-guess accuracy) and ``total_loss`` with its grads
    for every parameter, for both adversarial losses and neither."""
    kw = dict(emb_size=E, lstm_hidden_size=H, visual_size=VIS,
              style_len=SL, MSQ_LOSS=loss == "MSQ_LOSS",
              BATCH_IMAGE_LOSS=loss == "BATCH_IMAGE_LOSS")
    jconf, conf = jadv.adv_conf(**kw), adv.adv_conf(**kw)
    assert conf == jconf
    p = _np_tree(jadv.init_params(jax.random.PRNGKey(3), V, jconf))
    port_init = adv.init_params(torch.Generator().manual_seed(3), V, conf)
    assert {k: v.shape for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in port_init.items()}
    tp = bridge.to_torch(p)
    words, y, mask, v = _batch(7)
    idx = np.array([0, 1, 1, 0, 1], np.int32)
    targs = [torch.tensor(a) for a in (words, y, mask, v, idx)]
    np.testing.assert_allclose(
        adv.visual_style_embedding(tp, targs[3], targs[4]).numpy(),
        np.asarray(jadv.visual_style_embedding(p, v, idx)), atol=1e-6)
    np.testing.assert_allclose(
        adv.forward(tp, conf, targs[0], targs[3], targs[4]).numpy(),
        np.asarray(jadv.forward(p, jconf, words, v, idx)), atol=1e-6)
    term, acc = adv.adversarial_loss(tp, conf, targs[3], targs[4])
    jterm, jacc = jadv.adversarial_loss(p, jconf, v, idx)
    np.testing.assert_allclose(float(term), float(jterm), rtol=1e-5)
    assert float(acc) == pytest.approx(float(jacc), abs=1e-7)
    jl, jg = jax.value_and_grad(jadv.total_loss)(p, jconf, words, y, mask, v,
                                                 idx)
    tp = {k: t.requires_grad_(True) for k, t in tp.items()}
    total = adv.total_loss(tp, conf, *targs)
    got = dict(zip(tp, torch.autograd.grad(total, list(tp.values()),
                                           allow_unused=True)))
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    _grads_close({k: np.zeros_like(p[k]) if g is None else g.numpy()
                  for k, g in got.items()}, jg)
    if loss == "MSQ_LOSS":
        # the style table's gradient through the regressor is reversed,
        # and wvm gets none from it (grad_ignore)
        term_only = jax.grad(lambda q: jadv.adversarial_loss(
            q, jconf, v, idx)[0])(p)
        assert np.asarray(term_only["wvm"]).any() == False  # noqa: E712
        assert np.asarray(term_only["style"]).any()


# --- encode_decode.py -----------------------------------------------------

def test_encode_decode_matches_jax():
    """``encode`` (the encoder's last hidden state), ``forward`` (the
    decoder's distributions conditioned on [h ; v]), ``loss`` and its
    grads for every parameter of both halves; ``init_params``' shapes."""
    kw = dict(emb_size=E, lstm_hidden_size=H, visual_size=VIS)
    jconf, conf = jed.encdec_conf(**kw), ed.encdec_conf(**kw)
    assert conf == jconf
    p = _np_tree(jed.init_params(jax.random.PRNGKey(4), V, jconf))
    port_init = ed.init_params(torch.Generator().manual_seed(4), V, conf)
    assert jax.tree.map(np.shape, p) == jax.tree.map(
        np.shape, bridge.to_numpy(port_init))
    assert port_init["decoder"]["wvm"].shape == (H + VIS, E)
    tp = bridge.to_torch(p)
    words, y, mask, v = _batch(8)
    enc_words = _batch(9)[0]
    targs = [torch.tensor(a) for a in (words, y, mask, enc_words, v)]
    np.testing.assert_allclose(
        ed.encode(tp, conf, targs[3], targs[4]).numpy(),
        np.asarray(jed.encode(p, jconf, enc_words, v)), atol=1e-6)
    np.testing.assert_allclose(
        ed.forward(tp, conf, targs[0], targs[3], targs[4]).numpy(),
        np.asarray(jed.forward(p, jconf, words, enc_words, v)), atol=1e-6)
    jl, jg = jax.value_and_grad(jed.loss)(p, jconf, words, y, mask,
                                          enc_words, v)
    flat = [(half, k) for half in tp for k in tp[half]]
    for half, k in flat:
        tp[half][k].requires_grad_(True)
    total = ed.loss(tp, conf, *targs)
    got = torch.autograd.grad(total, [tp[h][k] for h, k in flat],
                              allow_unused=True)
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    for (half, k), g in zip(flat, got):
        # the encoder's softmax head is unused: None here, zeros in JAX
        g = np.zeros_like(p[half][k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(jg[half][k]), atol=1e-5,
                                   err_msg=f"{half}.{k}")


def test_bridge_carries_the_variant_trees_both_ways():
    """The adversarial (flat, with the style tables) and encoder-decoder
    (two nested halves) trees survive to_torch -> to_numpy bit for bit."""
    trees = (jadv.init_params(jax.random.PRNGKey(1), V, jadv.adv_conf(
        emb_size=E, lstm_hidden_size=H, visual_size=VIS, style_len=SL)),
        jed.init_params(jax.random.PRNGKey(2), V, jed.encdec_conf(
            emb_size=E, lstm_hidden_size=H, visual_size=VIS)))
    for tree in trees:
        tree = _np_tree(tree)
        back = bridge.to_numpy(bridge.to_torch(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
