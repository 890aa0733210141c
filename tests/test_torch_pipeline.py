"""The port's host data path and caption metrics against the JAX package's:
``native.RaggedCaptions`` (the JAX side's NumPy path), ``data/captions.py``,
both loaders of ``data/pipeline.py`` (every field of every batch over two
shuffled epochs, the padded last batch, the prefetch thread and its
exceptions), ``evaluation/bleu.py`` and ``evaluation/coco_metrics.py`` on
random corpora.  Everything here is host code on both sides, so the
results must be equal, not close."""

import numpy as np
import pytest

from icee_tpu.data import captions as jcap
from icee_tpu.data import pipeline as jpipe
from icee_tpu.data.vocab import build_vocab as jbuild_vocab
from icee_tpu.evaluation import bleu as jbleu
from icee_tpu.evaluation import coco_metrics as jcoco
from icee_tpu.native import RaggedCaptions as JRagged
from icee_tpu_torch.data import captions as cap
from icee_tpu_torch.data import pipeline as pipe
from icee_tpu_torch.data.vocab import build_vocab
from icee_tpu_torch.evaluation import bleu, coco_metrics
from icee_tpu_torch.native import RaggedCaptions

TRAIN = "examples/data/train.txt"
HAPPY = "examples/data/happy.txt"


def _corpus(seed, n=37, vocab=50):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, rng.integers(0, 15)))
            for _ in range(n)]


@pytest.mark.parametrize("seed,max_len,pad", [(0, 12, 0), (1, 5, 3),
                                              (2, 20, 0)])
def test_ragged_captions_match_jax_numpy_path(seed, max_len, pad):
    caps = _corpus(seed)
    rag, jrag = RaggedCaptions(caps), JRagged(caps)
    np.testing.assert_array_equal(rag.data, jrag.data)
    np.testing.assert_array_equal(rag.offsets, jrag.offsets)
    assert len(rag) == len(jrag) == len(caps)
    idx = np.random.default_rng(seed + 9).permutation(len(caps))[:17]
    got = rag.batch(idx, max_len=max_len, pad_id=pad)
    want = jrag.batch(idx, max_len=max_len, pad_id=pad, force_numpy=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for v in (10, 50, 60):
        np.testing.assert_array_equal(
            rag.token_counts(v), jrag.token_counts(v, force_numpy=True))


def _vocabs():
    vocab, jvocab = build_vocab(TRAIN, 1), jbuild_vocab(TRAIN, 1)
    assert vocab.word2idx == jvocab.word2idx
    return vocab, jvocab


@pytest.mark.parametrize("path", [TRAIN, HAPPY])
def test_captions_match_jax(path, tmp_path):
    vocab, jvocab = _vocabs()
    assert cap.parse_caption_file(path) == jcap.parse_caption_file(path)
    assert cap.image_caption_map(path) == jcap.image_caption_map(path)
    got = cap.load_caption_dataset(path, vocab)
    want = jcap.load_caption_dataset(path, jvocab)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    styled = tmp_path / "styled.txt"
    styled.write_text("\n".join(t for _, t in cap.parse_caption_file(path)))
    assert (cap.load_styled_caption_dataset(str(styled), vocab)
            == jcap.load_styled_caption_dataset(str(styled), jvocab))
    got = cap.load_paired_style_dataset(TRAIN, path, vocab)
    want = jcap.load_paired_style_dataset(TRAIN, path, jvocab)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert cap.encode_caption("Anak Bermain.", vocab) == \
        jcap.encode_caption("Anak Bermain.", jvocab)


def _provider(name):
    seed = sum(map(ord, name))
    return np.random.default_rng(seed).standard_normal((6,)).astype(
        np.float32)


def _assert_batches_equal(got, want):
    for g, w in zip(got, want):
        for field in ("images", "captions", "lengths", "sample_mask",
                      "references"):
            a, b = getattr(g, field), getattr(w, field)
            if a is None or b is None:
                assert a is None and b is None, field
            elif field == "references":
                assert a == b
            else:
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
    assert len(got) == len(want)


@pytest.mark.parametrize("kind,batch,prefetch", [
    ("captions", 5, 0), ("captions", 4, 2), ("styled", 3, 0),
    ("styled", 16, 2)])
def test_loaders_match_jax_over_two_shuffled_epochs(kind, batch, prefetch):
    vocab, jvocab = _vocabs()
    if kind == "captions":
        ds = cap.load_caption_dataset(TRAIN, vocab)
        jds = jcap.load_caption_dataset(TRAIN, jvocab)
        loader = pipe.caption_dataset_loader(ds, batch, 9, _provider,
                                             seed=3, prefetch=prefetch)
        jloader = jpipe.caption_dataset_loader(jds, batch, 9, _provider,
                                               seed=3, prefetch=prefetch)
    else:
        ids = [e.caption_ids for e in cap.load_caption_dataset(TRAIN, vocab)]
        loader = pipe.styled_caption_loader(ids, batch, 7, seed=5,
                                            prefetch=prefetch)
        jloader = jpipe.styled_caption_loader(ids, batch, 7, seed=5,
                                              prefetch=prefetch)
    assert len(loader) == len(jloader) == -(-16 // batch)
    for _ in range(2):
        got, want = list(loader), list(jloader)
        _assert_batches_equal(got, want)
        last = got[-1]
        n = 16 - batch * (len(got) - 1)
        assert last.batch_size == batch
        assert last.sample_mask.sum() == n
        assert (last.lengths[n:] == 0).all() and (last.captions[n:] == 0).all()
        if last.images is not None:
            assert (last.images[n:] == 0).all()


@pytest.mark.parametrize("n,batch", [(3, 5), (5, 5)])
def test_make_batch_and_pad_captions_match_jax(n, batch):
    caps = _corpus(n, n=n)
    imgs = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    got = pipe.make_batch(caps, 6, batch, images=imgs, pad_id=1)
    want = jpipe.make_batch(caps, 6, batch, images=imgs, pad_id=1)
    _assert_batches_equal([got], [want])
    for g, w in zip(pipe.pad_captions(caps, 4), jpipe.pad_captions(caps, 4)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        pipe.make_batch(caps, 6, n - 1)


def test_prefetch_thread_exception_reaches_the_consumer():
    def example_fn(idx):
        if idx[0] >= 4:
            raise KeyError("missing image")
        return pipe.make_batch([[1, 2]] * len(idx), 4, 2)

    loader = pipe.BatchLoader(8, 2, example_fn, shuffle=False, prefetch=2)
    seen = []
    with pytest.raises(KeyError, match="missing image"):
        for b in loader:
            seen.append(b)
    assert len(seen) == 2


def _random_refs_hyps(seed, n=25, vocab=12):
    rng = np.random.default_rng(seed)
    refs = [[list(rng.integers(0, vocab, rng.integers(1, 12)))
             for _ in range(rng.integers(1, 5))] for _ in range(n)]
    hyps = [list(rng.integers(0, vocab, rng.integers(0, 12)))
            for _ in range(n)]
    return refs, hyps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bleu_and_coco_metrics_match_jax(seed):
    refs, hyps = _random_refs_hyps(seed, vocab=6 + 4 * seed)
    assert bleu.corpus_bleu(refs, hyps) == jbleu.corpus_bleu(refs, hyps)
    assert bleu.bleu_1_to_4(refs, hyps) == jbleu.bleu_1_to_4(refs, hyps)
    assert bleu.sentence_bleu(refs[0], hyps[0]) == \
        jbleu.sentence_bleu(refs[0], hyps[0])
    words = [[[f"w{t}" for t in r] for r in rs] for rs in refs]
    whyps = [[f"w{t}" for t in h] for h in hyps]
    assert coco_metrics.coco_metrics(words, whyps) == \
        jcoco.coco_metrics(words, whyps)
    with pytest.raises(ValueError):
        bleu.corpus_bleu(refs, hyps[:-1])
