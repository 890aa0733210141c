"""The port's checkpoint format (``icee_tpu_torch/checkpoint/ckpt.py``):
a save / load round trip is bit-exact and loads with ``weights_only=True``;
the ``{MODE}[_BEST]_checkpoint_{name}`` paths are the JAX package's and
BEST is written only on improvement; a trainer restores at epoch + 1 with
its counters, params and both optimizer states; a CaptionEngine built from
a trainer's checkpoint captions as one built from the same params; and an
orbax directory (the JAX package's format) is refused."""

import os

import numpy as np
import pytest
import torch

from icee_tpu_torch.checkpoint import ckpt
from icee_tpu_torch.core.config import (MODES, DecoderConfig, EncoderConfig,
                                        TrainConfig)
from icee_tpu_torch.data.vocab import build_vocab
from icee_tpu_torch.models import encoder as enc
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.serve.config import ServeConfig
from icee_tpu_torch.serve.engine import CaptionEngine
from icee_tpu_torch.train import optim
from icee_tpu_torch.train.loops import MultitaskTrainer
from icee_tpu_torch.train.optim import AdamState

TRAIN = "examples/data/train.txt"
E, H, FEAT = 8, 12, 16


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One CPU thread while this module runs: with more, a thread of the
    intra-op pool can compute a float32 exp up to ~1,800 ulps off in a few
    processes in a hundred (PERF.md section 7), and these tests compare
    float32 values across packages."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(vocab):
    return DecoderConfig(vocab_size=len(vocab), embed_size=E, hidden_size=H,
                         factored_size=H, feature_size=FEAT, max_seq_length=6)


def _trees(vocab, family, seed=0):
    g = torch.Generator().manual_seed(seed)
    init = fl.init_params if family == "factored" else nic.init_params
    dec = init(g, _cfg(vocab))
    # N(0, 1) weights and a strong head, so that beams end at several
    # lengths rather than at the bare <end> of a near-zero init
    dec = {k: (torch.randn(v.shape, generator=g) if isinstance(v, torch.Tensor)
               else {kk: torch.randn(vv.shape, generator=g)
                     for kk, vv in v.items()}) for k, v in dec.items()}
    dec["C_b" if family == "factored" else "linear_b"][vocab.end] += 1.0
    head = enc.init_head_params(g, EncoderConfig(embed_size=E,
                                                 feature_size=FEAT))
    head["linear_w"] = head["linear_w"] * 30.0
    return dec, head


def _trainer(vocab, tmp_path, family="factored", seed=0):
    dec, head = _trees(vocab, family, seed)
    return MultitaskTrainer(_cfg(vocab), TrainConfig(mode="sad"), vocab, dec,
                            head, family=family, device="cpu",
                            model_dir=str(tmp_path), data_name="toy")


def _leaves_equal(a, b):
    la, lb = optim.tree_leaves(a), optim.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None:
            assert y is None
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)


def _trained_state(vocab, tmp_path):
    """A trainer whose optimizer states hold moments (one step each)."""
    tr = _trainer(vocab, tmp_path)
    rng = np.random.default_rng(0)
    pooled = torch.tensor(rng.standard_normal((4, FEAT)), dtype=torch.float32)
    caps = torch.tensor(rng.integers(1, len(vocab), (4, 7)))
    lens = torch.tensor([7, 5, 3, 0])
    mask = torch.tensor([True, True, True, False])
    tr.factual_step(tr.dec, tr.head, tr.opt_state, pooled, caps, lens, mask)
    tr.emotion_step(tr.dec, tr.head, tr.lang_opt_state, pooled, caps, lens,
                    mask, 2)
    optim.decay_lr(tr.lang_opt_state, 0.8)
    return tr


def test_round_trip_is_bit_exact_and_weights_only(tmp_path):
    vocab = build_vocab(TRAIN, 1)
    tr = _trained_state(vocab, tmp_path)
    state = tr._state(7)
    state.extra = {"note": "x"}
    path = ckpt.save_checkpoint(str(tmp_path), "toy", "SAD", state, True)
    assert os.listdir(path) == [ckpt.CKPT_FILE]
    raw = torch.load(os.path.join(path, ckpt.CKPT_FILE), weights_only=True)
    assert raw["epoch"] == 7 and raw["extra"] == {"note": "x"}
    assert raw["opt_states"]["lang_optimizer"]["count"] == 1
    got = ckpt.load_checkpoint(path, tr._state(0).as_pytree())
    _leaves_equal(got["params"], state.params)
    for name, want in state.opt_states.items():
        have = got["opt_states"][name]
        assert isinstance(have, AdamState)
        assert have.count == want.count == 1
        assert have.hyperparams == want.hyperparams
        _leaves_equal((have.mu, have.nu), (want.mu, want.nu))
    assert got["best_bleu4"] == state.best_bleu4
    _leaves_equal(ckpt.load_params(path), state.params)
    bad = tr._state(0).as_pytree()
    bad["params"]["decoder"]["B"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="template"):
        ckpt.load_checkpoint(path, bad)


@pytest.mark.parametrize("best", [False, True])
def test_paths_and_best_only_on_improvement(tmp_path, best):
    vocab = build_vocab(TRAIN, 1)
    tr = _trainer(vocab, tmp_path)
    tr.save(0, best)
    want = ["SAD_checkpoint_toy"] + (["SAD_BEST_checkpoint_toy"] if best
                                     else [])
    assert sorted(os.listdir(tmp_path)) == sorted(want)
    assert ckpt._ckpt_path(str(tmp_path), "toy", "SAD", best) == \
        os.path.abspath(tmp_path / want[-1])
    tr.save(1, False, mode_tag="FAC")
    assert "FAC_checkpoint_toy" in os.listdir(tmp_path)
    assert "FAC_BEST_checkpoint_toy" not in os.listdir(tmp_path)
    assert not any(n.startswith(".ckpt_")
                   for d in os.listdir(tmp_path)
                   for n in os.listdir(tmp_path / d))


def test_restore_resumes_at_the_next_epoch(tmp_path):
    vocab = build_vocab(TRAIN, 1)
    tr = _trained_state(vocab, tmp_path)
    tr.best_bleu4 = {"factual": 0.25, "emotion": 0.125}
    tr.epochs_since_improvement = {"factual": 3, "emotion": 1}
    tr.save(4, True)
    other = _trainer(vocab, tmp_path / "other", seed=5)
    other.restore(str(tmp_path / "SAD_BEST_checkpoint_toy"))
    assert other.start_epoch == 5
    assert other.best_bleu4 == tr.best_bleu4
    assert other.epochs_since_improvement == tr.epochs_since_improvement
    _leaves_equal((other.dec, other.head), (tr.dec, tr.head))
    for a, b in ((other.opt_state, tr.opt_state),
                 (other.lang_opt_state, tr.lang_opt_state)):
        assert a.count == b.count and a.hyperparams == b.hyperparams
        _leaves_equal((a.mu, a.nu), (b.mu, b.nu))


@pytest.mark.parametrize("family", ["factored", "nic"])
def test_engine_from_a_trainer_checkpoint(tmp_path, family):
    vocab = build_vocab(TRAIN, 1)
    vocab_path = str(tmp_path / "vocab.pkl")
    vocab.save(vocab_path)
    tr = _trainer(vocab, tmp_path / "models", family)
    tr.save(0, True)
    path = str(tmp_path / "models" / "SAD_BEST_checkpoint_toy")
    variant = "stylenet" if family == "factored" else "nic"
    kw = dict(dec_cfg=_cfg(vocab),
              enc_cfg=EncoderConfig(embed_size=E, feature_size=FEAT),
              device="cpu")
    from_ckpt = CaptionEngine(
        ServeConfig(vocab_path=vocab_path,
                    checkpoint_paths={variant: {m: path for m in MODES}}),
        params={"backbone": {}}, **kw)
    from_params = CaptionEngine(
        ServeConfig(vocab_path=vocab_path),
        params={"backbone": {}, variant: {"decoder": tr.dec,
                                          "head": tr.head}}, **kw)
    pooled = torch.tensor(np.random.default_rng(3).standard_normal(
        (6, FEAT)), dtype=torch.float32)
    lengths = set()
    for mode in ("factual", "sad"):
        caps = []
        for eng in (from_ckpt, from_params):
            res = eng.decode(eng.head(pooled, mode, variant), mode,
                             variant=variant)
            caps.append([eng._detok(t, n) for t, n in zip(res.tokens,
                                                          res.length)])
            lengths.update(int(n) for n in res.length)
        assert caps[0] == caps[1]
    assert len(lengths) > 1


def test_orbax_directory_is_refused(tmp_path):
    vocab = build_vocab(TRAIN, 1)
    vocab_path = str(tmp_path / "vocab.pkl")
    vocab.save(vocab_path)
    orbax = tmp_path / "HAP_BEST_checkpoint_toy"
    (orbax / "d").mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_params(str(orbax))
    with pytest.raises(NotImplementedError, match="orbax"):
        CaptionEngine(
            ServeConfig(vocab_path=vocab_path, checkpoint_paths={
                "stylenet": {m: str(orbax) for m in MODES}}),
            params={"backbone": {}}, dec_cfg=_cfg(vocab),
            enc_cfg=EncoderConfig(embed_size=E, feature_size=FEAT),
            device="cpu")
