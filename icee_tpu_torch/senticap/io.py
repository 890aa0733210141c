"""SentiCap data provider (a copy of ``icee_tpu/senticap/io.py``; the
split lives on a torch device).

Parity target: ``mrnn_io.py`` (SURVEY.md C1): a dataset registry mapping
names to a visual-feature file (.mat/.npz VGG-4096) + caption file
(JSON/pickle), vocabulary building with min frequency 5 and START/STOP
tokens, and ``get_data_split`` producing a padded token matrix ``X``, a
length/mask matrix ``Xlen``, feature matrix ``V``, ids, sentiment vector and
ANP switch-position matrix.

Layout conventions preserved: index 0 is the STOP token ("."), captions are
arranged ``[START(=STOP id), w1, ..., wn, STOP]`` padded to
``MAX_SENTENCE_LEN+1``; ``Xlen`` masks the prediction positions.

:func:`device_dataset` pins the whole split on a device (the analogue of
the reference's Theano shared-variable training set, ``mrnn.py:581-596``)
so the steps gather minibatches by index without host transfers.
:func:`save_model` / :func:`load_model` keep the JAX package's pickle
(numpy params, conf, solver state, w2i), so SentiCap weights move between
the two packages through it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

STOP_TOKEN = "."  # index 0; doubles as START input (mrnn_io.py:53-55)

# --- dataset-name registry (``mrnn_io.py:288-338``) ------------------------
# name -> (features file, caption file, reader kind).  Paths are relative to
# the dataset root, byte-identical to the reference's registry; COCO_MTURK
# honors the DO_NEG toggle like the reference module-level flag.
FLK8 = "flk8"
FLK8LM = "flk8lm"
COCO = "coco"
COCO_EXTRA = "coco_extra"
COCO_MTURK = "coco_mturk"
COCO_MTURK_WCOCO = "coco_mturk_wcoco"
FLK30 = "flk30"
FLK30LM = "flk30lm"
FLK30LM_SENT = "flk30lm_sent"
FLK30LM_PART = "flk30lm_part"
YH100LM = "yh100lm"

DATASET_REGISTRY = {
    FLK8: ("./flk8/flk8.mat", "./flk8/flk8.json", "mm"),
    FLK8LM: ("", "./flk8/flk8.json", "mm"),
    COCO: ("./coco/vgg_feats.mat", "./coco/dataset.json", "mm"),
    COCO_EXTRA: ("./coco/vgg_feats.mat",
                 "./coco_extra/dataset_extra.json", "mm_extra"),
    COCO_MTURK: ("./coco/vgg_feats.mat",
                 "./coco_mturk/dataset_mturk_sentiment2.json", "mm_mturk"),
    COCO_MTURK_WCOCO: ("./coco/vgg_feats.mat",
                       "./coco_mturk/dataset_mturk_sentiment2_wcoco.json",
                       "mm_mturk"),
    FLK30LM: ("", "./flk30_lm/flk30_not8k_sentences.pik", "lm"),
    FLK30LM_SENT: ("./flk30_lm/flk30_sentiment.mat",
                   "./flk30_lm/flk30_not8k_sentences.pik", "lm"),
    FLK30: ("./flickr30k/vgg_feats.mat", "./flickr30k/dataset.json", "mm"),
    FLK30LM_PART: ("", "./flickr30k/dataset.json", "mm"),
    YH100LM: ("", "./yfcc100m/yahoo_100m_saved_sentences.pik", "lm"),
}


def dataset_files(dataset_name: str, base_dir: str = ".",
                  do_neg: bool = False) -> Tuple[str, str, str]:
    """Resolve a reference dataset name -> (features path, data path,
    reader kind) (``mrnn_io.py:288-338``).  ``do_neg`` switches COCO_MTURK
    to the negative-sentiment caption file like the reference's DO_NEG."""
    if dataset_name not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset {dataset_name!r}; known: "
                       f"{sorted(DATASET_REGISTRY)}")
    feats, data, kind = DATASET_REGISTRY[dataset_name]
    if dataset_name == COCO_MTURK and do_neg:
        data = "./coco_mturk/dataset_mturk_sentiment2_neg.json"
    join = lambda p: os.path.normpath(os.path.join(base_dir, p)) if p else ""  # noqa: E731
    return join(feats), join(data), kind


@dataclasses.dataclass
class SentiDataset:
    X: np.ndarray          # (N, T) int32 input tokens (START, w1..wn, pad)
    Y: np.ndarray          # (N, T) int32 targets (w1..wn, STOP, pad)
    Xlen: np.ndarray       # (N, T) f32 mask over prediction positions
    V: np.ndarray          # (N, visual) f32
    SW: np.ndarray         # (N, T) f32 ANP switch indicators
    senti: np.ndarray      # (N,) f32 sentiment (+1 styled / -1 descriptive)
    ids: List


def tokenize(text: str) -> List[str]:
    """Reference tokenization: lowercase word split (mrnn_io readers use
    simple whitespace/punct splitting on pre-tokenized corpora)."""
    return re.findall(r"[\w']+", text.lower())


def build_vocab(captions: Sequence[Sequence[str]], min_freq: int = 5
                ) -> Tuple[Dict[str, int], Dict[int, str]]:
    """min-freq-5 vocabulary with STOP at index 0 (``mrnn_io.py:370-386``)."""
    counter = Counter(w for cap in captions for w in cap)
    w2i = {STOP_TOKEN: 0}
    for w, c in counter.items():
        if c >= min_freq and w not in w2i:
            w2i[w] = len(w2i)
    i2w = {i: w for w, i in w2i.items()}
    return w2i, i2w


def load_captions_json(path: str) -> List[dict]:
    """JSON caption file: a list of {image_id/filename, caption/tokens,
    sentiment?, switch?} records."""
    with open(path) as f:
        data = json.load(f)
    return data if isinstance(data, list) else data.get("annotations", data)


def load_features(path: str) -> Dict[str, np.ndarray]:
    """Feature file -> {image_key: (visual,) array}.  Supports .npz and
    the reference's .mat layout (``mrnn_io.py:288-338``: a 'feats' matrix
    column-per-image plus an image-name list)."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    if path.endswith(".mat"):
        from scipy.io import loadmat

        mat = loadmat(path)
        feats = mat["feats"]
        names = [str(n[0]) if hasattr(n, "__len__") else str(n)
                 for n in np.ravel(mat.get("image_names", mat.get("ids")))]
        return {name: feats[:, i].astype(np.float32)
                for i, name in enumerate(names)}
    raise ValueError(f"unsupported feature file {path}")


def make_split(
    records: Sequence[dict],
    features: Optional[Dict[str, np.ndarray]],
    w2i: Dict[str, int],
    max_len: int = 20,
    visual_size: int = 4096,
    reverse: bool = False,
) -> SentiDataset:
    """Pad/encode one split (``get_data_split``, ``mrnn_io.py:397-486``).

    ``records``: dicts with ``tokens`` (or ``caption``), ``image``,
    optional ``sentiment`` (+1/-1) and ``switch`` (list of 0/1 per token —
    the ANP positions).  ``reverse`` reverses each sentence's token order
    at read time (the provider's ``reverse`` option, ``mrnn_io.py:91``)."""
    t = max_len + 1
    n = len(records)
    X = np.zeros((n, t), np.int32)
    Y = np.zeros((n, t), np.int32)
    Xlen = np.zeros((n, t), np.float32)
    V = np.zeros((n, visual_size), np.float32)
    SW = np.zeros((n, t), np.float32)
    senti = np.zeros((n,), np.float32)
    ids = []
    for i, rec in enumerate(records):
        toks = rec.get("tokens") or tokenize(rec.get("caption", ""))
        if reverse:
            toks = list(toks)[::-1]
        toks = [w for w in toks if w in w2i][: max_len]
        ids.append(rec.get("image"))
        senti[i] = float(rec.get("sentiment", -1.0))
        # input: START(STOP id) then words; target: words then STOP
        X[i, 0] = w2i[STOP_TOKEN]
        for j, w in enumerate(toks):
            X[i, j + 1] = w2i[w]
            Y[i, j] = w2i[w]
        Y[i, len(toks)] = w2i[STOP_TOKEN]
        Xlen[i, : len(toks) + 1] = 1.0
        sw = rec.get("switch")
        if sw:
            for j, flag in enumerate(sw[: max_len]):
                SW[i, j] = float(flag)
        if features is not None and rec.get("image") in features:
            V[i] = features[rec["image"]][:visual_size]
    return SentiDataset(X=X, Y=Y, Xlen=Xlen, V=V, SW=SW, senti=senti, ids=ids)


def device_dataset(ds: SentiDataset, device="cuda"):
    """Pin a split on ``device`` (CUDA unless the caller asks for the CPU)
    as torch tensors (the reference's GPU-resident Theano shared arrays,
    ``mrnn.py:581-596``): the train steps gather minibatch rows by an index
    vector, so epochs run without host-to-device copies."""
    import torch

    from icee_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {"X": put(ds.X), "Y": put(ds.Y), "Xlen": put(ds.Xlen),
            "V": put(ds.V), "SW": put(ds.SW), "senti": put(ds.senti)}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def save_model(path: str, params, conf: dict, solver_state=None,
               vocab: Optional[Dict[str, int]] = None) -> None:
    """Pickled param dict incl. solver history and the training vocabulary
    (``mrnn.py:134-191`` saves the model dict incl. w2i/i2w).  Tensors are
    stored as numpy arrays, as the JAX package stores its arrays, so either
    package loads the file."""
    tree = {k: np.asarray(_to_numpy(v)) for k, v in params.items()}
    with open(path, "wb") as f:
        pickle.dump({"params": tree, "conf": conf,
                     "solver_state": _to_numpy(solver_state),
                     "w2i": vocab}, f)


def load_model(path: str, device="cuda"):
    """-> (params as tensors on ``device``, CUDA unless the caller asks for
    the CPU; conf, solver_state, w2i-or-None)."""
    import torch

    from icee_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    params = {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
              for k, v in blob["params"].items()}
    return (params, blob["conf"], blob.get("solver_state"),
            blob.get("w2i"))
