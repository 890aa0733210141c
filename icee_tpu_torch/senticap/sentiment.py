"""Sentiment utilities (a copy of ``icee_tpu/senticap/sentiment.py``;
reference ``senticap/sentiment_utils.py``, SURVEY C9).  NumPy and pickle
only: the same functions give the same numbers in both packages.

- :func:`reward` — the Gaussian goal reward, reference-exact
  (``sentiment_utils.py:7-12``: sigma=0.8 WITH the 1/(sigma*sqrt(2*pi))
  normalization),
- :func:`get_anp_reward` — rewards for a set of (anp, sentiment) pairs
  (``:14-19``; the reference body reads an undefined global ``anp_s`` and
  would raise NameError — here it iterates the argument as intended),
- :class:`SentiScores` — noun -> [(adjective, score), ...] sentiment lexicon
  with the goal-weighted ANP aggregation ``get_anp_to_score`` /
  ``get_anp_score_from_noun`` (``:34-80``),
- :class:`ANPVisualScores` — per-image adjective-noun-pair detector scores
  with the reference's uniform ``1/len(anp_to_id)`` fallback (``:22-31``;
  the reference reads Caffe detector outputs, here a pickle/npz),
- :func:`anp_joint_score` / :func:`anp_joint_score_prob` — joint
  sentiment x visual ANP selection (``:82-170``).

Deviation (documented): the reference's ``get_anp_to_score`` aliases the
stored lexicon list and ``append``s the ``('', 0.0)`` padding entry in
place (``sentiment_utils.py:49-52``), so every uncached goal grows the
lexicon by one padding entry per noun. Here the padding entry appears in
the output exactly once and the lexicon is never mutated.
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def reward(goal: float, s: float) -> float:
    """Gaussian reward for sentiment ``s`` given the goal
    (``sentiment_utils.py:7-12``): ``1/(0.8*sqrt(2*pi)) *
    exp(-(goal-s)^2 / (2*0.8^2))``."""
    sig = 0.8
    a = 1.0 / (sig * np.sqrt(2.0 * np.pi))
    b = -((goal - s) ** 2) / (2.0 * sig ** 2)
    return float(a * np.exp(b))


def get_anp_reward(goal: float,
                   anp_to_senti: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Rewards for (anp, sentiment) pairs (``sentiment_utils.py:14-19``).

    The reference body iterates an undefined global ``anp_s`` (a latent
    NameError — the function is dead code there); the intended semantics,
    reproduced here, map each pair from the argument."""
    pairs = anp_to_senti.items() if isinstance(anp_to_senti, dict) \
        else anp_to_senti
    return {w: reward(goal, s) for w, s in pairs}


class SentiScores:
    """Sentiment lexicon: noun -> [(adjective, score), ...]
    (``sentiment_utils.py:34-80``).

    Accepts either the reference's pickled dict (``.pkl``/``.pik``) or a
    ``noun<TAB>adjective<TAB>score`` TSV (this repo's offline-friendly
    format)."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.by_noun: Dict[str, List[Tuple[str, float]]] = {}
        self.cache: Dict[Optional[float], Dict[str, float]] = {}
        if path:
            if path.endswith((".pkl", ".pik", ".pickle")):
                with open(path, "rb") as f:
                    raw = pickle.load(f, encoding="latin1")
                self.by_noun = {n: [(a, float(s)) for a, s in pairs]
                                for n, pairs in raw.items()}
            else:
                with open(path) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) != 3:
                            continue
                        noun, adj, score = parts
                        self.by_noun.setdefault(noun, []).append(
                            (adj, float(score)))

    # -- this repo's convenience accessors ---------------------------------
    def adjectives_for(self, noun: str) -> List[Tuple[str, float]]:
        return self.by_noun.get(noun, [])

    def sentiment_of(self, adj: str, noun: str) -> Optional[float]:
        for a, s in self.by_noun.get(noun, []):
            if a == adj:
                return s
        return None

    # -- reference-parity aggregation (sentiment_utils.py:39-80) -----------
    def get_anp_to_score(self, all_nouns: Iterable[str],
                         goal: Optional[float] = None) -> Dict[str, float]:
        """anp ("adj_noun") -> goal reward (or raw score when goal is None),
        with the ``('', 0.0)`` padding entry per noun
        (``sentiment_utils.py:39-62``). Cached per goal."""
        if goal in self.cache:
            return self.cache[goal]
        anps_to_s: Dict[str, float] = {}
        for noun in all_nouns:
            n2s = list(self.by_noun.get(noun, []))
            n2s.append(("", 0.0))
            for adj, s in n2s:
                anp = adj + "_" + noun
                if goal is not None:
                    s = reward(goal, s)
                anps_to_s[anp] = s
        self.cache[goal] = anps_to_s
        return anps_to_s

    def get_anp_score_from_noun(self, noun: str, goal: Optional[float] = None
                                ) -> Tuple[List[str], np.ndarray]:
        """ANPs + scores for one noun (``sentiment_utils.py:64-80``).

        Reference asymmetry kept: the padding entry is appended only when
        the noun IS in the lexicon; unknown nouns return
        ``([], np.empty((1,)))``."""
        if noun not in self.by_noun:
            return [], np.empty((1,))
        n2s = list(self.by_noun[noun]) + [("", 0.0)]
        anps: List[str] = []
        scores: List[float] = []
        for adj, s in n2s:
            if goal is not None:
                s = reward(goal, s)
            anps.append(adj + "_" + noun)
            scores.append(s)
        return anps, np.array(scores)


class ANPVisualScores:
    """Adjective-noun-pair detector scores per image
    (``sentiment_utils.py:22-31``).

    The reference loads two pickles: ``anp_pred`` (img_idx -> score vector)
    and ``anp_to_id`` (anp -> column). Here both live in one pickle/npz
    ``{"anp_pred": ..., "anp_to_id": ...}``; a plain ``{image: {anp: score}}``
    mapping (this repo's earlier format) is still accepted."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.anp_pred = None
        self.anp_to_id: Dict[str, int] = {}
        self.scores: Dict[str, Dict[str, float]] = {}
        if path:
            if path.endswith(".npz"):
                blob = np.load(path, allow_pickle=True)
                loaded = {k: blob[k].item() if blob[k].dtype == object
                          else blob[k] for k in blob.files}
            else:
                with open(path, "rb") as f:
                    loaded = pickle.load(f)
            if isinstance(loaded, dict) and "anp_to_id" in loaded:
                self.anp_pred = loaded["anp_pred"]
                self.anp_to_id = dict(loaded["anp_to_id"])
            else:
                self.scores = loaded

    def get_score(self, img_idx, anp: str) -> float:
        """Detector score with the reference's uniform fallback
        ``1/len(anp_to_id)`` for unknown ANPs (``sentiment_utils.py:27-31``)."""
        if self.anp_to_id:
            if anp not in self.anp_to_id:
                return 1.0 / len(self.anp_to_id)
            return float(self.anp_pred[img_idx][self.anp_to_id[anp]])
        return self.scores.get(img_idx, {}).get(anp, 0.0)

    # back-compat alias for this repo's earlier interface
    def score(self, image, anp: str) -> float:
        return self.get_score(image, anp)


def anp_joint_score(goal: float, noun: str, img_idx, sentiscore: SentiScores,
                    vscore: ANPVisualScores, best_k: int = -1):
    """Pick the adjective maximizing ``senti_reward^2 * normalized_vis``
    for a noun (``sentiment_utils.py:155-170``)."""
    anps, senti_scores = sentiscore.get_anp_score_from_noun(noun, goal)
    if not anps and best_k == -1:
        return ""
    if not anps:
        return [(0.0, "")]
    vis = np.array([vscore.get_score(img_idx, a) for a in anps])
    vis = vis / vis.sum()
    joint = (senti_scores ** 2) * vis
    if best_k == -1:
        return anps[int(np.argmax(joint))].split("_")[0]
    idxs = np.argsort(-joint)
    return [(joint[i], anps[i].split("_")[0]) for i in idxs]


def anp_joint_score_prob(goal: float, w2i: Dict[str, int],
                         noun_pd: np.ndarray, img_idx,
                         sentiscore: SentiScores, vscore: ANPVisualScores,
                         C: Sequence[float], get_all_scores: bool = False):
    """Log-linear joint ANP score E(anp|s)·E(anp|I)·E(n|w,I), normalized by
    logsumexp, returned as negative log-prob (``sentiment_utils.py:82-153``).

    ``C = (c_vis, c_noun_pd, c_senti, c_norm)``; the reference divides C by
    C[3] (the commented-out fluency weight) before combining."""
    nouns = set(w2i.keys())
    anps_to_senti = sentiscore.get_anp_to_score(nouns, goal)

    if C[0] == 0:
        anps_to_vis = {a: 1.0 / len(anps_to_senti) for a in anps_to_senti}
    else:
        anps_to_vis = {a: vscore.get_score(img_idx, a) for a in anps_to_senti}

    anps_to_noun_pd = {}
    for anp in anps_to_senti:
        noun = anp.split("_")[1]
        if noun not in w2i:
            continue
        anps_to_noun_pd[anp] = noun_pd[w2i[noun]]

    C = np.array(C, dtype=np.float64)
    C = C / C[3]

    anp_to_score: Dict[str, float] = {}
    for anp in anps_to_senti:
        vis_score = np.log(1.0 / len(anps_to_vis))
        pd_score = np.log(1.0 / len(w2i))
        senti_score = np.log(anps_to_senti[anp])
        if anp in anps_to_vis:
            vis_score = np.log(anps_to_vis[anp])
        if anp in anps_to_noun_pd:
            pd_score = np.log(anps_to_noun_pd[anp])
        anp_to_score[anp] = float(C[0] * vis_score + C[1] * pd_score
                                  + C[2] * senti_score)

    vals = np.array(list(anp_to_score.values()))
    m = vals.max()
    z = m + np.log(np.exp(vals - m).sum())
    ranked = sorted(anp_to_score.items(), key=lambda x: x[1], reverse=True)
    ranked = [(a, -(s - z)) for a, s in ranked]
    if not get_all_scores:
        return ranked[0][0], ranked[0][1]
    return ranked


def switch_targets(tokens: List[str], senti: "SentiScores") -> List[float]:
    """ANP switch-supervision vector: 1.0 at sentiment-bearing positions
    (adjective of a known adjective-noun pair), else 0 — the ``SW`` matrix
    feeding LAMBDA_GAM supervision (``mrnn_switched.py:1006-1057``)."""
    out = [0.0] * len(tokens)
    for i in range(len(tokens) - 1):
        adj, noun = tokens[i], tokens[i + 1]
        if senti.sentiment_of(adj, noun) is not None:
            out[i] = 1.0
    return out
