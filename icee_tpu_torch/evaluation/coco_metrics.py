"""Caption metrics beyond BLEU: ROUGE-L, CIDEr-D and METEOR (copy of
``icee_tpu/evaluation/coco_metrics.py``).

The reference's SentiCap test path scores decodes with pycocoevalcap's
BLEU / ROUGE_L / CIDEr / METEOR (``train_joint.py:299-320``).  pycocoevalcap
is not available offline; these are standalone implementations of the same
published formulas:

- ROUGE-L (Lin 2004, as in pycocoevalcap): LCS-based F-measure with
  beta=1.2; max precision and max recall are taken independently across
  references, then combined into one F; corpus mean,
- CIDEr-D (Vedantam et al. 2015): TF-IDF-weighted n-gram cosine for n=1..4
  with length-difference Gaussian penalty (sigma=6) and the *-D clipping,
  averaged over n, x10 scale, document frequencies from the reference
  corpus,
- METEOR (Banerjee & Lavie 2005 / Lavie & Agarwal 2007 scoring): staged
  injective unigram alignment — EXACT tier, then PORTER-STEM tier (the
  nltk Porter stemmer is pure code, no corpus data needed offline) —
  F_mean = P*R / (alpha*P + (1-alpha)*R) with a chunk fragmentation
  penalty gamma*(chunks/matches)^beta; best score over references.
  DOCUMENTED DEVIATION from the pycocoevalcap Java METEOR 1.5: the
  WordNet-synonym and paraphrase-table tiers need external data files that
  cannot be shipped offline, so those match stages are dropped (scores are
  a lower bound), and 1.5's content/function-word weighting is not applied.
  The default parameters (alpha=0.9, beta=3, gamma=0.5) are the published
  METEOR defaults used by nltk's implementation.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


# --- ROUGE-L --------------------------------------------------------------

def _lcs_len(a: Sequence, b: Sequence) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_sentence(references: Sequence[Sequence], hypothesis: Sequence,
                     beta: float = 1.2) -> float:
    """pycocoevalcap rouge.py semantics: max precision and max recall are
    taken INDEPENDENTLY across references, then combined into one F."""
    prec_max = 0.0
    rec_max = 0.0
    for ref in references:
        lcs = _lcs_len(ref, hypothesis)
        if hypothesis:
            prec_max = max(prec_max, lcs / len(hypothesis))
        if ref:
            rec_max = max(rec_max, lcs / len(ref))
    if prec_max == 0.0 or rec_max == 0.0:
        return 0.0
    return ((1 + beta ** 2) * prec_max * rec_max) / (
        rec_max + beta ** 2 * prec_max)


def rouge_l(list_of_references, hypotheses) -> float:
    """Corpus mean of per-sentence ROUGE-L."""
    scores = [rouge_l_sentence(refs, hyp)
              for refs, hyp in zip(list_of_references, hypotheses)]
    return sum(scores) / max(len(scores), 1)


# --- CIDEr-D --------------------------------------------------------------

def _ngram_counts(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n])
                   for i in range(len(tokens) - n + 1))


def cider_d(list_of_references, hypotheses, n_max: int = 4,
            sigma: float = 6.0) -> float:
    """CIDEr-D corpus score (pycocoevalcap ciderD semantics, x10 scale).

    Document frequencies are computed from the reference sets of THIS corpus
    (the pycocoevalcap default "corpus" mode).
    """
    m = len(hypotheses)
    if m == 0:
        return 0.0
    # document frequency per n-gram: number of images whose reference set
    # contains it
    doc_freq: List[Dict] = [defaultdict(int) for _ in range(n_max)]
    for refs in list_of_references:
        for n in range(n_max):
            grams = set()
            for ref in refs:
                grams |= set(_ngram_counts(ref, n + 1))
            for g in grams:
                doc_freq[n][g] += 1
    log_m = math.log(max(m, 1))

    def tfidf_vec(tokens):
        vecs, norms = [], []
        length = len(tokens)
        for n in range(n_max):
            counts = _ngram_counts(tokens, n + 1)
            vec = {}
            norm = 0.0
            for g, tf in counts.items():
                df = math.log(max(doc_freq[n][g], 1))
                w = tf * max(log_m - df, 0.0)
                vec[g] = w
                norm += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms, length

    total = 0.0
    for refs, hyp in zip(list_of_references, hypotheses):
        h_vecs, h_norms, h_len = tfidf_vec(hyp)
        score_n = [0.0] * n_max
        for ref in refs:
            r_vecs, r_norms, r_len = tfidf_vec(ref)
            delta = h_len - r_len
            penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(n_max):
                # CIDEr-D: clipped cosine — numerator is
                # sum(min(h_w, r_w) * r_w) (pycocoevalcap ciderD)
                num = sum(min(w, r_vecs[n].get(g, 0.0)) * r_vecs[n].get(g, 0.0)
                          for g, w in h_vecs[n].items())
                denom = h_norms[n] * r_norms[n]
                if denom > 0:
                    score_n[n] += penalty * num / denom
        n_refs = max(len(refs), 1)
        total += 10.0 * sum(s / n_refs for s in score_n) / n_max
    return total / m


# --- METEOR ---------------------------------------------------------------

def _porter_stem(word):
    try:
        from nltk.stem.porter import PorterStemmer
    except Exception:  # without nltk the stem tier matches exact words only
        return word
    global _STEMMER
    if "_STEMMER" not in globals():
        _STEMMER = PorterStemmer()
    return _STEMMER.stem(str(word))


def _align_unigrams(ref: Sequence, hyp: Sequence):
    """Staged injective alignment: exact matches first (in word order),
    then Porter-stem matches on the leftovers.  Returns (hyp_idx, ref_idx)
    pairs.  The WordNet-synonym / paraphrase tiers of METEOR 1.5 are
    intentionally absent (no offline data; see module docstring)."""
    pairs = []
    ref_free = [True] * len(ref)
    hyp_free = [True] * len(hyp)
    # tier 1: exact
    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            if ref_free[j] and hw == rw:
                pairs.append((i, j))
                ref_free[j] = False
                hyp_free[i] = False
                break
    # tier 2: stem
    ref_stems = [_porter_stem(w) for w in ref]
    for i, hw in enumerate(hyp):
        if not hyp_free[i]:
            continue
        hs = _porter_stem(hw)
        for j in range(len(ref)):
            if ref_free[j] and hs == ref_stems[j]:
                pairs.append((i, j))
                ref_free[j] = False
                hyp_free[i] = False
                break
    return sorted(pairs)


def _count_chunks(pairs) -> int:
    """Number of maximal runs that are contiguous in BOTH sentences
    (pairs sorted by hypothesis index)."""
    if not pairs:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(pairs, pairs[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def meteor_sentence(references: Sequence[Sequence], hypothesis: Sequence,
                    alpha: float = 0.9, beta: float = 3.0,
                    gamma: float = 0.5) -> float:
    """Single-sentence METEOR: best score over the reference set."""
    best = 0.0
    for ref in references:
        pairs = _align_unigrams(ref, hypothesis)
        m = len(pairs)
        if m == 0 or not hypothesis or not ref:
            continue
        p = m / len(hypothesis)
        r = m / len(ref)
        f_mean = p * r / (alpha * p + (1 - alpha) * r)
        frag = _count_chunks(pairs) / m
        score = f_mean * (1.0 - gamma * frag ** beta)
        best = max(best, score)
    return best


def meteor(list_of_references, hypotheses) -> float:
    """Corpus METEOR = mean of per-sentence scores (pycocoevalcap reports
    the aggregate the same way for the default jar invocation)."""
    scores = [meteor_sentence(refs, hyp)
              for refs, hyp in zip(list_of_references, hypotheses)]
    return sum(scores) / max(len(scores), 1)


def coco_metrics(list_of_references, hypotheses) -> Dict[str, object]:
    """The SentiCap test-path metric block (``train_joint.py:299-320``):
    BLEU-1..4 + ROUGE_L + CIDEr-D + METEOR (exact+stem tiers; see module
    docstring for the documented deviation from the Java 1.5 scorer)."""
    from icee_tpu_torch.evaluation.bleu import bleu_1_to_4

    b1, b2, b3, b4 = bleu_1_to_4(list_of_references, hypotheses)
    return {
        "Bleu_1": b1, "Bleu_2": b2, "Bleu_3": b3, "Bleu_4": b4,
        "ROUGE_L": rouge_l(list_of_references, hypotheses),
        "CIDEr": cider_d(list_of_references, hypotheses),
        "METEOR": meteor(list_of_references, hypotheses),
    }
