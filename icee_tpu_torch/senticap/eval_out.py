"""SentiCap test-path outputs (a copy of ``icee_tpu/senticap/eval_out.py``;
reference ``run_load_gap_filler``,
``train_joint.py:91-320``): HTML switch-attention highlighting, the
``eval/output_pos|des`` + ``eval/reference%d`` file layout pycocoevalcap-style
tooling expects, and the quantitative metric block."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence


def switch_highlight_html(words: Sequence[str], att: Sequence[float],
                          threshold: float = 0.5) -> str:
    """Per-word switch-gate highlighting (the reference prints sentiment-
    switched words in color): gate value maps to a red intensity."""
    spans = []
    for i, w in enumerate(words):
        a = float(att[i]) if i < len(att) else 0.0
        intensity = int(255 * min(max(a, 0.0), 1.0))
        weight = "bold" if a >= threshold else "normal"
        spans.append(
            f'<span style="color: rgb({intensity},0,0); '
            f'font-weight: {weight}" title="switch={a:.3f}">{w}</span>'
        )
    return " ".join(spans)


def write_eval_outputs(decodes: List[dict], references: Dict[str, List[List[str]]],
                       out_dir: str) -> None:
    """Write ``output_pos`` / ``output_des`` (one caption per line) and
    ``reference%d`` files (reference layout, ``train_joint.py`` eval dir)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "output_pos"), "w") as fp, \
            open(os.path.join(out_dir, "output_des"), "w") as fd:
        for rec in decodes:
            fp.write(" ".join(rec.get("positive", [])) + "\n")
            fd.write(" ".join(rec.get("descriptive", [])) + "\n")
    max_refs = max((len(references.get(rec["image"], []))
                    for rec in decodes), default=0)
    for r in range(max_refs):
        with open(os.path.join(out_dir, f"reference{r}"), "w") as f:
            for rec in decodes:
                refs = references.get(rec["image"], [])
                f.write((" ".join(refs[r]) if r < len(refs) else "") + "\n")
    with open(os.path.join(out_dir, "highlight.html"), "w") as f:
        f.write("<html><body>\n")
        for rec in decodes:
            if "positive" in rec and "attention" in rec:
                f.write(f"<p>[{rec['image']}] "
                        + switch_highlight_html(rec["positive"],
                                                rec["attention"])
                        + "</p>\n")
        f.write("</body></html>\n")


def score_decodes(decodes: List[dict],
                  references: Dict[str, List[List[str]]],
                  key: str = "positive") -> Dict[str, object]:
    """BLEU-1..4 / ROUGE_L / CIDEr over the decoded split
    (``train_joint.py:299-320``)."""
    from icee_tpu_torch.evaluation.coco_metrics import coco_metrics

    refs, hyps = [], []
    for rec in decodes:
        rs = references.get(rec["image"])
        if not rs:
            continue
        refs.append(rs)
        hyps.append(rec.get(key, rec.get("caption", [])))
    return coco_metrics(refs, hyps)
