"""Evaluation reports: per-emotion metric tables, micro/macro summaries, and
the learned transition-matrix dump (rencecps/run.py:253-265 prints the
ensemble-averaged tanh(trans)); eval/report.py of the JAX package."""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

from ..train import metrics
from .ensemble import apply_thresholds


def evaluate(logits, labels, thresholds, emotion_index, emotion_names) -> Dict:
    """Fixed-threshold evaluation — the reference's test() (per-emotion
    acc/weighted-F1) plus micro/macro P/R/F1 over the evaluated emotions."""
    preds = apply_thresholds(logits, thresholds, emotion_index)
    lab = np.asarray(labels)[:, list(emotion_index)]
    report = {
        "per_emotion": metrics.per_emotion_report(lab, preds, emotion_names),
        **metrics.micro_macro_prf(lab, preds),
    }
    return report


def transition_matrix(members, *, key: str = "trans") -> np.ndarray:
    """Ensemble-averaged tanh(trans) (rencecps/run.py:253-265) over members
    given as `nn.Module`s or as their state dicts."""
    mats = []
    for m in members:
        sd = m.state_dict() if hasattr(m, "state_dict") else m
        t = sd[key]
        t = t.detach().float().cpu().numpy() if hasattr(t, "detach") else t
        mats.append(np.tanh(np.asarray(t)))
    return np.mean(mats, axis=0)


def format_report(report: Dict, *, title: str = "") -> str:
    lines = []
    if title:
        lines.append(f"== {title} ==")
    for emo, vals in report.get("per_emotion", {}).items():
        lines.append(f"{emo}_acc: {vals['acc']:.6f}")
        lines.append(f"{emo}_f1:  {vals['f1']:.6f}")
    for k in ("micro_precision", "micro_recall", "micro_f1",
              "macro_precision", "macro_recall", "macro_f1"):
        if k in report:
            lines.append(f"{k}: {report[k]:.6f}")
    return "\n".join(lines)


def save_report(report: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2)


def plot_transition_matrix(mat: np.ndarray, name: str, out_path: str,
                           labels: Optional[Sequence[str]] = None) -> None:
    """Emotion-transition heatmap (rencecps/run.py:319-343's
    plot_confusion_matrix: binary colormap, From/To axes, rotated ticks)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or ["Love", "Anxiety", "Sorrow", "Joy", "Expect", "Hate",
                        "Anger", "Surprise", "Neutral"]
    fig, ax = plt.subplots()
    im = ax.imshow(mat, cmap=plt.cm.binary)
    ax.set_title(name)
    fig.colorbar(im)
    ticks = np.arange(len(labels))
    ax.set_xticks(ticks, labels, rotation=90)
    ax.set_yticks(ticks, labels)
    ax.set_ylabel("From")
    ax.set_xlabel("To")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
