"""Metrics: per-emotion accuracy and weighted F1 and micro/macro P/R/F1,
numerically identical to the reference's sklearn calls
(cmu-mosei/run.py:499-510, rencecps/run.py:307-312), computed from
confusion counts with numpy alone (train/metrics.py of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def binary_counts(y_true, y_pred):
    y_true = np.asarray(y_true).astype(bool)
    y_pred = np.asarray(y_pred).astype(bool)
    tp = int((y_true & y_pred).sum())
    fp = int((~y_true & y_pred).sum())
    fn = int((y_true & ~y_pred).sum())
    tn = int((~y_true & ~y_pred).sum())
    return tp, fp, fn, tn


def accuracy(y_true, y_pred) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float((y_true == y_pred).mean())


def _prf(tp, fp, fn):
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1


def weighted_f1(y_true, y_pred) -> float:
    """sklearn f1_score(average='weighted') for binary labels: F1 of each
    class (0 and 1) weighted by class support."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    total = len(y_true)
    out = 0.0
    for cls in (0, 1):
        support = int((y_true == cls).sum())
        if support == 0:
            continue
        tp, fp, fn, _ = binary_counts(y_true == cls, y_pred == cls)
        _, _, f1 = _prf(tp, fp, fn)
        out += f1 * support / total
    return float(out)


def micro_macro_prf(y_true, y_pred) -> Dict[str, float]:
    """Multi-label micro/macro precision/recall/F1 over (N, L) binary arrays."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    n_labels = y_true.shape[1]
    tps = fps = fns = 0
    macro_p = macro_r = macro_f1 = 0.0
    for j in range(n_labels):
        tp, fp, fn, _ = binary_counts(y_true[:, j], y_pred[:, j])
        tps += tp; fps += fp; fns += fn
        p, r, f1 = _prf(tp, fp, fn)
        macro_p += p; macro_r += r; macro_f1 += f1
    micro_p, micro_r, micro_f1 = _prf(tps, fps, fns)
    return {
        "micro_precision": micro_p, "micro_recall": micro_r, "micro_f1": micro_f1,
        "macro_precision": macro_p / n_labels, "macro_recall": macro_r / n_labels,
        "macro_f1": macro_f1 / n_labels,
    }


def per_emotion_report(y_true, y_pred, names: Sequence[str]) -> Dict[str, Dict[str, float]]:
    """Per-emotion {acc, f1} over (N, E) arrays — the reference's test() print."""
    out = {}
    for j, name in enumerate(names):
        out[name] = {
            "acc": accuracy(y_true[:, j], y_pred[:, j]),
            "f1": weighted_f1(y_true[:, j], y_pred[:, j]),
        }
    return out
