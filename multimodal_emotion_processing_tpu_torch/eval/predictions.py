"""Offline batch-prediction artifacts: named per-sample outputs to disk.

The reference's only per-sample output is a print of six probabilities in
the live demo loop (robot_demo.py:594-649); its eval scripts reduce straight
to metrics and discard the predictions.  A framework needs the artifact in
between: run the trained ensemble over a dataset ONCE and keep every
sample's logits / calibrated probabilities / threshold decisions in a file
downstream tooling can read (error analysis, calibration studies, serving
regression baselines).

`prediction_table` builds the named table from cached ensemble logits;
`write_predictions` persists it as `.npz` (arrays, lossless), `.csv`
(spreadsheet-friendly named columns), or `.jsonl` (one object per sample).
Probabilities use the serving calibration `sigmoid(logit - threshold)`
(robot_demo.py:609), so a row here equals what `serve`/`POST /predict`
returns for the same sample; decisions use the eval rule
`logit > threshold` (eval/ensemble.apply_thresholds).  The port's copy of
eval/predictions.py of the JAX package.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

from .ensemble import apply_thresholds


def prediction_table(
    logits: np.ndarray,
    thresholds: Sequence[float],
    emotion_index: Sequence[int],
    emotion_names: Sequence[str],
    labels: Optional[np.ndarray] = None,
) -> Dict:
    """Named per-sample outputs from cached ensemble logits.

    Returns {"emotions", "thresholds", "logits" (N, E) full head output,
    "named_logits" (N, len(emotions)) emotion-ordered columns, "probs"
    calibrated sigmoid(logit - threshold), "pred" 0/1 decisions, and
    "labels" (emotion-ordered 0/1) when given}.
    """
    logits = np.asarray(logits)
    th = np.asarray([float(t) for t in thresholds], np.float32)
    if len(th) != len(emotion_names) or len(emotion_index) != len(emotion_names):
        raise ValueError(
            f"{len(emotion_names)} emotions need {len(emotion_names)} "
            f"thresholds/indices; got {len(th)} thresholds, "
            f"{len(emotion_index)} indices")
    cols = np.stack([logits[:, i] for i in emotion_index], axis=1)
    table: Dict = {
        "emotions": list(emotion_names),
        "thresholds": th.tolist(),
        "logits": logits,
        "named_logits": cols,
        "probs": 1.0 / (1.0 + np.exp(-(cols - th[None, :]))),
        "pred": apply_thresholds(logits, th, emotion_index),
    }
    if labels is not None:
        labels = np.asarray(labels)
        table["labels"] = np.stack(
            [labels[:, i] for i in emotion_index], axis=1).astype(np.int32)
    return table


def write_predictions(path: str, table: Dict) -> None:
    """Persist a `prediction_table` by extension: .npz / .csv / .jsonl."""
    if path.endswith(".npz"):
        arrays = {k: v for k, v in table.items()
                  if isinstance(v, np.ndarray)}
        np.savez(path, emotions=np.asarray(table["emotions"]),
                 thresholds=np.asarray(table["thresholds"], np.float32),
                 **arrays)
        return
    names = table["emotions"]
    has_labels = "labels" in table
    if path.endswith(".csv"):
        cols = ([f"{n}_logit" for n in names] + [f"{n}_prob" for n in names]
                + [f"{n}_pred" for n in names]
                + ([f"{n}_label" for n in names] if has_labels else []))
        with open(path, "w") as f:
            f.write("index," + ",".join(cols) + "\n")
            for i in range(table["pred"].shape[0]):
                row = ([f"{x:.6g}" for x in table["named_logits"][i]]
                       + [f"{x:.6g}" for x in table["probs"][i]]
                       + [str(int(x)) for x in table["pred"][i]]
                       + ([str(int(x)) for x in table["labels"][i]]
                          if has_labels else []))
                f.write(f"{i}," + ",".join(row) + "\n")
        return
    if path.endswith(".jsonl"):
        with open(path, "w") as f:
            for i in range(table["pred"].shape[0]):
                obj = {
                    "index": i,
                    "logits": {n: float(x) for n, x in
                               zip(names, table["named_logits"][i])},
                    "probs": {n: float(x) for n, x in
                              zip(names, table["probs"][i])},
                    "pred": {n: int(x) for n, x in
                             zip(names, table["pred"][i])},
                }
                if has_labels:
                    obj["label"] = {n: int(x) for n, x in
                                    zip(names, table["labels"][i])}
                f.write(json.dumps(obj) + "\n")
        return
    raise ValueError(f"unsupported predictions format {path!r}: "
                     "use .npz, .csv, or .jsonl")


def calibration_report(table: Dict, *, n_bins: int = 10) -> Dict:
    """Per-emotion calibration of the serving probabilities against labels:
    expected calibration error (ECE — confidence-vs-accuracy gap weighted
    by bin occupancy, equal-width bins over [0, 1]) plus the reliability
    table (per bin: count, mean predicted probability, empirical positive
    rate).  The serving story ships `sigmoid(logit - threshold)` as a
    probability (robot_demo.py:609 prints them as confidences); this is
    the artifact that says whether those numbers can be read that way.
    Requires a `prediction_table` built with labels."""
    if "labels" not in table:
        raise ValueError("calibration needs labels — build the prediction "
                         "table from a labeled split")
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    probs = np.asarray(table["probs"], np.float64)
    labels = np.asarray(table["labels"], np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    out: Dict = {"n_bins": n_bins, "per_emotion": {}}
    for j, name in enumerate(table["emotions"]):
        p, y = probs[:, j], labels[:, j]
        # right-inclusive last bin so p == 1.0 lands in bin n_bins - 1
        idx = np.clip(np.digitize(p, edges[1:-1]), 0, n_bins - 1)
        bins = []
        ece = 0.0
        for b in range(n_bins):
            m = idx == b
            cnt = int(m.sum())
            if cnt:
                conf = float(p[m].mean())
                rate = float(y[m].mean())
                ece += cnt / len(p) * abs(conf - rate)
            else:
                conf = rate = None
            bins.append({"lo": float(edges[b]), "hi": float(edges[b + 1]),
                         "count": cnt, "mean_prob": conf,
                         "positive_rate": rate})
        out["per_emotion"][name] = {"ece": float(ece), "bins": bins,
                                    "positives": int(y.sum()),
                                    "n": int(len(y))}
    out["mean_ece"] = float(np.mean(
        [v["ece"] for v in out["per_emotion"].values()]))
    return out


__all__ = ["prediction_table", "write_predictions", "calibration_report"]
