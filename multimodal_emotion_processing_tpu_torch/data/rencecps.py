"""Ren-CECps' corpus layer (data/rencecps.py of the JAX package): the
cet_N.txt emotion-intensity lines, the cet_N.xml paragraph and sentence
ids, the pair lists in document order, and the flattening of the BERT
features (rencecps/run.py:30-127).

The reference's quirks, kept:
  * a sentence line whose text is empty or a placeholder ('\\n', '/n\\n',
    '/n', '' or starting with '/') is skipped and its counter recorded;
  * an all-zero intensity row becomes the neutral label [0..0, 1];
  * documents 1-1189 are train, 1190-1487 test; documents 490 and 761 are
    skipped;
  * pairs reset only at a document's start (name X_1_1); otherwise each
    sentence pairs with its predecessor in corpus order, across paragraph
    boundaries (rencecps/run.py:86-98);
  * a sentence's features flatten to concat(CLS, max(tokens[1:]),
    mean(tokens[1:])), 2304-d (rencecps/run.py:103-109).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

NO_NAME = "no_name"
SKIP_DOCS = (490, 761)  # documents the reference skips
EMOTIONS = ("Love", "Anxiety", "Sorrow", "Joy", "Expect", "Hate", "Anger",
            "Surprise", "Neutral")
_EMPTY_TEXT = ("\n", "/n\n", "/n", "")


def parse_label_file(path: str) -> Tuple[List[List[int]], List[int]]:
    """One cet_N.txt -> (labels, the skipped sentences' counters)."""
    labels, skipped = [], []
    with open(path, "r") as f:
        count = 0
        for line in f:
            if not line or line[0] != "s":
                continue
            count += 1
            fields = line.split(":")
            text = fields[2] if len(fields) > 2 else ""
            if text in _EMPTY_TEXT or (text and text[0] == "/"):
                skipped.append(count)
                continue
            label = [0] * 9
            for idx, x in enumerate(fields[1].split(",")[:8]):
                if x != "0.0":
                    label[idx] = 1
            if sum(label) == 0:
                label = [0, 0, 0, 0, 0, 0, 0, 0, 1]
            labels.append(label)
    return labels, skipped


def parse_xml_ids(path: str, skipped: List[int]) -> Tuple[List[str], List[str]]:
    """One cet_N.xml -> (paragraph ids, sentence ids), the skipped counters
    left out."""
    paras, sents = [], []
    with open(path, "r") as f:
        count = 0
        for line in f:
            if "<S_no>" not in line:
                continue
            count += 1
            if count in skipped:
                continue
            paras.append(line.split("段第")[0].split("第")[1])
            sents.append(line.split("段第")[1].split("句")[0])
    return paras, sents


def load_split(txt_dir: str, xml_dir: str, category: str = "train") -> List[Dict]:
    start, end = (1190, 1488) if category == "test" else (1, 1190)
    out = []
    for i in range(start, end):
        if i in SKIP_DOCS:
            continue
        labels, skipped = parse_label_file(os.path.join(txt_dir, f"cet_{i}.txt"))
        paras, sents = parse_xml_ids(os.path.join(xml_dir, f"cet_{i}.xml"), skipped)
        for j in range(len(paras)):
            out.append({"name": f"{i}_{paras[j]}_{sents[j]}", "label": labels[j]})
    return out


def pair_list(entries: List[Dict]) -> List[List[Dict]]:
    """(previous, current) pairs in corpus order, reset at document starts."""
    pairs, temp = [], []
    for e in entries:
        _, para, sent = e["name"].split("_")
        if para == "1" and sent == "1":
            temp = [{"name": NO_NAME}, e]
        else:
            temp = temp[-1:] + [e]
        pairs.append(temp)
    return pairs


def flatten_bert(tokens: np.ndarray) -> np.ndarray:
    """One sentence's token features -> concat(CLS, max, mean)."""
    cls = tokens[0]
    mx = tokens[1:].max(axis=0)
    mean = tokens[1:].mean(axis=0)
    return np.concatenate([cls, mx, mean], axis=0).astype(np.float32)


class RenCecpsAssembler:
    """(2, 2304) pair samples (rencecps/run.py:111-127)."""

    def __init__(self, feat_source, dim: int = 2304):
        self.src = feat_source
        self.dim = dim

    def sample_for_pair(self, pair) -> Dict[str, np.ndarray]:
        prev, cur = pair
        if prev["name"] == NO_NAME:
            f0 = np.zeros(self.dim, np.float32)
        else:
            f0 = flatten_bert(self.src.get(prev["name"]))
        f1 = flatten_bert(self.src.get(cur["name"]))
        return {"feat": np.stack([f0, f1]),
                "label": np.asarray(cur["label"], np.int32)}

    def materialize(self, pairs) -> List[Dict[str, np.ndarray]]:
        return [self.sample_for_pair(p) for p in pairs]
