"""Ren-MME's corpus layer (data/ren_mme.py of the JAX package): the
zero_one_adjust.csv label table, the per-modality features with the video
fallback chain for missing files, and the (pre, pro) utterance-pair
assembler (Ren-MME/run.py:42-148).

The reference's quirks, kept:
  * episodes 9 and 10 are the test split;
  * audio .npy files are stored transposed and flipped on load
    (Ren-MME/run.py:110): the audio source is an `NpyDirSource(...,
    transpose=True)`;
  * a missing video file falls back name -> prev -> next -> prev-prev ->
    zeros (Ren-MME/run.py:79-91);
  * the previous utterance of sentence 1 is itself (Ren-MME/run.py:131-136);
  * the R-Drop duplication is the Batcher's `duplicate=True`, not done here.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Tuple

import numpy as np

from . import masking

EMOTIONS = ("Love", "Anxiety", "Sorrow", "Joy", "Expect", "Hate", "Anger",
            "Surprise", "Neutral")


def load_label_table(path: str) -> Tuple[List[Tuple[str, List[int]]],
                                         List[Tuple[str, List[int]]]]:
    """(train, test) rows of (name, label); episodes 9 and 10 are the test
    split."""
    train, test = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            name = f"{row['Episode']}_{row['Dialogue']}_{row['Sentence']}"
            label = [int(row[e]) for e in EMOTIONS]
            if int(row["Episode"]) in (9, 10):
                test.append((name, label))
            else:
                train.append((name, label))
    return train, test


def previous_name(name: str) -> str:
    parts = name.split("_")
    if parts[-1] == "1":
        return name
    parts[-1] = str(int(parts[-1]) - 1)
    return "_".join(parts)


def video_fallback_names(name: str) -> List[str]:
    parts = name.split("_")
    sent = int(parts[-1])

    def with_sent(s):
        return "_".join(parts[:-1] + [str(s)])

    return [name, with_sent(sent - 1), with_sent(sent + 1), with_sent(sent - 2)]


class RenMmeAssembler:
    """(2, len, dim) samples of the (pre, pro) utterances over npy-directory
    sources."""

    def __init__(self, m, text_src, video_src, audio_src):
        self.m = m
        self.text_src = text_src
        self.video_src = video_src
        self.audio_src = audio_src

    def _text(self, name):
        return masking.pad_or_truncate(self.text_src.get(name), self.m.l_len)

    def _video(self, name):
        for candidate in video_fallback_names(name):
            if candidate in self.video_src:
                return masking.pad_or_truncate(self.video_src.get(candidate),
                                               self.m.v_len)
        return (np.zeros((self.m.v_len, self.m.v_dim), np.float32),
                np.ones(self.m.v_len, np.float32))

    def _audio(self, name):
        return masking.pad_or_truncate(self.audio_src.get(name), self.m.a_len)

    def sample_for(self, name: str, label) -> Dict[str, np.ndarray]:
        pre = previous_name(name)
        out = {}
        for kind, fn in (("l", self._text), ("v", self._video), ("a", self._audio)):
            pre_f, pre_m = fn(pre)
            pro_f, pro_m = fn(name)
            out[kind] = np.stack([pre_f, pro_f])
            out[kind + "_mask"] = np.stack([pre_m, pro_m])
        out["label"] = np.asarray(label, np.int32)
        return out

    def materialize(self, entries) -> List[Dict[str, np.ndarray]]:
        return [self.sample_for(name, label) for name, label in entries]
