"""CMU-MOSEI's corpus layer (data/mosei.py of the JAX package): labels.txt
parsing, the sentence pairs, paragraph windows, and the pair and paragraph
sample assemblers.

The reference's semantics (cmu-mosei/run.py:57-198, others/realformer.py:
52-125), quirks included:
  * sentences group by CONSECUTIVE label lines of one paragraph: a
    paragraph split across blocks of lines forms separate groups;
  * within a group the sentences are ordered by start time, a 'no_name'
    sentinel is put first, and consecutive (previous, current) pairs are
    emitted;
  * an EXTRA sample of the tail crops is emitted when the current TEXT gave
    two crops (the reference checks only len(l_1_mask) > 1, then takes [-1]
    of every modality, cmu-mosei/run.py:182-189);
  * paragraph windows of P_LEN clips, a window kept only if its first clip
    exists (others/realformer.py:52-68).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import masking
from .sources import FeatureSource

NO_NAME = "no_name"

# labels.txt header: name,start_time,end_time,happy,sad,angry,disgust,surprise,fear,neutral
EMOTIONS = ("happy", "sad", "angry", "disgust", "surprise", "fear", "neutral")


def parse_labels(
    label_path: str, test_videos: set
) -> Tuple[List[List[str]], List[List[str]], Dict[str, List[int]]]:
    """Returns (train_pairs, test_pairs, label_dict)."""
    with open(label_path, "r") as f:
        lines = f.readlines()[1:]
    train_pairs, test_pairs = [], []
    label_dict: Dict[str, List[int]] = {}

    def flush(group_sents, group_times, para):
        ordered = [s for _, s in sorted(zip(group_times, group_sents))]
        ordered.insert(0, NO_NAME)
        dest = test_pairs if para in test_videos else train_pairs
        for i in range(len(ordered) - 1):
            dest.append([ordered[i], ordered[i + 1]])

    last_para = ""
    sents: List[str] = []
    times: List[float] = []
    for line in lines:
        parts = line.strip().split(",")
        sentence = parts[0]
        para = sentence.split("[")[0]
        if para == last_para:
            sents.append(sentence)
            times.append(float(parts[1]))
        else:
            if sents:
                flush(sents, times, last_para)
            sents, times = [sentence], [float(parts[1])]
        label_dict[sentence] = [int(x) for x in parts[3:]]
        last_para = para
    if sents:
        flush(sents, times, last_para)
    return train_pairs, test_pairs, label_dict


def paragraph_windows(videos: Sequence[str], present, p_len: int,
                      max_clips: int = 98) -> List[List[str]]:
    """Fixed windows of p_len clip ids per video; an absent clip becomes
    'no_name'; a window survives only if its first clip exists."""
    windows = []
    total = (max_clips // p_len + 1) * p_len
    for v in videos:
        window: List[str] = []
        for i in range(total):
            key = f"{v}[{i}]"
            window.append(key if key in present else NO_NAME)
            if len(window) == p_len:
                if window[0] != NO_NAME:
                    windows.append(window)
                window = []
    return windows


class PairSampleAssembler:
    """`mosei_trans` samples from (previous, current) name pairs over three
    modality sources: summary-token masking and the extra two-crop sample
    (cmu-mosei/run.py:154-198)."""

    def __init__(self, m, l_src: FeatureSource, v_src: FeatureSource,
                 a_src: FeatureSource, label_dict: Dict[str, List[int]],
                 n_label: int = 7):
        self.m = m
        self.src = {"l": l_src, "v": v_src, "a": a_src}
        self.lens = {"l": m.l_len, "v": m.v_len, "a": m.a_len}
        self.dims = {"l": m.l_dim, "v": m.v_dim, "a": m.a_dim}
        self.label_dict = label_dict
        self.n_label = n_label

    def _masked(self, kind: str, name: str):
        raw = self.src[kind].get(name)
        return masking.summary_masking(raw, self.lens[kind],
                                       is_audio=(kind == "a"))

    def samples_for_pair(self, pair) -> List[Dict[str, np.ndarray]]:
        prev_name, cur_name = pair
        label = np.asarray(self.label_dict[cur_name][: self.n_label], np.int32)
        prev, cur = {}, {}
        for kind in ("l", "v", "a"):
            if prev_name == NO_NAME:
                prev[kind] = ([np.zeros((self.lens[kind], self.dims[kind]), np.float32)],
                              [np.zeros(self.lens[kind], np.float32)])
            else:
                prev[kind] = self._masked(kind, prev_name)
            cur[kind] = self._masked(kind, cur_name)

        def build(idx_prev, idx_cur):
            s = {}
            for kind in ("l", "v", "a"):
                pf, pm = prev[kind]
                cf, cm = cur[kind]
                s[kind] = np.stack([pf[idx_prev], cf[idx_cur]])
                s[kind + "_mask"] = np.stack([pm[idx_prev], cm[idx_cur]])
            s["label"] = label
            return s

        out = []
        if len(cur["l"][1]) > 1:  # the text gave two crops: the tail sample
            out.append(build(-1, -1))
        out.append(build(0, 0))
        return out

    def materialize(self, pairs) -> List[Dict[str, np.ndarray]]:
        """The flat sample list, each sample with a `group` id (its pair's
        index): the reference tests each PAIR at batch size 1 and averages
        its head and tail crop logits into one prediction (cmu-mosei/
        run.py:462,477-480), so evaluation groups the crops."""
        samples = []
        for gid, unit in enumerate(self.materialize_units(pairs)):
            for s in unit:
                s["group"] = np.asarray(gid, np.int32)
                samples.append(s)
        return samples

    def materialize_units(self, pairs) -> List[List[Dict[str, np.ndarray]]]:
        """Per-pair crop groups, not flattened: the training folds are
        carved over PAIRS (the reference's 4096-pair folds, cmu-mosei/
        run.py:426-443), so a pair's two crops never straddle a fold
        boundary."""
        return [self.samples_for_pair(p) for p in pairs]


class ParagraphSampleAssembler:
    """`mosei_realformer` samples: (P_LEN, len, dim) stacks with a per-clip
    validity mask, each clip's features cut to their last LEN frames
    (others/realformer.py:94-125, the slice [-LEN:] at :104-106)."""

    def __init__(self, m, l_src, v_src, a_src, label_src):
        self.m = m
        self.src = {"l": l_src, "v": v_src, "a": a_src}
        self.lens = {"l": m.l_len, "v": m.v_len, "a": m.a_len}
        self.dims = {"l": m.l_dim, "v": m.v_dim, "a": m.a_dim}
        self.label_src = label_src

    def sample_for_window(self, window) -> Dict[str, np.ndarray]:
        feats = {k: [] for k in ("l", "v", "a")}
        msks = {k: [] for k in ("l", "v", "a")}
        labels, clip_mask = [], []
        for name in window:
            if name != NO_NAME:
                for kind in ("l", "v", "a"):
                    raw = self.src[kind].get(name)[-self.lens[kind]:]
                    f, mk = masking.simple_masking(raw, self.lens[kind])
                    feats[kind].append(f)
                    msks[kind].append(mk)
                # an All Labels row -> 6 binary emotions (sentiment column
                # 0 dropped, threshold > 0), others/realformer.py:84-92
                row = self.label_src.get(name)[0]
                labels.append((np.asarray(row[1:7]) > 0).astype(np.int32))
                clip_mask.append(1.0)
            else:
                for kind in ("l", "v", "a"):
                    feats[kind].append(
                        np.zeros((self.lens[kind], self.dims[kind]), np.float32))
                    msks[kind].append(np.zeros(self.lens[kind], np.float32))
                labels.append(np.zeros(6, np.int32))
                clip_mask.append(0.0)
        return {
            "l": np.stack(feats["l"]), "v": np.stack(feats["v"]),
            "a": np.stack(feats["a"]),
            "l_mask": np.stack(msks["l"]), "v_mask": np.stack(msks["v"]),
            "a_mask": np.stack(msks["a"]),
            "label": np.stack(labels),
            "clip_mask": np.asarray(clip_mask, np.float32),
        }

    def materialize(self, windows) -> List[Dict[str, np.ndarray]]:
        return [self.sample_for_window(w) for w in windows]
