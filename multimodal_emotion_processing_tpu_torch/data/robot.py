"""The robot demo's corpus layer (data/robot.py of the JAX package):
multi-resolution pickled video features, padded or subsampled audio and
text, the Ren -> MOSEI label mapping, and the label-matched text
substitution (robot_demo.py:45-284).

The reference's quirks, kept:
  * a video .pk is a list of per-frame vectors of mixed resolutions (1024,
    512, 256); the MAJORITY resolution wins, ties go 1024 > 512 > 256 (the
    reference's >= chain, robot_demo.py:80-85); its sequence fills its
    resolution's slot and the other two slots are zeros; an empty pickle
    gives zeros;
  * Ren sentence labels map onto the 7-character MOSEI label string:
    Sorrow -> sad, Anger -> angry, Hate -> disgust, Surprise -> surprise,
    Anxiety -> fear, {Love, Joy, Expect} -> happy, all zero -> neutral
    (robot_demo.py:184-204);
  * each MOSEI clip's TEXT is replaced by a rotating same-label Ren
    sentence, label '0000001' when its own has none (robot_demo.py:263-276);
  * Ren sentences that are not Chinese are left out, by a lexicographic
    test of each whole word (robot_demo.py:157-162,180-182).
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Dict, List, Tuple

import numpy as np

from . import masking
from .rencecps import _EMPTY_TEXT, SKIP_DOCS, parse_xml_ids


def contains_chinese(words) -> bool:
    """The reference's test (robot_demo.py:157-162): each WORD compared
    lexicographically with the CJK range, in effect a check of its first
    character, not a scan of every character."""
    return any("一" <= w <= "鿿" for w in words)


def load_video_multires(path: str, v_len: int,
                        dims=(256, 512, 1024)) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (feat_256, feat_512, feat_1024, mask)."""
    with open(path, "rb") as f:
        feat_list = pickle.load(f)
    zeros = [np.zeros((v_len, d), np.float32) for d in dims]
    if len(feat_list) == 0:
        return zeros[0], zeros[1], zeros[2], np.zeros(v_len, np.float32)
    by_res = {d: [x for x in feat_list if x.shape[0] == d] for d in dims}
    # the reference's >= chain: the higher resolution wins a tie
    res = max(sorted(dims, reverse=True), key=lambda d: len(by_res[d]))
    chosen = by_res[res]
    if not chosen:  # frames, but none of a slot's resolution: zeros
        return zeros[0], zeros[1], zeros[2], np.zeros(v_len, np.float32)
    feat, mask = masking.pad_or_subsample(np.stack(chosen), v_len)
    out = {d: np.zeros((v_len, d), np.float32) for d in dims}
    out[res] = feat
    return out[dims[0]], out[dims[1]], out[dims[2]], mask


def ren_to_mosei_labels(txt_path: str) -> Tuple[List[str], List[int]]:
    """One cet_N.txt -> (7-character MOSEI label strings, the skipped
    sentences' counters); empty and non-Chinese sentences are skipped."""
    labels, skipped = [], []
    with open(txt_path, "r") as f:
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
            words = [w.split("/")[0] for w in line.strip().split(":")[2].split("  ")]
            if not contains_chinese(words):
                skipped.append(count)
                continue
            ren = [0] * 8  # Love,Anxiety,Sorrow,Joy,Expect,Hate,Anger,Surprise
            for idx, x in enumerate(fields[1].split(",")[:8]):
                if x != "0.0":
                    ren[idx] = 1
            mosei = ["0"] * 7  # happ sadn ange disg surp fear neut
            if sum(ren) == 0:
                mosei[6] = "1"
            else:
                if ren[2]:
                    mosei[1] = "1"
                if ren[6]:
                    mosei[2] = "1"
                if ren[5]:
                    mosei[3] = "1"
                if ren[7]:
                    mosei[4] = "1"
                if ren[1]:
                    mosei[5] = "1"
                if ren[0] or ren[3] or ren[4]:
                    mosei[0] = "1"
            labels.append("".join(mosei))
    return labels, skipped


def ren_label_name_dict(txt_dir: str, xml_dir: str) -> Dict[str, List[str]]:
    """MOSEI label string -> a shuffled list of Ren sentence names
    (robot_demo.py:224-253), over cet_1..cet_1487."""
    rng = random.Random(0)
    table: Dict[str, List[str]] = {}
    for i in range(1, 1488):
        if i in SKIP_DOCS:
            continue
        labels, skipped = ren_to_mosei_labels(os.path.join(txt_dir, f"cet_{i}.txt"))
        paras, sents = parse_xml_ids(os.path.join(xml_dir, f"cet_{i}.xml"), skipped)
        for j in range(len(paras)):
            table.setdefault(labels[j], []).append(f"{i}_{paras[j]}_{sents[j]}")
    for key in table:
        rng.shuffle(table[key])
    return table


class SubstitutionSampler:
    """Picks a rotating same-label Ren text, the neutral one when a label
    has none (robot_demo.py:263-276)."""

    NEUTRAL = "0000001"

    def __init__(self, table: Dict[str, List[str]]):
        self.table = {k: list(v) for k, v in table.items()}

    def pick(self, mosei_label: str) -> str:
        key = mosei_label if mosei_label in self.table else self.NEUTRAL
        lst = self.table[key]
        name = lst[0]
        lst.append(name)
        self.table[key] = lst[1:]
        return name


class RobotAssembler:
    """robot_demo samples: the Ren text substituted by label, the MOSEI
    clip's multi-resolution video and audio (robot_demo.py:256-284)."""

    def __init__(self, m, video_dir: str, audio_src, ren_text_src,
                 label_dict: Dict[str, List], substitution: SubstitutionSampler):
        """A clip's video and audio are a function of its name alone (only
        the TEXT changes from epoch to epoch), while the reference re-reads
        every .pk and .npy each epoch (robot_demo.py:258-284).  They are
        cached: the winning resolution's block and mask (the two zero slots
        are rebuilt on demand), so the epochs after the first read no video
        or audio."""
        self.m = m
        self.video_dir = video_dir
        self.audio_src = audio_src
        self.ren_text_src = ren_text_src
        self.label_dict = label_dict
        self.sub = substitution
        self._video_cache: Dict[str, tuple] = {}
        self._audio_cache: Dict[str, tuple] = {}

    def _video_for(self, name: str):
        cached = self._video_cache.get(name)
        dims = self.m.v_dims_multires
        if cached is not None:
            res, feat, mask = cached
            out = {d: (feat if d == res
                       else np.zeros((self.m.v_len, d), np.float32))
                   for d in dims}
            return out[dims[0]], out[dims[1]], out[dims[2]], mask
        v = load_video_multires(
            os.path.join(self.video_dir, name + ".pk"), self.m.v_len, dims=dims)
        slots = v[:3]
        # the non-zero slot won; an all-zero pickle keeps slot 0
        res_i = next((i for i, x in enumerate(slots) if x.any()), 0)
        self._video_cache[name] = (dims[res_i], slots[res_i], v[3])
        return v

    def _audio_for(self, name: str):
        cached = self._audio_cache.get(name)
        if cached is not None:
            return cached
        a = masking.pad_or_subsample(self.audio_src.get(name), self.m.a_len)
        self._audio_cache[name] = a
        return a

    def sample_for(self, name: str) -> Dict[str, np.ndarray]:
        label = [int(x) for x in self.label_dict[name]]
        ren_name = self.sub.pick("".join(str(x) for x in label))
        l, l_mask = masking.pad_or_subsample(self.ren_text_src.get(ren_name),
                                             self.m.l_len)
        v256, v512, v1024, v_mask = self._video_for(name)
        a, a_mask = self._audio_for(name)
        return {
            "l": l, "v256": v256, "v512": v512, "v1024": v1024, "a": a,
            "l_mask": l_mask, "v_mask": v_mask, "a_mask": a_mask,
            "label": np.asarray(label[:7], np.int32),
        }

    def materialize(self, names) -> List[Dict[str, np.ndarray]]:
        return [self.sample_for(n) for n in names]

    def epoch_materialize(self, names, base_table: Dict[str, List[str]],
                          epoch: int, seed: int = 0) -> List[Dict[str, np.ndarray]]:
        """One epoch's substitution: the reference rebuilds and reshuffles
        its label -> names table in every data_loader call (robot_demo.py:
        258), so each epoch pairs the clips with other same-label Ren
        texts.  A Batcher's `resample` hook:
            Batcher(asm.materialize(names), bs,
                    resample=lambda e: asm.epoch_materialize(names, table, e))
        A tuple of ints hashes alike in every process, so the draws do not
        depend on PYTHONHASHSEED."""
        rng = random.Random((seed, epoch).__hash__())
        table = {k: list(v) for k, v in base_table.items()}
        for key in table:
            rng.shuffle(table[key])
        self.sub = SubstitutionSampler(table)
        return self.materialize(names)
