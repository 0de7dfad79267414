"""Shape- and dtype-faithful synthetic requests for the five families.

`mosei_trans` samples carry the real loader's quirks: variable raw lengths
(both the pad and the two-crop paths of summary masking), inf/nan in audio,
and `no_name` pairs whose previous utterance is all zeros with an all-zero
mask (cmu-mosei/run.py:154-198).  `mosei_realformer` samples are P-clip
paragraph windows whose clips past a random count are all zero, with a
per-clip validity mask `clip_mask`.  `ren_mme` samples are (pre, pro)
utterance pairs padded or truncated to the fixed lengths.  `rencecps`
samples are (previous, current) pairs of flattened BERT features, the
previous one all zero for a `no_name` pair.  `robot_demo` samples fill one
of the three visual resolution slots and leave the other two zero.  The
same seed gives the same samples as the JAX package's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..configs import family
from . import masking


def raw_modality(rng, max_len: int, dim: int, *, pollute: bool = False) -> np.ndarray:
    """A raw variable-length feature sequence (1..max_len frames)."""
    n = int(rng.integers(1, max_len + 1))
    x = rng.standard_normal((n, dim)).astype(np.float32)
    if pollute and rng.random() < 0.3:
        i = rng.integers(0, n)
        j = rng.integers(0, dim)
        x[i, j] = np.inf if rng.random() < 0.5 else np.nan
    return x


def mosei_pair_sample(rng, m, *, no_name_prob: float = 0.15) -> Dict[str, np.ndarray]:
    """One (previous, current) sentence-pair sample with summary masking."""

    def one(kind: str):
        if kind == "l":
            raw = raw_modality(rng, m.l_len * 2, m.l_dim)
            feats, masks_ = masking.summary_masking(raw, m.l_len)
        elif kind == "v":
            raw = raw_modality(rng, m.v_len * 2, m.v_dim)
            feats, masks_ = masking.summary_masking(raw, m.v_len)
        else:
            raw = raw_modality(rng, m.a_len * 2, m.a_dim, pollute=True)
            feats, masks_ = masking.summary_masking(raw, m.a_len, is_audio=True)
        return feats[0], masks_[0]

    no_name = rng.random() < no_name_prob
    sample = {}
    for kind, length, dim in (("l", m.l_len, m.l_dim), ("v", m.v_len, m.v_dim),
                              ("a", m.a_len, m.a_dim)):
        if no_name:
            prev_f = np.zeros((length, dim), np.float32)
            prev_m = np.zeros(length, np.float32)
        else:
            prev_f, prev_m = one(kind)
        cur_f, cur_m = one(kind)
        sample[kind] = np.stack([prev_f, cur_f])
        sample[kind + "_mask"] = np.stack([prev_m, cur_m])
    sample["label"] = (rng.random(7) > 0.75).astype(np.int32)
    return sample


def realformer_paragraph_sample(rng, m) -> Dict[str, np.ndarray]:
    """One p_len-clip paragraph window with its per-clip validity mask
    (others/realformer.py:94-125)."""
    p = m.p_len
    n_valid = int(rng.integers(1, p + 1))
    keys = ("l", "v", "a", "l_mask", "v_mask", "a_mask", "label")
    cols = {k: [] for k in keys}
    clip_mask = []
    for t in range(p):
        if t < n_valid:
            l, lm = masking.simple_masking(raw_modality(rng, m.l_len * 2, m.l_dim), m.l_len)
            v, vm = masking.simple_masking(raw_modality(rng, m.v_len * 2, m.v_dim), m.v_len)
            a, am = masking.simple_masking(
                raw_modality(rng, m.a_len * 2, m.a_dim, pollute=True), m.a_len)
            label = (rng.random(6) > 0.75).astype(np.int32)
        else:
            l, v, a = (np.zeros((n, d), np.float32) for n, d in (
                (m.l_len, m.l_dim), (m.v_len, m.v_dim), (m.a_len, m.a_dim)))
            lm, vm, am = (np.zeros(n, np.float32) for n in (m.l_len, m.v_len, m.a_len))
            label = np.zeros(6, np.int32)
        for k, x in zip(keys, (l, v, a, lm, vm, am, label)):
            cols[k].append(x)
        clip_mask.append(float(t < n_valid))
    sample = {k: np.stack(x) for k, x in cols.items()}
    sample["clip_mask"] = np.asarray(clip_mask, np.float32)
    return sample


def ren_mme_sample(rng, m) -> Dict[str, np.ndarray]:
    """One (pre, pro) utterance pair (Ren-MME/run.py:123-148); the
    loader-level R-Drop duplication is the batcher's job, not the sample's."""
    sample = {}
    for kind, length, dim in (("l", m.l_len, m.l_dim), ("v", m.v_len, m.v_dim),
                              ("a", m.a_len, m.a_dim)):
        pre, pre_m = masking.pad_or_truncate(raw_modality(rng, length * 2, dim),
                                             length)
        pro, pro_m = masking.pad_or_truncate(raw_modality(rng, length * 2, dim),
                                             length)
        sample[kind] = np.stack([pre, pro])
        sample[kind + "_mask"] = np.stack([pre_m, pro_m])
    sample["label"] = (rng.random(9) > 0.7).astype(np.int32)
    return sample


def rencecps_sample(rng, m, *, no_name_prob: float = 0.1) -> Dict[str, np.ndarray]:
    """(previous, current) flattened 2304-d BERT features
    (rencecps/run.py:111-127); a `no_name` previous utterance is all zero,
    and a sample without any label takes the neutral one (index 8,
    rencecps/run.py:48-49)."""
    prev = (np.zeros(m.dim, np.float32) if rng.random() < no_name_prob
            else rng.standard_normal(m.dim).astype(np.float32))
    cur = rng.standard_normal(m.dim).astype(np.float32)
    label = (rng.random(9) > 0.7).astype(np.int32)
    if label.sum() == 0:
        label[8] = 1
    return {"feat": np.stack([prev, cur]), "label": label}


def robot_sample(rng, m) -> Dict[str, np.ndarray]:
    """Robot-demo sample: one active visual resolution slot, others zero
    (robot_demo.py:63-112)."""
    d256, d512, d1024 = m.v_dims_multires
    slot = int(rng.integers(0, 3))
    dims = [d256, d512, d1024]
    raw = raw_modality(rng, m.v_len * 3, dims[slot])
    feat, v_mask = masking.pad_or_subsample(raw, m.v_len)
    vs = [np.zeros((m.v_len, d), np.float32) for d in dims]
    vs[slot] = feat
    l, l_mask = masking.pad_or_subsample(raw_modality(rng, m.l_len * 3, m.l_dim), m.l_len)
    a, a_mask = masking.pad_or_subsample(raw_modality(rng, m.a_len * 3, m.a_dim), m.a_len)
    return {
        "l": l, "v256": vs[0], "v512": vs[1], "v1024": vs[2], "a": a,
        "l_mask": l_mask, "v_mask": v_mask, "a_mask": a_mask,
        "label": (rng.random(7) > 0.75).astype(np.int32),
    }


SAMPLERS = {"mosei_trans": mosei_pair_sample,
            "mosei_realformer": realformer_paragraph_sample,
            "rencecps": rencecps_sample,
            "ren_mme": ren_mme_sample,
            "robot_demo": robot_sample}

def lognormal_lengths(rng, n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """n lengths, lognormal with `median` and `sigma`, rounded and cut to
    [lo, hi]."""
    x = np.exp(np.log(median) + sigma * rng.standard_normal(n))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


#: a transcript pair's lengths in tokens: the transcript up to and including
#: the pair's two sentences, and each sentence (median, sigma, lo, hi)
TRANSCRIPT_LENGTHS = (384.0, 0.9, 64, 4096)
SENTENCE_LENGTHS = (24.0, 0.5, 8, 64)


def transcript_pair_sample(rng, m, *, vocab_size: int,
                           max_tokens: int = TRANSCRIPT_LENGTHS[3],
                           no_name_prob: float = 0.15) -> Dict[str, np.ndarray]:
    """A `mosei_pair_sample` whose text is token ids for a language-model
    tower (models/tower.TowerFeed) in place of word features: `tokens`
    (max_tokens,) int32, uniform over the vocabulary, the first `n_tokens`
    real (the clip's transcript up to and including the pair's sentences,
    `TRANSCRIPT_LENGTHS`), and `sentences` (2, 2) int32, the previous and
    the current sentence's [start, end) at its end (`SENTENCE_LENGTHS`).
    Video and audio are the pair sampler's; `l` / `l_mask` are left out."""
    pair = mosei_pair_sample(rng, dataclasses.replace(m, l_dim=1),
                             no_name_prob=no_name_prob)
    del pair["l"], pair["l_mask"]
    med, sig, lo, hi = TRANSCRIPT_LENGTHS
    n = int(lognormal_lengths(rng, 1, med, sig, lo, min(hi, max_tokens))[0])
    prev, cur = (int(x) for x in lognormal_lengths(rng, 2, *SENTENCE_LENGTHS))
    n = min(max(n, prev + cur), max_tokens)
    tokens = np.zeros(max_tokens, np.int32)
    tokens[:n] = rng.integers(0, vocab_size, size=n)
    pair["tokens"] = tokens
    pair["n_tokens"] = np.int32(n)
    pair["sentences"] = np.array([[n - cur - prev, n - cur], [n - cur, n]],
                                 np.int32)
    return pair


def synthetic_dataset(config_name: str, m, n: int, seed: int = 0) -> List[Dict]:
    rng = np.random.default_rng(seed)
    sampler = SAMPLERS.get(family(config_name))
    if sampler is None:
        raise NotImplementedError(
            f"no synthetic sampler for {config_name!r} in the port yet")
    return [sampler(rng, m) for _ in range(n)]
