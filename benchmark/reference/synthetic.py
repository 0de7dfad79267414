"""The traffic's samples: frozen copies of the port's samplers, and bulk
generators of the same distributions.

The per-sample samplers below are copied unchanged from the port as it
stood when the benchmark was written, so that a later change to the
program cannot move the yardstick:

- `sanitize`, `summary_masking`, `pad_or_truncate`, `pad_or_subsample`:
  `multimodal_emotion_processing_tpu_torch/data/masking.py:28,38,106,119`;
- `raw_modality`, `mosei_pair_sample`, `robot_sample`:
  `multimodal_emotion_processing_tpu_torch/data/synthetic.py:26,37,126`.

They draw one sample at a time with NumPy (about 1.5 ms a `mosei_trans`
pair on one core), too slow for the 16,384 pairs a training cell needs
in every run's set-up.  `mosei_pairs` and `robot_samples` draw the same
distributions in a few large calls of a `torch.Generator` on the device,
then copy the result to the host once: a sample's raw lengths, features,
summary frames, crops, masks, pollution and `no_name` slots follow the
rules of the per-sample samplers (the CPU tests hold the two against each
other), though not their random streams.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

SANITIZE_VALUE = -71.0

# ---------------------------------------------------------------------------
# frozen copies (data/masking.py)


def sanitize(m: np.ndarray) -> np.ndarray:
    """inf/nan → -71.0 (cmu-mosei/run.py:107-110)."""
    m = np.asarray(m, dtype=np.float32)
    bad = ~np.isfinite(m)
    if bad.any():
        m = m.copy()
        m[bad] = SANITIZE_VALUE
    return m


def summary_masking(
    m: np.ndarray, m_len: int, *, is_audio: bool = False
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Reference `masking(m, m_len, is_bert=False, is_audio)`: lists of
    (feat, mask), one entry for short inputs, two crops for long ones."""
    m = np.asarray(m, dtype=np.float32)
    if is_audio:
        m = sanitize(m)
    summary = np.stack([m.max(axis=0), m.min(axis=0), m.mean(axis=0)], axis=0)
    feats, masks = [], []
    if len(m) >= m_len - 3:
        full_mask = np.ones(m_len, dtype=np.float32)
        head = np.concatenate([summary, m[: m_len - 3]], axis=0)
        tail = np.concatenate([summary, m[len(m) - m_len + 3:]], axis=0)
        feats.extend([head, tail])
        masks.extend([full_mask, full_mask])
    else:
        mask = np.concatenate(
            [np.ones(len(m) + 3, np.float32), np.zeros(m_len - len(m) - 3, np.float32)]
        )
        x = np.concatenate([summary, m], axis=0)
        x = np.concatenate([x, np.zeros((m_len,) + m.shape[1:], np.float32)], axis=0)[:m_len]
        feats.append(x)
        masks.append(mask)
    return feats, masks


def pad_or_truncate(m: np.ndarray, m_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-length pad (zero-fill) / head-truncate."""
    m = np.asarray(m, dtype=np.float32)
    if len(m) < m_len:
        pad = m_len - len(m)
        feat = np.concatenate([m, np.zeros((pad,) + m.shape[1:], np.float32)], axis=0)
        mask = np.concatenate([np.ones(len(m), np.float32), np.zeros(pad, np.float32)])
    else:
        feat = m[:m_len]
        mask = np.ones(m_len, dtype=np.float32)
    return feat, mask


def pad_or_subsample(m: np.ndarray, m_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Robot-demo fixed length: pad short; stride-subsample long with
    gap = len // m_len over range(0, len, gap), then truncate to m_len.
    An empty sequence gives zeros under an all-zero mask."""
    m = np.asarray(m, dtype=np.float32)
    if len(m) == 0:
        return np.zeros((m_len,) + m.shape[1:], np.float32), np.zeros(m_len, np.float32)
    if len(m) < m_len:
        return pad_or_truncate(m, m_len)
    gap = len(m) // m_len
    idx = np.arange(0, len(m), gap)[:m_len]
    return m[idx], np.ones(m_len, dtype=np.float32)


# ---------------------------------------------------------------------------
# frozen copies (data/synthetic.py)


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
            feats, masks_ = summary_masking(raw, m.l_len)
        elif kind == "v":
            raw = raw_modality(rng, m.v_len * 2, m.v_dim)
            feats, masks_ = summary_masking(raw, m.v_len)
        else:
            raw = raw_modality(rng, m.a_len * 2, m.a_dim, pollute=True)
            feats, masks_ = summary_masking(raw, m.a_len, is_audio=True)
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


def robot_sample(rng, m) -> Dict[str, np.ndarray]:
    """Robot-demo sample: one active visual resolution slot, others zero
    (robot_demo.py:63-112)."""
    d256, d512, d1024 = m.v_dims_multires
    slot = int(rng.integers(0, 3))
    dims = [d256, d512, d1024]
    raw = raw_modality(rng, m.v_len * 3, dims[slot])
    feat, v_mask = pad_or_subsample(raw, m.v_len)
    vs = [np.zeros((m.v_len, d), np.float32) for d in dims]
    vs[slot] = feat
    l, l_mask = pad_or_subsample(raw_modality(rng, m.l_len * 3, m.l_dim), m.l_len)
    a, a_mask = pad_or_subsample(raw_modality(rng, m.a_len * 3, m.a_dim), m.a_len)
    return {
        "l": l, "v256": vs[0], "v512": vs[1], "v1024": vs[2], "a": a,
        "l_mask": l_mask, "v_mask": v_mask, "a_mask": a_mask,
        "label": (rng.random(7) > 0.75).astype(np.int32),
    }


# ---------------------------------------------------------------------------
# bulk generators of the same distributions

MOSEI_KEYS = ("l", "l_mask", "v", "v_mask", "a", "a_mask", "label")
ROBOT_KEYS = ("l", "v256", "v512", "v1024", "a", "l_mask", "v_mask",
              "a_mask", "label")
CHUNK = 1024


def _summary_slot(g, n: int, length: int, dim: int, device, *,
                  pollute: bool):
    """`summary_masking(raw_modality(max_len=2·length), length)[0]` for n
    samples: each raw sequence 1..2·length frames of N(0, 1), polluted
    audio (one frame value, with probability 0.3, sanitised to -71), three
    summary frames (max, min, mean over the raw frames), then the head crop
    of length − 3 raw frames, zero-padded; the mask covers the summary
    frames and the raw frames, up to `length`."""
    max_len = 2 * length
    lens = torch.randint(1, max_len + 1, (n,), generator=g, device=device)
    raw = torch.randn(n, max_len, dim, generator=g, device=device)
    if pollute:
        hit = torch.rand(n, generator=g, device=device) < 0.3
        row = (torch.rand(n, generator=g, device=device) * lens).long()
        col = torch.randint(0, dim, (n,), generator=g, device=device)
        idx = torch.nonzero(hit).flatten()
        raw[idx, row[idx], col[idx]] = SANITIZE_VALUE
    frames = torch.arange(max_len, device=device)
    valid = (frames[None, :] < lens[:, None])[..., None]
    mx = raw.masked_fill(~valid, float("-inf")).amax(dim=1)
    mn = raw.masked_fill(~valid, float("inf")).amin(dim=1)
    mean = (raw * valid).sum(dim=1) / lens[:, None].float()
    body = raw[:, : length - 3] * valid[:, : length - 3]
    feat = torch.cat([torch.stack([mx, mn, mean], dim=1), body], dim=1)
    mask = (torch.arange(length, device=device)[None, :]
            < torch.clamp(lens + 3, max=length)[:, None]).float()
    return feat, mask


def mosei_pairs(m, n: int, seed: int, device) -> Dict[str, np.ndarray]:
    """n `mosei_pair_sample` pairs as host arrays (N, ...) keyed as the
    sampler keys them, drawn on `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {k: [] for k in MOSEI_KEYS}
    for start in range(0, n, CHUNK):
        c = min(CHUNK, n - start)
        no_name = torch.rand(c, generator=g, device=device) < 0.15
        for kind, length, dim in (("l", m.l_len, m.l_dim),
                                  ("v", m.v_len, m.v_dim),
                                  ("a", m.a_len, m.a_dim)):
            pollute = kind == "a"
            prev_f, prev_m = _summary_slot(g, c, length, dim, device,
                                           pollute=pollute)
            cur_f, cur_m = _summary_slot(g, c, length, dim, device,
                                         pollute=pollute)
            keep = (~no_name).float()
            prev_f = prev_f * keep[:, None, None]
            prev_m = prev_m * keep[:, None]
            out[kind].append(torch.stack([prev_f, cur_f], dim=1).cpu())
            out[kind + "_mask"].append(torch.stack([prev_m, cur_m], dim=1).cpu())
        out["label"].append((torch.rand(c, 7, generator=g, device=device)
                             > 0.75).int().cpu())
    return {k: torch.cat(v).numpy() for k, v in out.items()}


def _padded(g, n: int, max_raw: int, length: int, dim: int, device):
    """`pad_or_subsample(raw_modality(max_len=max_raw), length)` for n
    samples: a stride-subsampled long sequence is `length` frames of
    N(0, 1) under a full mask, a short one its frames then zeros."""
    lens = torch.randint(1, max_raw + 1, (n,), generator=g, device=device)
    rows = torch.arange(length, device=device)[None, :]
    mask = (rows < torch.clamp(lens, max=length)[:, None]).float()
    feat = torch.randn(n, length, dim, generator=g, device=device)
    return feat * mask[..., None], mask


def robot_samples(m, n: int, seed: int, device) -> Dict[str, np.ndarray]:
    """n `robot_sample` samples as host arrays (N, ...), drawn on `device`
    from `seed`: one active visual resolution slot, the other two zero."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {k: [] for k in ROBOT_KEYS}
    dims = tuple(m.v_dims_multires)
    for start in range(0, n, CHUNK // 4):
        c = min(CHUNK // 4, n - start)
        slot = torch.randint(0, 3, (c,), generator=g, device=device)
        v_mask = None
        for i, (key, d) in enumerate(zip(("v256", "v512", "v1024"), dims)):
            feat, mask = _padded(g, c, 3 * m.v_len, m.v_len, d, device)
            active = (slot == i).float()
            out[key].append((feat * active[:, None, None]).cpu())
            v_mask = mask * active[:, None] + (0 if v_mask is None else v_mask)
        out["v_mask"].append(v_mask.cpu())
        for key, length, d in (("l", m.l_len, m.l_dim), ("a", m.a_len, m.a_dim)):
            feat, mask = _padded(g, c, 3 * length, length, d, device)
            out[key].append(feat.cpu())
            out[key + "_mask"].append(mask.cpu())
        out["label"].append((torch.rand(c, 7, generator=g, device=device)
                             > 0.75).int().cpu())
    return {k: torch.cat(v).numpy() for k, v in out.items()}


def as_samples(arrays: Dict[str, np.ndarray], keys) -> List[Dict[str, np.ndarray]]:
    """The per-sample dicts a program's loaders take, as views of the bulk
    arrays, keyed in the per-sample sampler's order."""
    n = len(arrays[keys[0]])
    return [{k: arrays[k][i] for k in keys} for i in range(n)]
