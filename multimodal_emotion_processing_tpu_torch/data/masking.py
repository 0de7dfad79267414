"""Sample assembly, in numpy.

The reference's summary-token masking (cmu-mosei/run.py:104-151): audio
inf/nan become -71; three summary frames (per-feature max, min, mean over
the raw sequence) are prepended; a long sequence (len >= m_len - 3) gives
TWO crops, head- and tail-anchored, both carrying the summary frames; a
short one is right-padded with zeros and masked over its len + 3 frames.
`summary_masking_bert` is its `is_bert=True` branch (cmu-mosei/run.py:
111-130).

The RealFormer paragraph model's masking (others/realformer.py:72-82,
`simple_masking`): right-pad or truncate to a fixed length, a 1/0 mask, and
inf/nan -> -71 on every modality, after the padding.

The robot demo's fixed length (robot_demo.py:63-112): a short sequence is
zero-padded, a long one stride-subsampled (`pad_or_subsample`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SANITIZE_VALUE = -71.0


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


def summary_masking_bert(
    m: np.ndarray, m_len: int
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The reference's `is_bert=True` branch (cmu-mosei/run.py:111-130):
    the summary frames over tokens[1:-1] (CLS and SEP left out); a long
    input gives head- and tail-anchored crops that keep CLS right after the
    summary frames and SEP last.  No reference config calls it (every call
    site passes is_bert=False); it is part of the masking API."""
    m = np.asarray(m, dtype=np.float32)
    inner = m[1:-1]
    summary = np.stack([inner.max(axis=0), inner.min(axis=0), inner.mean(axis=0)])
    feats, masks = [], []
    if len(m) > m_len - 5:
        full_mask = np.ones(m_len, dtype=np.float32)
        head = np.concatenate([summary, m[0:1], m[1:m_len - 4], m[-1:]], axis=0)
        tail = np.concatenate([summary, m[0:1], m[len(m) - m_len + 4:-1], m[-1:]],
                              axis=0)
        feats.extend([head, tail])
        masks.extend([full_mask, full_mask])
    else:
        mask = np.concatenate(
            [np.ones(len(m) + 3, np.float32), np.zeros(m_len - len(m) - 3, np.float32)])
        x = np.concatenate([summary, m], axis=0)
        x = np.concatenate([x, np.zeros((m_len,) + m.shape[1:], np.float32)], axis=0)[:m_len]
        feats.append(x)
        masks.append(mask)
    return feats, masks


def simple_masking(m: np.ndarray, m_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reference realformer `masking`: pad/truncate, then sanitize."""
    m = np.asarray(m, dtype=np.float32)
    if len(m) >= m_len:
        mask = np.ones(m_len, dtype=np.float32)
    else:
        mask = np.concatenate(
            [np.ones(len(m), np.float32), np.zeros(m_len - len(m), np.float32)])
    m = np.concatenate([m, np.zeros((m_len,) + m.shape[1:], np.float32)], axis=0)[:m_len]
    return sanitize(m), mask


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
