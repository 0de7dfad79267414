"""Sample assembly: the reference's summary-token masking
(cmu-mosei/run.py:104-151), in numpy.

Audio inf/nan become -71; three summary frames (per-feature max, min, mean
over the raw sequence) are prepended; a long sequence (len >= m_len - 3)
gives TWO crops, head- and tail-anchored, both carrying the summary frames;
a short one is right-padded with zeros and masked over its len + 3 frames.
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
