"""Sequence pooling of the grid (cmu-mosei/run.py:318)."""

from __future__ import annotations

import torch


def mean_max_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, 2D): concat[mean over T, max over T].  The max is
    `torch.max(x, 1)`, whose backward routes the whole gradient of a column
    to its first maximal index, as the reference's pooling and the JAX
    package's `seq_max` do; `torch.amax` would split it among tied maxima
    (an all-zero no_name slot ties every row)."""
    return torch.cat([x.mean(dim=1), torch.max(x, dim=1).values], dim=1)
