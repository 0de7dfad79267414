"""Sequence pooling of the grid (cmu-mosei/run.py:318)."""

from __future__ import annotations

import torch


def mean_max_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, 2D): concat[mean over T, max over T].  Forward only
    in this slice; `torch.max(x, 1)` routes a gradient to a single winner
    the way the JAX package's `seq_max` does, for the training slice."""
    return torch.cat([x.mean(dim=1), torch.amax(x, dim=1)], dim=1)
