"""Sequence pooling of the grid (cmu-mosei/run.py:318)."""

from __future__ import annotations

import functools

import torch


def mean_max_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, 2D): concat[mean over T, max over T].  The max is
    `torch.max(x, 1)`, whose backward routes the whole gradient of a column
    to its first maximal index, as the reference's pooling and the JAX
    package's `seq_max` do; `torch.amax` would split it among tied maxima
    (an all-zero no_name slot ties every row)."""
    return torch.cat([x.mean(dim=1), torch.max(x, dim=1).values], dim=1)


def grid_mean_max_pool(blocks_l, blocks_a, blocks_v) -> torch.Tensor:
    """The grid tail's pooling without its two concats (JAX
    `ops/pooling.grid_mean_max_pool`, selected by `grid.SPLIT_POOL`).

    Equals mean_max_pool(cat([cat(blocks_l, 2), cat(blocks_a, 2),
    cat(blocks_v, 2)], 1)) as a function: the mean over the sequence concat
    is the length-weighted sum of the per-block means, and the max is each
    block's `torch.max` over its sequence (first-winner routing within a
    block) chained through elementwise `torch.maximum` in JAX's order,
    maximum(maximum(l, a), v).  `torch.maximum` splits an exact tie's
    gradient between its operands, as `jnp.maximum` does, where
    `mean_max_pool` would route it to the earlier modality; so no
    `torch.max` over a stacked modality axis stands in for the chain."""
    ll, la, lv = (blocks_l[0].shape[1], blocks_a[0].shape[1],
                  blocks_v[0].shape[1])
    total = ll + la + lv
    means = [(ll * l.mean(dim=1) + la * a.mean(dim=1) + lv * v.mean(dim=1))
             / total for l, a, v in zip(blocks_l, blocks_a, blocks_v)]
    maxes = [functools.reduce(torch.maximum,
                              (torch.max(l, dim=1).values,
                               torch.max(a, dim=1).values,
                               torch.max(v, dim=1).values))
             for l, a, v in zip(blocks_l, blocks_a, blocks_v)]
    return torch.cat(means + maxes, dim=1)
