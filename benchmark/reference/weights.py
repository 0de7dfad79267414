"""Every model weight the benchmark hands the program and its reference,
made from the seed on the device in one large draw.

One `torch.Generator` on the device draws a single flat N(0, 1) vector
for all of a model's weights; each weight is a view of it, scaled by its
kind: matrices and convolution kernels by 1/√fan_in (PyTorch's default
scale), biases by 0.1, LayerNorm scales 1 + 0.1·n and shifts 0.1·n,
position tables N(0, 1), the residual gates a, b 0.5 + 0.25·n and the
score gate c 0.25·|n| (a negative c would lift masked keys above the
others), the transition tensor 0.3·n.  Every gate is away from 0, where
the program's own initialisation leaves it, so that every path of the
block carries signal.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def _scaled(name: str, n: torch.Tensor) -> torch.Tensor:
    parts = name.split(".")
    leaf = parts[-1]
    if name.endswith("position_embeddings.weight"):
        return n
    if any(p.startswith("norm") for p in parts[:-1]):
        return 1.0 + 0.1 * n if leaf == "weight" else 0.1 * n
    if leaf in ("a", "b"):
        return 0.5 + 0.25 * n
    if leaf == "c":
        return 0.25 * n.abs()
    if leaf == "trans":
        return 0.3 * n
    if n.ndim >= 2:
        return n / math.sqrt(n[0].numel())
    return 0.1 * n


def make_weights(shapes: Sequence[Tuple[str, tuple]], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device`, from `seed`."""
    sizes = [math.prod(s) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, ofs = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        out[name] = _scaled(name, flat[ofs: ofs + size].view(shape)).contiguous()
        ofs += size
    return out
