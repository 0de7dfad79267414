"""Parameter initializers matching the reference's PyTorch-default
distributions, drawn from an explicit `torch.Generator`.

The reference relies on torch defaults: Linear weights and biases are
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), LayerNorm is ones/zeros, the transition
tensor is torch.rand (U[0, 1)), the residual gates start at 0.  Weights keep
torch's (out, in) layout, so state dicts carry the reference's key names and
shapes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


@torch.no_grad()
def linear_(layer: torch.nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear default init, from `generator`."""
    fan_in = layer.weight.shape[1]
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    layer.weight.uniform_(-bound, bound, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def uniform01_(t: torch.Tensor, generator: torch.Generator) -> None:
    """torch.rand: U[0, 1)."""
    t.uniform_(0.0, 1.0, generator=generator)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with torch semantics: biased variance,
    eps inside the square root (initializers.py:57-61 of the JAX package)."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
