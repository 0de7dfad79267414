"""Parameter initializers matching the reference's PyTorch-default
distributions, drawn from an explicit `torch.Generator`.

The reference relies on torch defaults: Linear and Conv1d weights and
biases are U(-1/sqrt(fan_in), 1/sqrt(fan_in)), nn.Embedding is N(0, 1),
LayerNorm is ones/zeros, the transition tensor is torch.rand (U[0, 1)), the
residual gates start at 0.  Weights keep torch's (out, in) and (out, in, k)
layouts, so state dicts carry the reference's key names and shapes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


@torch.no_grad()
def linear_(layer, generator: torch.Generator) -> None:
    """torch.nn.Linear (and Conv1d) default init, from `generator`: weight
    and bias, where the layer has one, U(±1/sqrt(fan_in)) with fan_in =
    in_features (in_channels × kernel size)."""
    fan_in = layer.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    layer.weight.uniform_(-bound, bound, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def embedding_(emb: torch.nn.Embedding, generator: torch.Generator) -> None:
    """torch.nn.Embedding default init: N(0, 1)."""
    emb.weight.normal_(0.0, 1.0, generator=generator)


@torch.no_grad()
def uniform01_(t: torch.Tensor, generator: torch.Generator) -> None:
    """torch.rand: U[0, 1)."""
    t.uniform_(0.0, 1.0, generator=generator)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with torch semantics: biased variance,
    eps inside the square root (initializers.py:57-61 of the JAX package)."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
