"""Encoder building blocks of the `minus` family: the bias-free modality
projection and the `minus` attention block (cmu-mosei/run.py:207-262).

Module attribute names follow the reference's state-dict keys
(`unify_dimension.{linguistic,visual,acoustic}`, `proj`, `minus`, `norm1`,
`c`), so a reference or exported JAX state dict loads with
`load_state_dict` as it is.  Weights keep torch's (out, in) layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import scored_attention
from ..utils import initializers as init


class UnifyLinear(nn.Module):
    """Bias-free per-modality Linear (`apply_unify_linear`)."""

    def __init__(self, l_dim: int, v_dim: int, a_dim: int, dim: int):
        super().__init__()
        self.linguistic = nn.Linear(l_dim, dim, bias=False)
        self.visual = nn.Linear(v_dim, dim, bias=False)
        self.acoustic = nn.Linear(a_dim, dim, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.linguistic, self.visual, self.acoustic):
            init.linear_(lin, generator)

    def forward(self, l, v, a):
        return self.linguistic(l), self.visual(v), self.acoustic(a)


class MinusBlock(nn.Module):
    """`apply_block_minus`: no Q/K/V projections; after attention,
    q' = LN(Linear_{2d→d}([q ; proj(ctx)])).  Gradients flow through every
    part, the flash attention kernels included.  Dropout is not ported:
    `Grid` refuses to train a config with dropout > 0."""

    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.proj = nn.Linear(dim, dim, bias=False)
        self.minus = nn.Linear(2 * dim, dim, bias=False)
        self.norm1 = nn.LayerNorm(dim, eps=init.LN_EPS)
        self.c = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init.linear_(self.proj, generator)
        init.linear_(self.minus, generator)
        self.norm1.weight.fill_(1.0)
        self.norm1.bias.zero_()
        self.c.zero_()

    def forward(self, q, k, v, mask, scores, *, impl: str = "xla",
                emit_scores: bool = True):
        """q, k, v (B, L, dim), k and v used raw; returns (q', scores')."""
        ctx, scores = scored_attention(
            q, k, v, mask, scores, self.c, n_heads=self.n_heads, impl=impl,
            emit_scores=emit_scores)
        x = self.proj(ctx)
        # Linear(concat[q, x]) as q @ W[:d] + x @ W[d:]: the same function
        # without materializing the (B, L, 2d) concat
        d = q.shape[-1]
        w = self.minus.weight
        pre = F.linear(q, w[:, :d]) + F.linear(x, w[:, d:])
        return init.layer_norm(pre, self.norm1.weight, self.norm1.bias), scores
