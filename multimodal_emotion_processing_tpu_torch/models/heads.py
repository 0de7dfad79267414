"""Model heads.  Ported so far:

- the rank-3 emotion-transition head (Concat_Trans, cmu-mosei/run.py:321-339):

      last = intensity_grid(slot 0);  this = stimulation_grid(slot 1)
      fused[b, h] = Σ_{g,e} this[b,g]·last[b,e]·trans[g,e,h]
      out = Linear([this ; LN(fused)])

- the grid-only classifier of the robot demo (Multi_class,
  robot_demo.py:377-441): one grid whose classifier has a bias.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils import initializers as init
from .grid import Grid


def bilinear_transition(trans, last_feat, this_feat):
    """out[b,h] = Σ_{g,e} this[b,g]·last[b,e]·trans[g,e,h], accumulated in
    f32 and returned at this_feat's dtype."""
    acc = torch.promote_types(this_feat.dtype, torch.float32)
    out = torch.einsum("bg,be,geh->bh", this_feat.to(acc), last_feat.to(acc),
                       trans.to(acc))
    return out.to(this_feat.dtype)


class ConcatTrans(nn.Module):
    """`concat_trans`: two grids (slot 0 = previous utterance, slot 1 =
    current), the bilinear transition, LayerNorm and `out`."""

    def __init__(self, cfg):
        super().__init__()
        e = cfg.n_emotions
        self.intensity = Grid(cfg)
        self.stimulation = Grid(cfg)
        self.trans = nn.Parameter(torch.empty(e, e, e))
        self.norm1 = nn.LayerNorm(e, eps=init.LN_EPS)
        self.out = nn.Linear(2 * e, e)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.intensity.reset_parameters(generator)
        self.stimulation.reset_parameters(generator)
        init.uniform01_(self.trans, generator)
        self.norm1.weight.fill_(1.0)
        self.norm1.bias.zero_()
        init.linear_(self.out, generator)

    def forward(self, batch, *, impl: str = "xla"):
        """batch: l/v/a (B, 2, len, dm), *_mask (B, 2, len).  Returns logits
        (B, n_emotions)."""

        def run(grid, slot):
            return grid(batch["l"][:, slot], batch["v"][:, slot],
                        batch["a"][:, slot], batch["l_mask"][:, slot],
                        batch["v_mask"][:, slot], batch["a_mask"][:, slot],
                        impl=impl)

        last_feat = run(self.intensity, 0)
        this_feat = run(self.stimulation, 1)
        fused = bilinear_transition(self.trans, last_feat, this_feat)
        normed = init.layer_norm(fused, self.norm1.weight, self.norm1.bias)
        return self.out(torch.cat([this_feat, normed], dim=1))


class GridOnly(Grid):
    """`grid_only` (`apply_grid_only`): the grid itself is the model, so its
    state-dict keys carry no prefix (`unify_dimension.…`,
    `multimodal_blocks.…`, `classifier.{weight,bias}`)."""

    def __init__(self, cfg):
        super().__init__(cfg, classifier_bias=True)

    def forward(self, batch, *, impl: str = "xla"):
        """batch: l (B, Ll, l_dim), v256/v512/v1024 (B, Lv, d), a (B, La,
        a_dim) and *_mask.  Returns logits (B, n_emotions)."""
        return super().forward(
            batch["l"], (batch["v256"], batch["v512"], batch["v1024"]),
            batch["a"], batch["l_mask"], batch["v_mask"], batch["a_mask"],
            impl=impl)
