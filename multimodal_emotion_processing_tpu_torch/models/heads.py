"""Model heads, one for each reference family:

- the rank-3 emotion-transition head (Concat_Trans, cmu-mosei/run.py:321-339,
  and Ren-MME's Base_model, Ren-MME/run.py:273-292, the same head under other
  LayerNorm names):

      last = intensity_grid(slot 0);  this = stimulation_grid(slot 1)
      fused[b, h] = Σ_{g,e} this[b,g]·last[b,e]·trans[g,e,h]
      out = Linear([this ; LN(fused)])

- the text-only variant of the same head (Concat_Linear,
  rencecps/run.py:130-148): two bias-free Linears over the (previous,
  current) BERT features take the grids' place; it has no dropout site,
  as in JAX, whose head takes no rng;

- the grid-only classifier of the robot demo (Multi_class,
  robot_demo.py:377-441): one grid whose classifier has a bias;

- the recurrent paragraph head (State_Transfer, others/realformer.py:
  266-286): the paragraph axis folds into the batch for ONE grid forward
  over every clip, `classifier` splits each clip's output into (out_t1,
  feats), and a gated recurrence runs over the clips:

      α = σ(feats_t + feats_{t−1});  out_t = (1−α)·out_t1 + α·tanh(out_{t−1}·T)

Every head's `forward(batch, *, impl, generator, stacked)` passes the
dropout `torch.Generator` down in JAX's order: the intensity grid (slot 0)
before the stimulation grid, the feature grid before its head; and
`stacked` (the stacked RealFormer grid for this call, None for
`grid.REALFORMER_STACKED`) to each grid.  `concat_linear` has no grid and
accepts it for a uniform signature, as JAX's head does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import comm
from ..utils import initializers as init
from .grid import Grid
from .layers import minus_norm_names, row_parallel


def bilinear_transition(trans, last_feat, this_feat):
    """out[b,h] = Σ_{g,e} this[b,g]·last[b,e]·trans[g,e,h], accumulated in
    f32 and returned at this_feat's dtype."""
    acc = torch.promote_types(this_feat.dtype, torch.float32)
    out = torch.einsum("bg,be,geh->bh", this_feat.to(acc), last_feat.to(acc),
                       trans.to(acc))
    return out.to(this_feat.dtype)


class ConcatTrans(nn.Module):
    """`concat_trans`: two grids (slot 0 = previous utterance, slot 1 =
    current), the bilinear transition, LayerNorm and `out`.  The LayerNorm
    is `norm1` (Concat_Trans, cmu-mosei/run.py:321-339), or `norm3` under
    the names of Ren-MME's Base_model (Ren-MME/run.py:273-292), which the
    `linear_ln` unify selects (`layers.minus_norm_names`)."""

    def __init__(self, cfg):
        super().__init__()
        e = cfg.n_emotions
        self.intensity = Grid(cfg, out="classifier")
        self.stimulation = Grid(cfg, out="classifier")
        self.trans = nn.Parameter(torch.empty(e, e, e))
        self.norm_name = minus_norm_names(cfg)[1]
        setattr(self, self.norm_name, nn.LayerNorm(e, eps=init.LN_EPS))
        self.out = nn.Linear(2 * e, e)

    @property
    def norm(self) -> nn.LayerNorm:
        return getattr(self, self.norm_name)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.intensity.reset_parameters(generator)
        self.stimulation.reset_parameters(generator)
        init.uniform01_(self.trans, generator)
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()
        init.linear_(self.out, generator)

    def forward(self, batch, *, impl: str = "xla", generator=None,
                stacked=None):
        """batch: l/v/a (B, 2, len, dm), *_mask (B, 2, len).  Returns logits
        (B, n_emotions)."""

        def run(grid, slot):
            return grid(batch["l"][:, slot], batch["v"][:, slot],
                        batch["a"][:, slot], batch["l_mask"][:, slot],
                        batch["v_mask"][:, slot], batch["a_mask"][:, slot],
                        impl=impl, generator=generator, stacked=stacked)

        last_feat = run(self.intensity, 0)
        this_feat = run(self.stimulation, 1)
        fused = bilinear_transition(self.trans, last_feat, this_feat)
        normed = init.layer_norm(fused, self.norm.weight, self.norm.bias)
        return self.out(torch.cat([this_feat, normed], dim=1))


class ConcatLinear(nn.Module):
    """`concat_linear` (Concat_Linear, rencecps/run.py:130-148): bias-free
    Linears `intensity` (previous utterance) and `stimulation` (current)
    from dim to n_emotions, the bilinear transition, LayerNorm `norm` and
    `out`.  No dropout site: JAX's head takes no rng, whatever the
    config's rate says."""

    def __init__(self, cfg):
        super().__init__()
        e = cfg.n_emotions
        self.intensity = nn.Linear(cfg.dim, e, bias=False)
        self.stimulation = nn.Linear(cfg.dim, e, bias=False)
        self.trans = nn.Parameter(torch.empty(e, e, e))
        self.norm = nn.LayerNorm(e, eps=init.LN_EPS)
        self.out = nn.Linear(2 * e, e)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init.linear_(self.intensity, generator)
        init.linear_(self.stimulation, generator)
        init.uniform01_(self.trans, generator)
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()
        init.linear_(self.out, generator)

    def forward(self, batch, *, impl: str = "xla", generator=None,
                stacked=None):
        """batch: feat (B, 2, dim), the (previous, current) features.
        Returns logits (B, n_emotions); `impl`, `generator` and `stacked`
        are unused (no attention, no dropout site, no grid)."""
        feat = batch["feat"]
        last_feat = self.intensity(feat[:, 0])
        this_feat = self.stimulation(feat[:, 1])
        fused = bilinear_transition(self.trans, last_feat, this_feat)
        normed = init.layer_norm(fused, self.norm.weight, self.norm.bias)
        return self.out(torch.cat([this_feat, normed], dim=1))


class GridOnly(Grid):
    """`grid_only` (`apply_grid_only`): the grid itself is the model, so its
    state-dict keys carry no prefix (`unify_dimension.…`,
    `multimodal_blocks.…`, `classifier.{weight,bias}`)."""

    def __init__(self, cfg):
        super().__init__(cfg, out="classifier_bias")

    def forward(self, batch, *, impl: str = "xla", generator=None,
                stacked=None):
        """batch: l (B, Ll, l_dim), v256/v512/v1024 (B, Lv, d), a (B, La,
        a_dim) and *_mask.  Returns logits (B, n_emotions)."""
        return super().forward(
            batch["l"], (batch["v256"], batch["v512"], batch["v1024"]),
            batch["a"], batch["l_mask"], batch["v_mask"], batch["a_mask"],
            impl=impl, generator=generator, stacked=stacked)


def state_transfer_recurrence(trans, prev_out, prev_feats, out_t1, feats):
    """One step of the gated recurrence (others/realformer.py:280-282):
    α = σ(feats_t + feats_{t−1}); out = (1−α)·out_t1 + α·tanh(out_{t−1}·T)."""
    alpha = torch.sigmoid(feats + prev_feats)
    return (1.0 - alpha) * out_t1 + alpha * torch.tanh(prev_out @ trans)


class StateTransfer(nn.Module):
    """`state_transfer`: the `feature` grid, `classifier` (dim → 2E, with
    bias) and the transition matrix `trans` (E, E) of the recurrence.
    Under tensor parallelism (`tp`, parallel/mesh.shard_params) the
    classifier is row-parallel (its input axis sharded, as in JAX)."""

    tp = None

    def __init__(self, cfg):
        super().__init__()
        e = cfg.n_emotions
        self.n_emotions = e
        self.feature = Grid(cfg, out="feature")
        self.classifier = nn.Linear(cfg.dim, 2 * e)
        self.trans = nn.Parameter(torch.empty(e, e))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.feature.reset_parameters(generator)
        init.linear_(self.classifier, generator)
        init.uniform01_(self.trans, generator)

    def clip(self, l, v, a, l_mask, v_mask, a_mask, *, impl: str = "xla",
             generator=None, stacked=None):
        """The per-clip half (`state_transfer_clip`): grid → feature →
        classifier, split into (out_t1, feats), each (N, E), for
        clip-flattened inputs (N, len, dm) and masks (N, len)."""
        feat = self.feature(l, v, a, l_mask, v_mask, a_mask, impl=impl,
                            generator=generator, stacked=stacked)
        if self.tp is not None:
            cls = row_parallel(comm.split_to(feat, self.tp.group, -1),
                               self.classifier.weight, self.classifier.bias,
                               self.tp)
        else:
            cls = self.classifier(feat)
        return cls[..., :self.n_emotions], cls[..., self.n_emotions:]

    def forward(self, batch, *, impl: str = "xla", generator=None,
                stacked=None):
        """batch: l/v/a (B, P, len, dm), *_mask (B, P, len).  Returns the
        per-clip logits (B, P, E)."""
        b, plen = batch["l"].shape[:2]

        def flat(x):
            return x.reshape((b * plen,) + tuple(x.shape[2:]))

        out_t1, feats = self.clip(
            *(flat(batch[k]) for k in ("l", "v", "a", "l_mask", "v_mask",
                                       "a_mask")), impl=impl,
            generator=generator, stacked=stacked)
        out_t1 = out_t1.reshape(b, plen, -1)
        feats = feats.reshape(b, plen, -1)
        outs = [out_t1[:, 0]]
        for t in range(1, plen):
            outs.append(state_transfer_recurrence(
                self.trans, outs[-1], feats[:, t - 1], out_t1[:, t],
                feats[:, t]))
        return torch.stack(outs, dim=1)
