"""The 9-stream cross-modal attention grid (Multi_ATTN, cmu-mosei/run.py:
265-319).

For modalities L, V, A nine directed streams (ll, lv, la, vv, vl, va, aa, al,
av) each run a chain of `n_layers` blocks that thread one score lineage:
block i emits its scores for block i + 1 only when i < n_layers - 1.  Every
layer's output is collected, the outputs concatenate on the feature axis per
target modality, the three targets concatenate on the sequence axis in the
order [l, a, v], and mean+max pooling feeds the head (`apply_grid`'s
unrolled path; its merged and stacked fast paths are off by default in the
JAX package and are not ported).  The streams have distinct weights and
(Lq, Lkv) shapes, so they are unrolled.

Three ported variants, by the head on the pooled feature (`out`, as
`apply_grid_head` names it):
- "classifier": the `minus` grid (linear unify, with Ren-MME's shared
  LayerNorm under `linear_ln`, minus blocks, every layer's output
  collected, a bias-free classifier, cmu-mosei/run.py:265-319);
- "classifier_bias": the robot grid (multi-resolution conv unify, position
  embeddings, RealFormer blocks, every layer collected, a classifier with
  bias, robot_demo.py:377-441);
- "feature": the paragraph model's grid (conv unify, position embeddings,
  RealFormer blocks, only each stream's last block collected, then
  Drop(ReLU(LayerNorm(Linear_{6·dim→dim}))), others/realformer.py:211-264).

In training with dropout > 0 the dropout masks come from the one
`torch.Generator` passed to `forward`, drawn in `apply_grid`'s order: the
unify's sites, then each stream's blocks in `STREAMS` order, layer by
layer, then the feature head's.

`ModelConfig.remat` (JAX grid.py:404-423, `jax.checkpoint` of each block
call): while gradients are recorded, each block runs under
`torch.utils.checkpoint` (non-reentrant), so that only its inputs and
outputs are kept for the backward and its insides (the attention's
saved tensors, the epilogue's activations) are recomputed there; its
kernels then launch a second time in the backward.  The recompute must
see what the forward saw: the block's keep masks are drawn before the
checkpointed region, in the block's own order, and handed in
(`layers.DrawnMasks`), which an explicit generator would not give it,
and its parameters go in as inputs (`rematerialized_block`).  The values
and gradients are those of the run without remat.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.pooling import mean_max_pool
from ..utils import initializers as init
from .layers import (DrawnMasks, MinusBlock, PositionEmbedding,
                     RealformerBlock, UnifyConv, UnifyConvMultires,
                     UnifyLinear, active_rate, block_keep_masks, dropout,
                     minus_norm_names)

# (stream key, query modality, key/value modality) — reference order.
STREAMS = (
    ("ll", "l", "l"), ("lv", "l", "v"), ("la", "l", "a"),
    ("vv", "v", "v"), ("vl", "v", "l"), ("va", "v", "a"),
    ("aa", "a", "a"), ("al", "a", "l"), ("av", "a", "v"),
)
# which list each stream's outputs land in (l_list / v_list / a_list)
TARGET = {"ll": "l", "lv": "l", "la": "l",
          "vv": "v", "vl": "v", "va": "v",
          "aa": "a", "al": "a", "av": "a"}


POSITIONS = (("l", "linguistic_position"), ("v", "visual_position"),
             ("a", "acoustic_position"))


def rematerialized_block(block, q, kv, mask, scores, *, impl: str,
                         emit_scores: bool, generator):
    """`block(q, kv, kv, mask, scores)` under `torch.utils.checkpoint`, its
    keep masks drawn here, outside the checkpointed region.  The block's
    parameters as the forward sees them go in as inputs and the block runs
    on them (`torch.func.functional_call`): under bf16 compute the forward
    sees bf16 copies (engine.batch_loss), which are gone from the module by
    the time the backward recomputes.  No default generator's state is
    saved (`preserve_rng_state=False`): no mask comes from one, and reading
    it is not allowed inside a CUDA-graph capture."""
    keeps = block_keep_masks(block, q, generator)
    params = dict(block.named_parameters())

    def call(q, kv, mask, scores, params, *keeps):
        return torch.func.functional_call(
            block, params, (q, kv, kv, mask, scores),
            {"impl": impl, "emit_scores": emit_scores,
             "generator": DrawnMasks(keeps)})

    return checkpoint(call, q, kv, mask, scores, params, *keeps,
                      use_reentrant=False, preserve_rng_state=False)


class Grid(nn.Module):
    """Unify projection (+ position embeddings), 9 * n_layers blocks and the
    head `out`; block `n_layers * s + i` is layer i of stream s.  The config
    picks the unify (`linear`, `linear_ln`, `conv` or `conv_multires`) and
    the block (`minus` or `realformer`)."""

    def __init__(self, cfg, *, out: str = "classifier"):
        super().__init__()
        self.out = out
        self.n_layers = cfg.n_layers
        self.dropout = cfg.dropout
        self.remat = cfg.remat
        if cfg.unify in ("linear", "linear_ln"):
            self.unify_dimension = UnifyLinear(
                cfg.l_dim, cfg.v_dim, cfg.a_dim, cfg.dim,
                shared_ln=cfg.unify == "linear_ln")
        elif cfg.unify == "conv":
            self.unify_dimension = UnifyConv(cfg.l_dim, cfg.v_dim, cfg.a_dim,
                                             cfg.dim, dropout=cfg.dropout)
        elif cfg.unify == "conv_multires":
            self.unify_dimension = UnifyConvMultires(
                cfg.l_dim, cfg.v_dims_multires, cfg.a_dim, cfg.dim,
                dropout=cfg.dropout)
        else:
            raise NotImplementedError(f"unify {cfg.unify!r} is not ported yet")
        self.positions = cfg.use_position_embedding
        if self.positions:
            for m, attr in POSITIONS:
                setattr(self, attr, PositionEmbedding(
                    getattr(cfg, f"{m}_len"), cfg.dim))
        if cfg.block == "minus":
            blocks = (MinusBlock(cfg.dim, cfg.n_heads, dropout=cfg.dropout,
                                 norm=minus_norm_names(cfg)[0])
                      for _ in range(9 * cfg.n_layers))
        elif cfg.block == "realformer":
            blocks = (RealformerBlock(cfg.dim, cfg.n_heads, cfg.ffn,
                                      dropout=cfg.dropout)
                      for _ in range(9 * cfg.n_layers))
        else:
            raise NotImplementedError(f"block {cfg.block!r} is not ported yet")
        self.multimodal_blocks = nn.ModuleList(blocks)
        if out == "feature":
            self.fully_connected = nn.Linear(cfg.dim * 6, cfg.dim)
            self.normalization = nn.LayerNorm(cfg.dim, eps=init.LN_EPS)
        else:
            self.classifier = nn.Linear(cfg.dim * 6 * cfg.n_layers,
                                        cfg.n_emotions,
                                        bias=out == "classifier_bias")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.unify_dimension.reset_parameters(generator)
        if self.positions:
            for _, attr in POSITIONS:
                getattr(self, attr).reset_parameters(generator)
        for blk in self.multimodal_blocks:
            blk.reset_parameters(generator)
        if self.out == "feature":
            init.linear_(self.fully_connected, generator)
            self.normalization.weight.fill_(1.0)
            self.normalization.bias.zero_()
        else:
            init.linear_(self.classifier, generator)

    def forward(self, l, v, a, l_mask, v_mask, a_mask, *, impl: str = "xla",
                generator=None):
        """l/v/a (B, len, dm) and masks (B, len) -> logits (B, n_emotions),
        or the feature (B, dim) for `out="feature"`; with the
        `conv_multires` unify, v is the tuple (v256, v512, v1024).
        `generator` (a `torch.Generator` on the inputs' device) feeds every
        dropout site; in training mode with dropout > 0 it is required."""
        l, v, a = self.unify_dimension(l, v, a, generator=generator)
        src = {"l": l, "v": v, "a": a}
        if self.positions:
            src = {m: getattr(self, attr)(src[m]) for m, attr in POSITIONS}
        masks = {"l": l_mask, "v": v_mask, "a": a_mask}
        # every layer's output feeds the classifiers; only each stream's
        # last one feeds the feature head (apply_grid's collect="final")
        per_layer = self.out != "feature"
        remat = self.remat and torch.is_grad_enabled()
        collected = {"l": [], "v": [], "a": []}
        for s, (name, qm, kvm) in enumerate(STREAMS):
            q, scores = src[qm], None
            for i in range(self.n_layers):
                block = self.multimodal_blocks[self.n_layers * s + i]
                # the stream's last block has no consumer for its scores
                emit = i < self.n_layers - 1
                if remat:
                    q, scores = rematerialized_block(
                        block, q, src[kvm], masks[kvm], scores, impl=impl,
                        emit_scores=emit, generator=generator)
                else:
                    q, scores = block(q, src[kvm], src[kvm], masks[kvm],
                                      scores, impl=impl, emit_scores=emit,
                                      generator=generator)
                if per_layer or i == self.n_layers - 1:
                    collected[TARGET[name]].append(q)
        lc = torch.cat(collected["l"], dim=2)
        vc = torch.cat(collected["v"], dim=2)
        ac = torch.cat(collected["a"], dim=2)
        # reference sequence-concat order is [l, a, v] (cmu-mosei/run.py:317)
        pooled = mean_max_pool(torch.cat([lc, ac, vc], dim=1))
        if per_layer:
            return self.classifier(pooled)
        # Drop(ReLU(LN(FC(x)))) (others/realformer.py:263)
        x = torch.relu(init.layer_norm(self.fully_connected(pooled),
                                       self.normalization.weight,
                                       self.normalization.bias))
        return dropout(x, active_rate(self), generator)
