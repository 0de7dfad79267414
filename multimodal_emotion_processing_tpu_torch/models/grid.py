"""The 9-stream cross-modal attention grid (Multi_ATTN, cmu-mosei/run.py:
265-319).

For modalities L, V, A nine directed streams (ll, lv, la, vv, vl, va, aa, al,
av) each run a chain of `n_layers` blocks that thread one score lineage:
block i emits its scores for block i + 1 only when i < n_layers - 1.  Every
layer's output is collected, the outputs concatenate on the feature axis per
target modality, the three targets concatenate on the sequence axis in the
order [l, a, v], and mean+max pooling feeds the head.  The streams have
distinct weights and (Lq, Lkv) shapes, so by default they are unrolled.

Three alternatives to the unrolled path, each off by default as in JAX
(`apply_grid`), all plain PyTorch:
- `MERGED_FAST_PATH` (module switch; minus blocks at n_layers 1, impl
  "xla"): per target modality one merged QKᵀ against concat[l; v; a]
  (a minus block has no Q/K/V projections, so the target's three streams
  share their query), softmax and AV per segment, and the three streams'
  epilogues (proj, minus, LayerNorm) as stacked batched products;
- the stacked RealFormer grid (`forward(stacked=True)`, or
  `REALFORMER_STACKED` when `stacked` is None; RealFormer blocks, impl
  "xla"): each target's three streams stacked on a leading axis, every
  product of the block batched over it and the score chain c·S_prev
  carried along it; unequal lengths are right-padded to the longest
  (`_pad_seq`) and the padded query rows sliced off before pooling;
- `SPLIT_POOL` (module switch, any path): `ops/pooling.grid_mean_max_pool`
  pools the collected outputs without materialising their concats.
At any other impl the switches are ignored and the unrolled path runs its
kernels, as in JAX: no switch takes a kernel off its path.  The merged and
stacked paths skip `remat`, as JAX's do.  Under tensor parallelism (the
blocks' `tp`, parallel/mesh.shard_params) each rank stacks its own shards
of a target's three blocks and runs the products and collectives the
unrolled tp block runs, once for the three streams: the stacked Q/K/V and
first FFN products column-parallel (`comm.copy_to`; the RealFormer's
attention on the rank's H / tp heads, its scores chained head-sharded),
its `proj` and second FFN product row-parallel, closed by
`comm.reduce_from`; the merged minus path's attention replicated, its
`proj` column-parallel and gathered, its `minus` row-parallel over
[q ; x], as `MinusBlock` runs them.

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
layer, then the feature head's.  The merged path draws, per target l, v,
a, the (3, B, Lq, D) masks after proj and after the LayerNorm; the
stacked path, per target and layer, the (3, B, Lmax, D) masks after proj
and after the FFN (JAX's sites and shapes; batch axis 1).

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

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import MASK_PENALTY, merge_heads, split_heads
from ..ops.pooling import grid_mean_max_pool, mean_max_pool
from ..parallel import comm
from ..utils import initializers as init
from .layers import (DrawnMasks, MinusBlock, PositionEmbedding,
                     RealformerBlock, UnifyConv, UnifyConvMultires,
                     UnifyLinear, active_rate, block_keep_masks, dropout,
                     minus_norm_names, row_parallel)

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
MODALITIES = ("l", "v", "a")
# a target modality's three streams in STREAMS order (self first), each
# with its index in STREAMS and its key/value modality
TARGET_STREAMS = {qm: tuple((s, kvm) for s, (_, q_, kvm) in enumerate(STREAMS)
                            if q_ == qm) for qm in MODALITIES}

# The grid's alternative paths (module docstring), read at each call.
MERGED_FAST_PATH = False
REALFORMER_STACKED = False
SPLIT_POOL = False


def _pad_seq(x, mask, target_len: int):
    """Right-pad (B, L, D) and its (B, L) mask to target_len.  Padded
    positions are zeros whose mask is -1, so the attention's additive
    penalty 1e8·(1 − mask) puts twice the penalty on a padded key: it gets
    exactly 0 softmax weight even in a fully masked row, which therefore
    spreads over its own masked keys as the unrolled path's does.  (JAX's
    `_pad_seq` pads the mask with 0, so there such a row also spreads over
    the padded keys and its context shrinks by L / Lmax.)"""
    pad = target_len - x.shape[1]
    if pad == 0:
        return x, mask
    return F.pad(x, (0, 0, 0, pad)), F.pad(mask, (0, pad), value=-1.0)


def _stacked_ln(x, weight, bias):
    """LayerNorm over the last axis with per-stream parameters (3, D)."""
    y = F.layer_norm(x, (x.shape[-1],), None, None, init.LN_EPS)
    return y * weight[:, None, None, :] + bias[:, None, None, :]


def _stacked_linear(x, weight, bias=None):
    """(3, B, L, in) times per-stream (3, out, in) weights (+ (3, out))."""
    y = torch.einsum("sbqd,sed->sbqe", x, weight)
    return y if bias is None else y + bias[:, None, None, :]


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
    the block (`minus` or `realformer`).  Under tensor parallelism (`tp`,
    parallel/mesh.shard_params) the classifier is row-parallel over the
    pooled features (its input axis sharded, as in JAX)."""

    tp = None

    def __init__(self, cfg, *, out: str = "classifier"):
        super().__init__()
        self.out = out
        self.block = cfg.block
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
            raise ValueError(f"unknown unify {cfg.unify!r}")
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
            raise ValueError(f"unknown block {cfg.block!r}")
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
                generator=None, stacked=None):
        """l/v/a (B, len, dm) and masks (B, len) -> logits (B, n_emotions),
        or the feature (B, dim) for `out="feature"`; with the
        `conv_multires` unify, v is the tuple (v256, v512, v1024).
        `generator` (a `torch.Generator` on the inputs' device) feeds every
        dropout site; in training mode with dropout > 0 it is required.
        `stacked`: the stacked RealFormer path on or off for this call
        (None: `REALFORMER_STACKED`), taken only by RealFormer blocks at
        impl "xla"."""
        l, v, a = self.unify_dimension(l, v, a, generator=generator)
        src = {"l": l, "v": v, "a": a}
        if self.positions:
            src = {m: getattr(self, attr)(src[m]) for m, attr in POSITIONS}
        masks = {"l": l_mask, "v": v_mask, "a": a_mask}
        # every layer's output feeds the classifiers; only each stream's
        # last one feeds the feature head (apply_grid's collect="final")
        per_layer = self.out != "feature"
        collected = None
        if impl == "xla":
            use_stacked = REALFORMER_STACKED if stacked is None else stacked
            if MERGED_FAST_PATH and self.block == "minus" and self.n_layers == 1:
                collected = self._merged_minus(src, masks, generator)
            elif use_stacked and self.block == "realformer":
                collected = self._stacked_realformer(src, masks, generator,
                                                     per_layer)
        if collected is None:
            collected = self._unrolled(src, masks, impl, generator, per_layer)
        if SPLIT_POOL:
            pooled = grid_mean_max_pool(collected["l"], collected["a"],
                                        collected["v"])
        else:
            lc = torch.cat(collected["l"], dim=2)
            vc = torch.cat(collected["v"], dim=2)
            ac = torch.cat(collected["a"], dim=2)
            # reference sequence-concat order is [l, a, v] (cmu-mosei/run.py:317)
            pooled = mean_max_pool(torch.cat([lc, ac, vc], dim=1))
        if per_layer:
            if self.tp is not None:
                return row_parallel(comm.split_to(pooled, self.tp.group, -1),
                                    self.classifier.weight,
                                    self.classifier.bias, self.tp)
            return self.classifier(pooled)
        # Drop(ReLU(LN(FC(x)))) (others/realformer.py:263)
        x = torch.relu(init.layer_norm(self.fully_connected(pooled),
                                       self.normalization.weight,
                                       self.normalization.bias))
        return dropout(x, active_rate(self), generator)

    def _unrolled(self, src, masks, impl, generator, per_layer):
        """The nine streams one after another, each a chain of n_layers
        blocks (under remat, each block checkpointed): {target: outputs}."""
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
        return collected

    def _merged_minus(self, src, masks, generator):
        """JAX `_apply_grid_minus_merged`: {target: [self stream, then the
        other two in STREAMS order]} of minus blocks at n_layers 1."""
        tp = self.multimodal_blocks[0].tp
        h = self.multimodal_blocks[0].n_heads
        rate = active_rate(self)
        kv_cat = torch.cat([src[m] for m in MODALITIES], dim=1)
        acc = torch.promote_types(kv_cat.dtype, torch.float32)
        kvh = split_heads(kv_cat, h).to(acc)                # (B, H, Lsum, dh)
        bounds, start = {}, 0
        for m in MODALITIES:
            bounds[m] = (start, start + src[m].shape[1])
            start += src[m].shape[1]
        neg = {m: MASK_PENALTY * (1.0 - masks[m].to(acc))[:, None, None, :]
               for m in MODALITIES}
        inv_sqrt = 1.0 / math.sqrt(kvh.shape[-1])
        collected = {}
        for qm in MODALITIES:
            q = src[qm]
            scores = (split_heads(q, h).to(acc) @ kvh.transpose(-2, -1)) * inv_sqrt
            ctxs = {}
            for kvm in MODALITIES:
                lo, hi = bounds[kvm]
                att = torch.softmax(scores[..., lo:hi] - neg[kvm], dim=-1)
                ctxs[kvm] = merge_heads((att @ kvh[:, :, lo:hi]).to(q.dtype))
            streams = TARGET_STREAMS[qm]
            blocks = [self.multimodal_blocks[s] for s, _ in streams]
            ctx = torch.stack([ctxs[kvm] for _, kvm in streams])  # (3,B,Lq,D)
            w_proj = torch.stack([b.proj.weight for b in blocks])
            w = torch.stack([b.minus.weight for b in blocks])     # (3, D, 2D)
            if tp is not None:
                # MinusBlock's tp epilogue, stacked: proj column-parallel
                # and gathered, minus row-parallel over [q ; x]
                x = comm.gather_from(_stacked_linear(
                    comm.copy_to(ctx, tp.group), w_proj), tp.group, -1)
                x = dropout(x, rate, generator, batch_dim=1)
                both = torch.cat([q.expand(3, *q.shape), x], dim=-1)
                pre = comm.reduce_from(_stacked_linear(
                    comm.split_to(both, tp.group, -1), w), tp.group)
            else:
                x = dropout(_stacked_linear(ctx, w_proj), rate, generator,
                            batch_dim=1)
                d = q.shape[-1]
                # Linear([q ; x]) as q·W[:d] + x·W[d:], as MinusBlock runs it
                pre = (torch.einsum("bqd,sed->sbqe", q, w[..., :d])
                       + _stacked_linear(x, w[..., d:]))
            y = _stacked_ln(pre, torch.stack([b.norm.weight for b in blocks]),
                            torch.stack([b.norm.bias for b in blocks]))
            y = dropout(y, rate, generator, batch_dim=1)
            collected[qm] = list(y.unbind(0))
        return collected

    def _stacked_realformer(self, src, masks, generator, per_layer):
        """JAX `_apply_grid_realformer_stacked` over `_pad_seq`'s padding:
        {target: outputs} in the unrolled path's order (per layer: all of
        one stream's layers, then the next stream's), the padded query rows
        sliced off.  Under tp each rank runs its h / tp heads
        (`RealformerBlock._forward_tp`'s products, stacked)."""
        tp = self.multimodal_blocks[0].tp
        true_len = {m: src[m].shape[1] for m in MODALITIES}
        max_len = max(true_len.values())
        padded = {m: _pad_seq(src[m], masks[m], max_len) for m in MODALITIES}
        h = self.multimodal_blocks[0].n_heads
        b_, _, d = padded["l"][0].shape
        dh = d // h
        if tp is not None:
            h //= tp.size

        def col(x):    # a column-parallel product's input
            return x if tp is None else comm.copy_to(x, tp.group)

        def row(y):    # a row-parallel product's partial sums
            return y if tp is None else comm.reduce_from(y, tp.group)
        acc = torch.promote_types(padded["l"][0].dtype, torch.float32)
        inv_sqrt = 1.0 / math.sqrt(dh)
        rate = active_rate(self)

        def heads(x):   # (3, B, L, H·dh) -> (3, B, H, L, dh)
            return x.reshape(3, b_, x.shape[2], h, dh).transpose(2, 3)

        collected = {}
        for qm in MODALITIES:
            streams = TARGET_STREAMS[qm]
            kv = torch.stack([padded[kvm][0] for _, kvm in streams])  # (3,B,L,D)
            mask = torch.stack([padded[kvm][1] for _, kvm in streams])
            penalty = MASK_PENALTY * (1.0 - mask.to(acc))[:, :, None, None, :]
            q = padded[qm][0].expand(3, *padded[qm][0].shape)
            scores = None
            per_stream = [[], [], []]
            for i in range(self.n_layers):
                blocks = [self.multimodal_blocks[self.n_layers * s + i]
                          for s, _ in streams]

                def stk(get):
                    return torch.stack([get(blk) for blk in blocks])

                qp = _stacked_linear(col(q),
                                     stk(lambda blk: blk.w_qkv[0].weight))
                kp = _stacked_linear(col(kv),
                                     stk(lambda blk: blk.w_qkv[1].weight))
                vp = _stacked_linear(col(kv),
                                     stk(lambda blk: blk.w_qkv[2].weight))
                s = (heads(qp).to(acc) @ heads(kp).to(acc).transpose(-2, -1)
                     ) * inv_sqrt
                if scores is not None:
                    c = col(stk(lambda blk: blk.c)).to(acc).reshape(
                        3, 1, 1, 1, 1)
                    s = s + c * scores
                s = s - penalty
                scores = s
                ctx = torch.softmax(s, dim=-1) @ heads(vp).to(acc)
                ctx = ctx.transpose(2, 3).reshape(3, b_, -1, h * dh).to(
                    q.dtype)
                x = row(_stacked_linear(ctx, stk(lambda blk: blk.proj.weight)))
                x = dropout(x, rate, generator, batch_dim=1)
                a = stk(lambda blk: blk.a).reshape(3, 1, 1, 1)
                q = _stacked_ln(q + a * x, stk(lambda blk: blk.norm1.weight),
                                stk(lambda blk: blk.norm1.bias))
                b1 = stk(lambda blk: blk.ffn[0].bias)
                if tp is not None:
                    b1 = comm.split_to(b1, tp.group, -1)
                hid = torch.relu(_stacked_linear(
                    col(q), stk(lambda blk: blk.ffn[0].weight), b1))
                f = row(_stacked_linear(hid,
                                        stk(lambda blk: blk.ffn[2].weight)))
                f = f + stk(lambda blk: blk.ffn[2].bias)[:, None, None, :]
                f = dropout(f, rate, generator, batch_dim=1)
                b = stk(lambda blk: blk.b).reshape(3, 1, 1, 1)
                q = _stacked_ln(q + b * f, stk(lambda blk: blk.norm2.weight),
                                stk(lambda blk: blk.norm2.bias))
                if per_layer or i == self.n_layers - 1:
                    for si in range(3):
                        per_stream[si].append(q[si])
            collected[qm] = [y[:, :true_len[qm]] for ys in per_stream
                             for y in ys]
        return collected
