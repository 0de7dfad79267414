"""Encoder building blocks: the modality projections, learned position
embeddings, and the two attention block variants.

- `minus` family (cmu-mosei/run.py:207-262, Ren-MME/run.py:158-214): the
  bias-free Linear unify (Ren-MME's with one LayerNorm shared by the three
  outputs) and the `minus` block (no Q/K/V projections, a Linear combine,
  LayerNorm), whose `impl="pallas_fused"` runs the whole block in one
  kernel (ops/fused_block.py).
- `realformer` family (others/realformer.py:133-209, robot_demo.py:293-374):
  the bias-free 1x1-conv unify of the paragraph model or the robot demo's
  multi-resolution one with biases, position embeddings, and the RealFormer
  block (per-input Q/K/V projections, q = LN(q + a·attn),
  q = LN(q + b·FFN(q)), gates a, b, c starting at 0).

Module attribute names follow the reference's state-dict keys
(`unify_dimension.{linguistic,visual,acoustic}` (+ `norm1` for Ren-MME) or
`unify_dimension.{linguistic,visual_256,visual_512,visual_1024,acoustic}`,
`*_position.position_embeddings`, `proj`, `minus`, `w_qkv.{0,1,2}`,
`norm1`, `norm2` (a Ren-MME minus block's LayerNorm), `ffn.{0,2}`, `a`,
`b`, `c`), so a reference or exported JAX state dict loads with
`load_state_dict` as it is.  Weights keep torch's (out, in) layout, and
the convs' (out, in, 1).

Dropout has JAX's form and sites (`dropout`): the conv unifies after each
projection, the minus block after `proj` and after its LayerNorm, the
RealFormer block after `proj` and after the FFN; the Linear unify has
none.  It is active in training mode with a rate > 0, and then every site
draws its keep mask from the `torch.Generator` the caller passes down.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import scored_attention
from ..ops.fused_block import fused_minus_block
from ..utils import initializers as init


def keep_mask(shape, keep: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """A bool mask of `shape` on `device`, each entry True with probability
    `keep`: the one place the port draws dropout bits, from `generator`
    alone (never the global generator)."""
    return torch.rand(shape, generator=generator, device=device) < keep


class DrawnMasks:
    """Keep masks drawn ahead (by `keep_mask`, in the order of the sites
    that take them), handed to those sites in that order in place of a
    generator: a block under rematerialisation reads the same masks in its
    forward and in its recompute, where an explicit `torch.Generator`
    would have moved on (`torch.utils.checkpoint` restores only the
    default generators)."""

    def __init__(self, masks):
        self._masks = list(masks)
        self._next = 0

    def take(self, shape) -> torch.Tensor:
        if self._next >= len(self._masks):
            raise ValueError(f"{len(self._masks)} keep masks were drawn "
                             "ahead and a further dropout site asked for one")
        mask = self._masks[self._next]
        if mask.shape != shape:
            raise ValueError(f"keep mask {tuple(mask.shape)} drawn ahead for "
                             f"a dropout site of shape {tuple(shape)}")
        self._next += 1
        return mask


def _generator(rate: float, generator):
    if generator is None:
        raise ValueError(
            f"dropout {rate} is active (training mode) and no torch.Generator "
            "was passed: the port draws every dropout mask from one")
    return generator


def dropout(x, rate: float, generator):
    """JAX's dropout (`layers.dropout`): where a Bernoulli(1 − rate) keep
    mask is set, x / keep, else 0; x itself at rate 0.  The division is by
    keep as a tensor of x's dtype, so it is a true division on the card too
    (a Python-scalar divisor becomes a product with 1 / keep there, one
    rounding away from JAX's x / keep).  Callers pass rate 0 outside
    training; an active site without a generator raises.  `generator` is
    a `torch.Generator` or the `DrawnMasks` of a rematerialised block."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, DrawnMasks):
        mask = generator.take(x.shape)
    else:
        mask = keep_mask(x.shape, keep, _generator(rate, generator), x.device)
    return torch.where(
        mask, x / torch.full((), keep, dtype=x.dtype, device=x.device), 0.0)


def block_keep_masks(block: nn.Module, q, generator) -> tuple:
    """The keep masks of a minus or RealFormer block's two dropout sites
    (after `proj`, then after the LayerNorm or the FFN; each of q's shape),
    drawn from `generator` in the order the block's forward draws them;
    none where its dropout is inactive."""
    rate = active_rate(block)
    if rate <= 0.0:
        return ()
    gen = _generator(rate, generator)
    return tuple(keep_mask(q.shape, 1.0 - rate, gen, q.device)
                 for _ in range(2))


def active_rate(module: nn.Module) -> float:
    """`module.dropout` in training mode, else 0."""
    return module.dropout if module.training else 0.0


def minus_norm_names(cfg):
    """The state-dict names of a minus grid's block LayerNorm and of the
    `concat_trans` head's LayerNorm: `norm2` and `norm3` in Ren-MME's
    Base_model (Ren-MME/run.py:169-214, 273-292), which the `linear_ln`
    unify selects, else `norm1` and `norm1` (cmu-mosei/run.py:217-339)."""
    return ("norm2", "norm3") if cfg.unify == "linear_ln" else ("norm1", "norm1")


class UnifyLinear(nn.Module):
    """Bias-free per-modality Linear (`apply_unify_linear`); with
    `shared_ln` (the `linear_ln` unify of Ren-MME/run.py:158-166), one
    LayerNorm `norm1` applied to each of the three outputs."""

    def __init__(self, l_dim: int, v_dim: int, a_dim: int, dim: int, *,
                 shared_ln: bool = False):
        super().__init__()
        self.linguistic = nn.Linear(l_dim, dim, bias=False)
        self.visual = nn.Linear(v_dim, dim, bias=False)
        self.acoustic = nn.Linear(a_dim, dim, bias=False)
        self.norm1 = nn.LayerNorm(dim, eps=init.LN_EPS) if shared_ln else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.linguistic, self.visual, self.acoustic):
            init.linear_(lin, generator)
        if self.norm1 is not None:
            self.norm1.weight.fill_(1.0)
            self.norm1.bias.zero_()

    def forward(self, l, v, a, generator=None):
        """No dropout site (JAX `apply_unify_linear`): `generator` is
        unused."""
        outs = self.linguistic(l), self.visual(v), self.acoustic(a)
        if self.norm1 is None:
            return outs
        return tuple(init.layer_norm(x, self.norm1.weight, self.norm1.bias)
                     for x in outs)


def _pointwise(conv: nn.Conv1d, x):
    """A kernel-1 Conv1d over (B, L, C): a position-wise Linear."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class UnifyConv(nn.Module):
    """The paragraph model's unify (`apply_unify_conv`): a bias-free
    kernel-1 Conv1d per modality, applied position-wise, each output
    through dropout in the order l, v, a."""

    def __init__(self, l_dim: int, v_dim: int, a_dim: int, dim: int, *,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linguistic = nn.Conv1d(l_dim, dim, 1, bias=False)
        self.visual = nn.Conv1d(v_dim, dim, 1, bias=False)
        self.acoustic = nn.Conv1d(a_dim, dim, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for conv in (self.linguistic, self.visual, self.acoustic):
            init.linear_(conv, generator)

    def forward(self, l, v, a, generator=None):
        rate = active_rate(self)
        return tuple(dropout(_pointwise(conv, x), rate, generator) for conv, x
                     in ((self.linguistic, l), (self.visual, v),
                         (self.acoustic, a)))


class UnifyConvMultires(nn.Module):
    """The robot demo's unify (`apply_unify_conv_multires`): kernel-1 Conv1d
    with bias per input; the three visual resolution slots each map to
    dim // 3 and concatenate in the order 256, 512, 1024.  Each of the five
    outputs goes through dropout before the concat, in the order l, v256,
    v512, v1024, a."""

    def __init__(self, l_dim: int, v_dims, a_dim: int, dim: int, *,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        d3 = dim // 3
        self.linguistic = nn.Conv1d(l_dim, dim, 1)
        self.visual_256 = nn.Conv1d(v_dims[0], d3, 1)
        self.visual_512 = nn.Conv1d(v_dims[1], d3, 1)
        self.visual_1024 = nn.Conv1d(v_dims[2], d3, 1)
        self.acoustic = nn.Conv1d(a_dim, dim, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for conv in (self.linguistic, self.visual_256, self.visual_512,
                     self.visual_1024, self.acoustic):
            init.linear_(conv, generator)

    def forward(self, l, v, a, generator=None):
        """l (B, Ll, l_dim), v a tuple (v256, v512, v1024), a (B, La, a_dim)."""
        rate = active_rate(self)
        l, v256, v512, v1024, a = (
            dropout(_pointwise(conv, x), rate, generator) for conv, x in (
                (self.linguistic, l), (self.visual_256, v[0]),
                (self.visual_512, v[1]), (self.visual_1024, v[2]),
                (self.acoustic, a)))
        return l, torch.cat([v256, v512, v1024], dim=-1), a


class PositionEmbedding(nn.Module):
    """Learned position table (`apply_position_embedding`): x + table[:L]."""

    def __init__(self, max_len: int, dim: int):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_len, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init.embedding_(self.position_embeddings, generator)

    def forward(self, x):
        return x + self.position_embeddings.weight[: x.shape[1]]


class MinusBlock(nn.Module):
    """`apply_block_minus`: no Q/K/V projections; after attention,
    q' = Drop(LN(Linear_{2d→d}([q ; Drop(proj(ctx))]))).  Gradients flow
    through every part, the attention kernels included.  The LayerNorm is
    `norm1`, or `norm2` under Ren-MME's names (`norm=`).  While dropout is
    active (training, rate > 0), `impl="pallas_fused"` runs the attention
    kernel with this epilogue, as in JAX: the whole-block kernel has no
    dropout."""

    def __init__(self, dim: int, n_heads: int, *, dropout: float = 0.0,
                 norm: str = "norm1"):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        self.norm_name = norm
        self.proj = nn.Linear(dim, dim, bias=False)
        self.minus = nn.Linear(2 * dim, dim, bias=False)
        setattr(self, norm, nn.LayerNorm(dim, eps=init.LN_EPS))
        self.c = nn.Parameter(torch.zeros(1))

    @property
    def norm(self) -> nn.LayerNorm:
        return getattr(self, self.norm_name)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        init.linear_(self.proj, generator)
        init.linear_(self.minus, generator)
        self.norm.weight.fill_(1.0)
        self.norm.bias.zero_()
        self.c.zero_()

    def forward(self, q, k, v, mask, scores, *, impl: str = "xla",
                emit_scores: bool = True, generator=None):
        """q, k, v (B, L, dim), k and v used raw; returns (q', scores')."""
        rate = active_rate(self)
        if impl == "pallas_fused":
            if rate <= 0.0 and (mask is None or mask.ndim == 2):
                return fused_minus_block(
                    q, k, v, mask, scores, self.c, self.proj.weight,
                    self.minus.weight, self.norm.weight, self.norm.bias,
                    n_heads=self.n_heads, emit_scores=emit_scores)
            impl = "pallas"   # the attention kernel with the plain epilogue
        ctx, scores = scored_attention(
            q, k, v, mask, scores, self.c, n_heads=self.n_heads, impl=impl,
            emit_scores=emit_scores)
        x = dropout(self.proj(ctx), rate, generator)
        # Linear(concat[q, x]) as q @ W[:d] + x @ W[d:]: the same function
        # without materializing the (B, L, 2d) concat
        d = q.shape[-1]
        w = self.minus.weight
        pre = F.linear(q, w[:, :d]) + F.linear(x, w[:, d:])
        out = init.layer_norm(pre, self.norm.weight, self.norm.bias)
        return dropout(out, rate, generator), scores


class RealformerBlock(nn.Module):
    """`apply_block_realformer`: bias-free Q/K/V projections of (q, k, v);
    residual-score attention with gate c; q = LN1(q + a·Drop(proj(ctx)));
    q = LN2(q + b·Drop(FFN(q))) with a ReLU FFN of width ffn·dim."""

    def __init__(self, dim: int, n_heads: int, ffn_mult: int, *,
                 dropout: float = 0.0):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        self.w_qkv = nn.ModuleList(nn.Linear(dim, dim, bias=False)
                                   for _ in range(3))
        self.proj = nn.Linear(dim, dim, bias=False)
        self.norm1 = nn.LayerNorm(dim, eps=init.LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=init.LN_EPS)
        self.ffn = nn.Sequential(nn.Linear(dim, ffn_mult * dim), nn.ReLU(),
                                 nn.Linear(ffn_mult * dim, dim))
        self.a = nn.Parameter(torch.zeros(1))
        self.b = nn.Parameter(torch.zeros(1))
        self.c = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (*self.w_qkv, self.proj, self.ffn[0], self.ffn[2]):
            init.linear_(lin, generator)
        for norm in (self.norm1, self.norm2):
            norm.weight.fill_(1.0)
            norm.bias.zero_()
        for gate in (self.a, self.b, self.c):
            gate.zero_()

    def forward(self, q, k, v, mask, scores, *, impl: str = "xla",
                emit_scores: bool = True, generator=None):
        """q (B, Lq, dim), k and v (B, Lkv, dim); returns (q', scores').
        `impl="pallas_fused"` runs `pallas` here, as in JAX: the whole-block
        kernel is the minus block's."""
        if impl == "pallas_fused":
            impl = "pallas"
        wq, wk, wv = self.w_qkv
        ctx, scores = scored_attention(
            wq(q), wk(k), wv(v), mask, scores, self.c, n_heads=self.n_heads,
            impl=impl, emit_scores=emit_scores)
        rate = active_rate(self)
        x = dropout(self.proj(ctx), rate, generator)
        q = init.layer_norm(q + self.a * x, self.norm1.weight, self.norm1.bias)
        h = dropout(self.ffn(q), rate, generator)
        q = init.layer_norm(q + self.b * h, self.norm2.weight, self.norm2.bias)
        return q, scores
