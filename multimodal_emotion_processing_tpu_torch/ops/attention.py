"""Residual-score ("RealFormer") multi-head attention.

Semantics of the reference's `multi_head_attention` (cmu-mosei/run.py:
236-257), as the JAX package's ops/attention.py keeps them:

    scores = Q·Kᵀ / sqrt(d_head)            (+ c * scores_prev when chained)
    scores -= 1e8 * (1 - mask)               (additive key mask)
    out     = softmax(scores) · V
    return out, scores                       (the *masked* scores are emitted)

The mask penalty is finite: a fully masked row gets a uniform softmax over
its keys, where −inf would give NaN.  `_scored_attention_xla` is the plain
PyTorch path and the oracle every kernel is held against; `impl="flash"`
routes terminal blocks to the hand-written CUDA kernel of
ops/flash_attention.py, and `impl="pallas"` every block to the
score-materializing CUDA kernel of ops/pallas_attention.py; `impl="cp"`
shards the sequence over the ranks of the active `cp_context`
(ops/context_parallel.py, plain products and collectives).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

MASK_PENALTY = 1.0e8


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, L, D) -> (B, H, L, D/H)."""
    b, l, d = x.shape
    return x.reshape(b, l, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, Dh) -> (B, L, H*Dh)."""
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _broadcast_mask(mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, Lkv) -> (B, 1, 1, Lkv); (B, Lq, Lkv) -> (B, H, Lq, Lkv)."""
    if mask.ndim == 2:
        return mask[:, None, None, :]
    if mask.ndim == 3:
        return mask[:, None, :, :].expand(-1, n_heads, -1, -1)
    raise ValueError(f"mask must be 2-D or 3-D, got shape {tuple(mask.shape)}")


def scored_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scores_prev: Optional[torch.Tensor],
    c: torch.Tensor,
    *,
    n_heads: int,
    impl: str = "xla",
    emit_scores: bool = True,
):
    """Residual-score attention.

    q: (B, Lq, D); k, v: (B, Lkv, D); mask: None | (B, Lkv) | (B, Lq, Lkv);
    scores_prev: None | (B, H, Lq, Lkv); c: (1,) residual gate.
    impl: 'xla' (plain PyTorch path) | 'flash' (the CUDA online-softmax
    kernel for terminal blocks; calls it cannot serve take the plain path) |
    'pallas' (the CUDA kernels of every block, which emit S, with their
    backward kernels when a gradient is needed; `emit_scores=False` skips
    the S write) | 'cp' (context parallelism over the active
    `cp_context`'s ranks, ops/context_parallel.py: psum mode, or the ring,
    which with `emit_scores=False` builds no S).
    Returns (context (B, Lq, D), scores (B, H, Lq, Lkv) or None)."""
    if impl == "pallas":
        from .pallas_attention import scored_attention_pallas

        return scored_attention_pallas(q, k, v, mask, scores_prev, c,
                                       n_heads=n_heads, emit_scores=emit_scores)
    if impl == "flash":
        from .flash_attention import flash_scored_attention, flash_supported

        if flash_supported(q.shape[1], k.shape[1], mask, scores_prev,
                           emit_scores, q.shape[-1] // n_heads):
            return flash_scored_attention(q, k, v, mask, c, n_heads=n_heads)
        return _scored_attention_xla(q, k, v, mask, scores_prev, c,
                                     n_heads=n_heads)
    if impl == "cp":
        from .context_parallel import (current_cp, ring_scored_attention,
                                       scored_attention_cp)

        mesh, axis, mode = current_cp()
        if mode == "ring":
            # a terminal block (emit_scores=False) builds no score
            # accumulator on the ring
            return ring_scored_attention(q, k, v, mask, scores_prev, c,
                                         n_heads=n_heads, mesh=mesh, axis=axis,
                                         emit_scores=emit_scores)
        return scored_attention_cp(q, k, v, mask, scores_prev, c,
                                   n_heads=n_heads, mesh=mesh, axis=axis)
    if impl == "pallas_fused":
        raise NotImplementedError(
            "impl 'pallas_fused' runs the whole minus block "
            "(ops/fused_block.py, through MinusBlock); attention alone takes "
            "'xla', 'flash' or 'pallas'")
    if impl != "xla":
        raise NotImplementedError(
            f"attention impl {impl!r}: use 'xla', 'flash', 'pallas' or 'cp'")
    return _scored_attention_xla(q, k, v, mask, scores_prev, c, n_heads=n_heads)


def chained_scores(qh, kh, mask, scores_prev, c, *, n_heads: int):
    """Post-mask scores q·kᵀ/√dh (+ c·S_prev) − 1e8·(1 − mask) of head-split
    qh (B, H, Lq, dh) and kh (B, H, Lkv, dh), at their dtype."""
    acc = qh.dtype
    scores = (qh @ kh.transpose(-2, -1)) / math.sqrt(kh.shape[-1])
    if scores_prev is not None:
        scores = scores + c.to(acc) * scores_prev
    if mask is not None:
        scores = scores - MASK_PENALTY * (1.0 - _broadcast_mask(mask, n_heads).to(acc))
    return scores


def _scored_attention_xla(q, k, v, mask, scores_prev, c, *, n_heads: int):
    """The plain path: f32 (or wider) accumulation, post-mask scores."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qh = split_heads(q, n_heads).to(acc)
    kh = split_heads(k, n_heads).to(acc)
    vh = split_heads(v, n_heads).to(acc)
    scores = chained_scores(qh, kh, mask, scores_prev, c, n_heads=n_heads)
    att = torch.softmax(scores, dim=-1)
    ctx = att @ vh
    return merge_heads(ctx.to(q.dtype)), scores
