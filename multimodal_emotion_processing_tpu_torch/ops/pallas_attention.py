"""Score-chained (RealFormer) attention that materializes its scores:
`impl="pallas"` (named after the JAX package's ops/pallas_attention.py).

csrc/scored_fwd.cu `scored_fwd`, written by hand for Hopper, replaces the
JAX package's forward Pallas kernel (ops/pallas_attention.py `_forward`) in
its four variants: S_prev given or not, times S emitted or not.

    S   = q·kᵀ/√dh (+ c·S_prev) − 1e8·(1 − mask)     f32, post-mask
    ctx = softmax(S)·v                                at the input dtype

A stream's first block has no S_prev and emits S for the next one; its last
block reads S_prev and emits nothing.  The kernel reads the gate c from the
device, so a call never waits for the device.  It takes any sequence length
and head widths 1-256, so the JAX wrapper's VMEM-overflow fallbacks have no
counterpart here.

`scored_attention_pallas` routes as the JAX wrapper does: a 3-D mask takes
the plain path; otherwise CUDA tensors launch the kernel and CPU tensors
take its plain version, `scored_forward_plain`.  Forward only: the backward
kernel (`_backward_pallas`) is not ported yet, so a call that needs a
gradient raises on either device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import _scored_attention_xla
from .cuda_binding import Kernel, check_like, check_qkv, needs_grad, ptr

# (has S_prev, emits S): the four kernel variants
VARIANTS = ((False, True), (True, False), (False, False), (True, True))


def scored_forward_plain(q, k, v, mask, scores_prev, c, *, n_heads: int,
                         emit_scores: bool = True):
    """The kernel's function in plain PyTorch (the `xla` path), accumulated
    in f32: returns (ctx at q's dtype, S (B, H, Lq, Lkv) or None)."""
    ctx, scores = _scored_attention_xla(q, k, v, mask, scores_prev, c,
                                        n_heads=n_heads)
    return ctx, scores if emit_scores else None


def _refuse_gradients(name, *tensors) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: impl='pallas' is forward only (its backward kernel is "
            "not ported yet); train with impl='xla' or 'flash'")


class ScoredForwardKernel(Kernel):
    """`scored_fwd` in csrc/scored_fwd.cu.  `variant_launches` counts the
    launches per (has S_prev, emits S)."""

    name = library = "scored_fwd"
    n_pointers = 8

    def __init__(self):
        super().__init__()
        self.variant_launches = dict.fromkeys(VARIANTS, 0)

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.variant_launches = dict.fromkeys(VARIANTS, 0)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor],
                 scores_prev: Optional[torch.Tensor],
                 c: Optional[torch.Tensor], *, n_heads: int,
                 emit_scores: bool = True):
        """q (B, Lq, D), k/v (B, Lkv, D) on one CUDA device, f32 or bf16;
        mask None or (B, Lkv); scores_prev None or (B, H, Lq, Lkv) f32 with
        the gate c, one value on the device (cast to q's dtype).  Returns
        (ctx (B, Lq, D) at q's dtype, S (B, H, Lq, Lkv) f32 or None)."""
        _refuse_gradients(self.name, q, k, v, mask, scores_prev, c)
        b, lq, lkv, dh, mask = check_qkv(self.name, q, k, v, mask, n_heads)
        if scores_prev is not None:
            scores_prev = check_like("scores_prev", scores_prev,
                                     (b, n_heads, lq, lkv), torch.float32,
                                     q.device)
            if c is None or c.numel() != 1 or c.device != q.device:
                raise ValueError("scores_prev needs the gate c: one value on "
                                 f"{q.device}")
            c = c.reshape(1).to(q.dtype).contiguous()
        else:
            c = None
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx = torch.empty_like(q)
        scores = (torch.empty(b, n_heads, lq, lkv, dtype=torch.float32,
                              device=q.device) if emit_scores else None)
        self._launch(q.device,
                     [ptr(t) for t in (q, k, v, mask, scores_prev, c, ctx, scores)],
                     (b, n_heads, lq, lkv, dh), q.dtype == torch.bfloat16)
        with self._lock:
            self.variant_launches[(scores_prev is not None, emit_scores)] += 1
        return ctx, scores


scored_forward_kernel = ScoredForwardKernel()


def scored_attention_pallas(q, k, v, mask, scores_prev, c, *, n_heads: int,
                            emit_scores: bool = True):
    """Drop-in for `scored_attention(impl="pallas")`.  `mask=None` counts as
    all ones.  A 3-D mask takes the plain `xla` path and returns its scores
    whatever `emit_scores` says, as the JAX wrapper does.  Otherwise CUDA
    tensors launch `scored_fwd` and CPU tensors take `scored_forward_plain`;
    returns (ctx, None) when `emit_scores` is false."""
    if mask is not None and mask.ndim != 2:
        return _scored_attention_xla(q, k, v, mask, scores_prev, c,
                                     n_heads=n_heads)
    if q.device.type == "cpu":
        _refuse_gradients("scored_attention_pallas", q, k, v, mask,
                          scores_prev, c)
        return scored_forward_plain(q, k, v, mask, scores_prev, c,
                                    n_heads=n_heads, emit_scores=emit_scores)
    return scored_forward_kernel(q, k, v, mask, scores_prev, c,
                                 n_heads=n_heads, emit_scores=emit_scores)
