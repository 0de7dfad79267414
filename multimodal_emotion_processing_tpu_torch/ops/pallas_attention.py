"""Score-chained (RealFormer) attention that materializes its scores:
`impl="pallas"` (named after the JAX package's ops/pallas_attention.py),
forward and backward.

The kernels are written by hand in CUDA C++ for Hopper; each source's header
says what bounds it on the card.

- csrc/scored_fwd.cu `scored_fwd` replaces the JAX package's forward Pallas
  kernel (ops/pallas_attention.py `_forward`) in its four variants: S_prev
  given or not, times S emitted or not.

      S   = q·kᵀ/√dh (+ c·S_prev) − 1e8·(1 − mask)     f32, post-mask
      ctx = softmax(S)·v                                at the input dtype

- csrc/scored_bwd.cu `scored_bwd_dq` and `scored_bwd_dkv` replace its
  backward Pallas kernel (`_backward_pallas`) in the same four variants:

      ds = p·(dp − Σ dp·p) (+ dS)      dS_prev = c·ds      dc = Σ ds·S_prev
      dmask = 1e8·Σ_{h,q} ds           dq, dk, dv

  s is read from the emitted S or rebuilt exactly as the forward kernel
  computed it (csrc/scored_mma.cuh `score_dots`, then csrc/flash_common.cuh
  `chained_score`); m and l come from the forward's row stats and delta
  from dctx·ctx, so dq sweeps the keys once.  At bf16, where ctx comes
  back rounded, dq takes m, l and delta = Σ p·dp in a first sweep.

Every product of the three kernels runs on the tensor cores in split-TF32
form (csrc/scored_mma.cuh: each f32 operand as two TF32 terms, three
products into f32 accumulators), which keeps f32 accuracy.

A stream's first block has no S_prev and emits S for the next one; its last
block reads S_prev and emits nothing.  The kernels read the gate c from the
device, so a call never waits for the device.  They take any sequence
length and head widths 1-256, so the JAX wrapper's VMEM-overflow fallbacks
have no counterpart here.  The JAX package keeps two backwards (its Pallas
kernel and an einsum VJP, `bwd_impl`); the port has one: the kernels on
CUDA tensors, and their plain version `scored_backward_plain` (JAX's einsum
VJP) on CPU tensors.

`scored_attention_pallas` routes as the JAX wrapper does: a 3-D mask takes
the plain path; every other call goes through `ScoredAttention`, the
`torch.autograd.Function` in place of JAX `_make`'s custom VJPs, whose CUDA
tensors launch the kernels and whose CPU tensors take their plain versions,
`scored_forward_plain` and `scored_backward_plain`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .attention import (MASK_PENALTY, _scored_attention_xla, chained_scores,
                        merge_heads, split_heads)
from .cuda_binding import (Kernel, check_like, check_qkv, launch_stream,
                           needs_grad, ptr)

# (has S_prev, emits S): the four kernel variants
VARIANTS = ((False, True), (True, False), (False, False), (True, True))


def scored_forward_plain(q, k, v, mask, scores_prev, c, *, n_heads: int,
                         emit_scores: bool = True):
    """The forward kernel's function in plain PyTorch (the `xla` path),
    accumulated in f32: returns (ctx at q's dtype, S (B, H, Lq, Lkv) or
    None)."""
    ctx, scores = _scored_attention_xla(q, k, v, mask, scores_prev, c,
                                        n_heads=n_heads)
    return ctx, scores if emit_scores else None


def scored_backward_plain(q, k, v, mask, scores_prev, c, scores, dscores,
                          dctx, *, n_heads: int):
    """The backward kernels' function in plain PyTorch, accumulated in f32:
    JAX's einsum VJP (`_attn_bwd`, with `_recompute_scores` when `scores`,
    the emitted S, is None) and the dc, dmask and dS_prev lines of `_make`.
    `dscores` is the cotangent of the emitted S, or None.  Returns (dq, dk,
    dv at the input dtype, dmask (B, Lkv) at q's dtype or None without a
    mask, dS_prev f32 and dc (at c's dtype, c's shape) or None without
    scores_prev)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh, gh = (split_heads(t, n_heads).to(acc) for t in (q, k, v, dctx))
    inv_sqrt = 1.0 / math.sqrt(qh.shape[-1])
    if scores is None:
        scores = chained_scores(qh, kh, mask, scores_prev, c, n_heads=n_heads)
    p = torch.softmax(scores.to(acc), dim=-1)
    dv = p.transpose(-2, -1) @ gh
    dp = gh @ vh.transpose(-2, -1)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if dscores is not None:
        ds = ds + dscores.to(acc)
    dq = (ds @ kh) * inv_sqrt
    dk = (ds.transpose(-2, -1) @ qh) * inv_sqrt
    dmask = (None if mask is None
             else (MASK_PENALTY * ds.sum(dim=(1, 2))).to(q.dtype))
    dsprev = dc = None
    if scores_prev is not None:
        dsprev = (c.to(acc) * ds).to(torch.float32)
        dc = (ds * scores_prev).sum().to(c.dtype).reshape(c.shape)
    return (merge_heads(dq).to(q.dtype), merge_heads(dk).to(k.dtype),
            merge_heads(dv).to(v.dtype), dmask, dsprev, dc)


def _check_grad_free(name, *tensors, via: str = "ScoredAttention") -> None:
    """The bare kernels record no autograd graph."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name} records no autograd graph: a call that "
                           f"needs a gradient goes through {via}")


def _check_gate(scores_prev, c, q):
    """c as the kernels read it: one value of q's dtype on q's device, or
    None without scores_prev."""
    if scores_prev is None:
        return None
    if c is None or c.numel() != 1 or c.device != q.device:
        raise ValueError(f"scores_prev needs the gate c: one value on {q.device}")
    return c.reshape(1).to(q.dtype).contiguous()


class _VariantKernel(Kernel):
    """A kernel with four variants; `variant_launches` counts the launches
    per (has S_prev, emits S)."""

    def __init__(self):
        super().__init__()
        self.variant_launches = dict.fromkeys(VARIANTS, 0)

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.variant_launches = dict.fromkeys(VARIANTS, 0)

    def _run(self, tensors, dims, variant, stream=None) -> None:
        """Launch on the tensors' pointers (the first is q) and count."""
        self._launch(tensors[0].device, [ptr(t) for t in tensors], dims,
                     tensors[0].dtype == torch.bfloat16, stream)
        self._count("variant_launches", variant, stream)


class ScoredForwardKernel(_VariantKernel):
    """`scored_fwd` in csrc/scored_fwd.cu."""

    name = library = "scored_fwd"
    n_pointers = 9

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor],
                 scores_prev: Optional[torch.Tensor],
                 c: Optional[torch.Tensor], *, n_heads: int,
                 emit_scores: bool = True, stats: bool = False):
        """q (B, Lq, D), k/v (B, Lkv, D) on one CUDA device, f32 or bf16;
        mask None or (B, Lkv); scores_prev None or (B, H, Lq, Lkv) f32 with
        the gate c, one value on the device (cast to q's dtype).  Returns
        (ctx (B, Lq, D) at q's dtype, S (B, H, Lq, Lkv) f32 or None), and
        with `stats` also the row stats (2, B, H, Lq) f32 (the max m and
        the sum l of exp(s − m)) that the backward reads."""
        _check_grad_free(self.name, q, k, v, mask, scores_prev, c)
        b, lq, lkv, dh, mask = check_qkv(self.name, q, k, v, mask, n_heads)
        if scores_prev is not None:
            scores_prev = check_like("scores_prev", scores_prev,
                                     (b, n_heads, lq, lkv), torch.float32,
                                     q.device)
        c = _check_gate(scores_prev, c, q)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx = torch.empty_like(q)
        scores = (torch.empty(b, n_heads, lq, lkv, dtype=torch.float32,
                              device=q.device) if emit_scores else None)
        row_stats = (torch.empty(2, b, n_heads, lq, dtype=torch.float32,
                                 device=q.device) if stats else None)
        self._run([q, k, v, mask, scores_prev, c, ctx, scores, row_stats],
                  (b, n_heads, lq, lkv, dh), (scores_prev is not None, emit_scores))
        return (ctx, scores, row_stats) if stats else (ctx, scores)


class ScoredBwdDqKernel(_VariantKernel):
    """`scored_bwd_dq` in csrc/scored_bwd.cu."""

    name = "scored_bwd_dq"
    library = "scored_bwd"
    n_pointers = 15

    def launch(self, ins, dims, variant, stream=None):
        """`ins`, `dims` and `variant` as ScoredBackwardKernel.check gives
        them.  Returns (dq at q's dtype, the row stats m, l and delta
        (3, B, H, Lq) f32 for scored_bwd_dkv, dS_prev (B, H, Lq, Lkv) f32
        and the dc partials (B, H, ⌈Lq/16⌉) f32 or None, None without
        scores_prev)."""
        q = ins[0]
        b, h, lq, lkv, _ = dims
        dq = torch.empty_like(q)
        stats = torch.empty(3, b, h, lq, dtype=torch.float32, device=q.device)
        dsprev = dcpart = None
        if variant[0]:
            dsprev = torch.empty(b, h, lq, lkv, dtype=torch.float32,
                                 device=q.device)
            dcpart = torch.empty(b, h, -(-lq // 16), dtype=torch.float32,
                                 device=q.device)
        self._run(ins + [stats, dq, dsprev, dcpart], dims, variant, stream)
        return dq, stats, dsprev, dcpart


class ScoredBwdDkvKernel(_VariantKernel):
    """`scored_bwd_dkv` in csrc/scored_bwd.cu."""

    name = "scored_bwd_dkv"
    library = "scored_bwd"
    n_pointers = 15

    def launch(self, ins, stats, dcpart, dims, variant, want_dmask: bool,
               stream=None):
        """`stats` and `dcpart` from scored_bwd_dq on the same inputs.
        Returns (dk, dv at k's dtype, dmask (B, Lkv) f32: the kernel's
        per-head rows 1e8·Σ_q ds summed over heads, None without a mask or
        when `want_dmask` is false; dc (1,) f32, the partials summed in a
        fixed order by the kernel, or None without them)."""
        b, h, _, lkv, _ = dims
        dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
        dmh = None
        if want_dmask and ins[3] is not None:
            dmh = torch.empty(b, h, lkv, dtype=torch.float32,
                              device=dk.device)
        dc = (None if dcpart is None else
              torch.empty(1, dtype=torch.float32, device=dk.device))
        self._run(ins[:9] + [stats, dcpart, dk, dv, dmh, dc], dims, variant,
                  stream)
        return dk, dv, None if dmh is None else dmh.sum(dim=1), dc


class ScoredBackwardKernel:
    """The backward of csrc/scored_bwd.cu: checks its inputs once, then
    launches `scored_bwd_dq` (dq, dS_prev, the dc partials and the row
    stats) and `scored_bwd_dkv` (dk, dv, dmask, dc) on one stream, each
    counting its own launches."""

    name = "scored_bwd"

    def __init__(self):
        self.dq = ScoredBwdDqKernel()
        self.dkv = ScoredBwdDkvKernel()

    def check(self, q, k, v, mask, scores_prev, c, scores, dscores, dctx, *,
              n_heads: int, out=None, stats=None):
        """The forward's q, k, v, mask, S_prev and c, the emitted S (None
        where the forward emitted none: the kernels rebuild s) with its
        cotangent dscores (None counts as zero), the cotangent dctx (like
        q), the forward's output `out` (ctx: delta = dctx·ctx) and, where
        the forward wrote them, its row stats (2, B, H, Lq) f32 (None: the
        dq kernel takes them in a sweep of its own).  Returns (the inputs
        in the kernels' order, (B, H, Lq, Lkv, dh), the variant (has S_prev,
        emits S))."""
        _check_grad_free(self.name, q, k, v, mask, scores_prev, c, scores,
                         dscores, dctx)
        b, lq, lkv, dh, mask = check_qkv(self.name, q, k, v, mask, n_heads)
        if out is None:
            raise ValueError("scored_bwd needs the forward's output ctx "
                             "(`out`): delta = dctx·ctx")
        out = check_like("out", out, q.shape, q.dtype, q.device)
        if stats is not None:
            stats = check_like("stats", stats, (2, b, n_heads, lq),
                               torch.float32, q.device)
        score_shape = (b, n_heads, lq, lkv)
        if scores_prev is not None:
            scores_prev = check_like("scores_prev", scores_prev, score_shape,
                                     torch.float32, q.device)
        if scores is not None:
            scores = check_like("scores", scores, score_shape, torch.float32,
                                q.device)
        if dscores is not None:
            if scores is None:
                raise ValueError("dscores is the cotangent of an emitted S: "
                                 "pass S with it")
            dscores = check_like("dscores", dscores, score_shape,
                                 torch.float32, q.device)
        c = _check_gate(scores_prev, c, q)
        dctx = check_like("dctx", dctx, q.shape, q.dtype, q.device)
        ins = [t.contiguous() for t in (q, k, v)] + [
            mask, scores, dscores, scores_prev, c, dctx, out, stats]
        variant = (scores_prev is not None, scores is not None)
        return ins, (b, n_heads, lq, lkv, dh), variant

    def __call__(self, q, k, v, mask, scores_prev, c, scores, dscores, dctx,
                 *, n_heads: int, out=None, stats=None,
                 want_dmask: bool = True):
        """`out` and `stats` as `check` takes them.  Returns (dq, dk, dv at
        the input dtype, dmask (B, Lkv) f32 or None without a mask or when
        `want_dmask` is false, dS_prev (B, H, Lq, Lkv) f32 and dc (1,) f32
        or None, None without scores_prev)."""
        ins, dims, variant = self.check(q, k, v, mask, scores_prev, c, scores,
                                        dscores, dctx, n_heads=n_heads,
                                        out=out, stats=stats)
        stream = launch_stream(q.device)
        dq, row_stats, dsprev, dcpart = self.dq.launch(ins, dims, variant,
                                                       stream)
        dk, dv, dmask, dc = self.dkv.launch(ins, row_stats, dcpart, dims,
                                            variant, want_dmask, stream)
        return dq, dk, dv, dmask, dsprev, dc


scored_forward_kernel = ScoredForwardKernel()
scored_backward_kernel = ScoredBackwardKernel()
KERNELS = (scored_forward_kernel, scored_backward_kernel.dq,
           scored_backward_kernel.dkv)


class ScoredAttention(torch.autograd.Function):
    """Score-chained attention with its backward kernels, in place of JAX
    `_make`'s four custom VJPs.  The forward saves q, k, v, the mask, S_prev,
    c and the emitted S; the backward takes the cotangents of ctx and of S
    (None where nothing downstream reads them) and returns dq, dk, dv,
    dmask (at the mask's dtype, when the mask needs a gradient), dS_prev
    and dc (at c's dtype; c gets none in the variants without S_prev, as on
    the plain path).  CPU tensors take the plain versions, CUDA tensors the
    kernels; where a gradient is needed the forward kernel also writes its
    row stats, and the backward kernels read them with ctx (one sweep over
    the keys in dq).  Returns (ctx, S) when S is emitted, else ctx."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scores_prev, c, n_heads, emit_scores):
        ctx.set_materialize_grads(False)
        out_saved = stats = None
        if q.device.type == "cpu":
            out, scores = scored_forward_plain(q, k, v, mask, scores_prev, c,
                                               n_heads=n_heads,
                                               emit_scores=emit_scores)
        elif any(ctx.needs_input_grad[:6]):
            out, scores, stats = scored_forward_kernel(
                q, k, v, mask, scores_prev, c, n_heads=n_heads,
                emit_scores=emit_scores, stats=True)
            out_saved = out
        else:
            out, scores = scored_forward_kernel(q, k, v, mask, scores_prev, c,
                                                n_heads=n_heads,
                                                emit_scores=emit_scores)
        ctx.save_for_backward(q, k, v, mask, scores_prev, c, scores,
                              out_saved, stats)
        ctx.n_heads = n_heads
        return (out, scores) if emit_scores else out

    @staticmethod
    def backward(ctx, dctx, dscores=None):
        q, k, v, mask, scores_prev, c, scores, out, stats = ctx.saved_tensors
        h = ctx.n_heads
        if dctx is None:
            dctx = torch.zeros_like(q)
        want_dmask = mask is not None and ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            dq, dk, dv, dmask, dsprev, dc = scored_backward_plain(
                q, k, v, mask, scores_prev, c, scores, dscores, dctx,
                n_heads=h)
        else:
            dq, dk, dv, dmask, dsprev, dc = scored_backward_kernel(
                q, k, v, mask, scores_prev, c, scores, dscores, dctx,
                n_heads=h, out=out, stats=stats, want_dmask=want_dmask)
            if dc is not None:
                dc = dc.to(c.dtype).reshape(c.shape)
        # at q's dtype, as JAX has it (the cotangent of mask.astype(q.dtype))
        dmask = dmask.to(q.dtype).to(mask.dtype) if want_dmask else None
        return dq, dk, dv, dmask, dsprev, dc, None, None


def scored_attention_pallas(q, k, v, mask, scores_prev, c, *, n_heads: int,
                            emit_scores: bool = True):
    """Drop-in for `scored_attention(impl="pallas")`.  `mask=None` counts as
    all ones.  A 3-D mask takes the plain `xla` path and returns its scores
    whatever `emit_scores` says, as the JAX wrapper does.  Every other call
    goes through `ScoredAttention`, which records a graph only where one is
    needed.  Returns (ctx, None) when `emit_scores` is false."""
    if mask is not None and mask.ndim != 2:
        return _scored_attention_xla(q, k, v, mask, scores_prev, c,
                                     n_heads=n_heads)
    out = ScoredAttention.apply(q, k, v, mask, scores_prev, c, n_heads,
                                emit_scores)
    return out if emit_scores else (out, None)
