"""Flash (online-softmax) attention for terminal blocks, forward and backward.

The kernels are written by hand in CUDA C++ for Hopper; each source's header
says what bounds it on the card.  bf16 up to a head width of 128 runs on the
tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators; P and dS
enter their products as three bf16 terms, so the outputs match f32 p and ds),
f32 and wider heads on scalar f32 FMAs.

- csrc/flash_fwd.cu `flash_fwd` replaces the JAX package's two forward Pallas
  kernels (ops/flash_attention.py `_flash_forward_whole` and
  `_flash_forward`): one kernel walks kv tiles with the running max and sum
  in f32, so every kv length takes the same loop.  For training it also
  writes the final row stats m and l, (B, H, Lq) f32 each.
- csrc/flash_bwd.cu `flash_bwd_dq` and `flash_bwd_dkv` replace the backward
  Pallas kernels (`_flash_backward`'s dQ and dK/dV sweeps, and the fused
  `_flash_backward_whole`): p = exp(s − m)·(1/l) is recomputed per tile
  from q, k, the mask and the saved stats.  m and l stay separate, never a
  folded lse = m + log l: in a fully masked row m ≈ −1e8, where the f32
  spacing is 8, and log l would round away.  Both .cu files compute a score
  through one chain per dtype and head width (csrc/flash_mma.cuh on the
  tensor cores, csrc/flash_common.cuh on scalar FMAs), so s is
  bit-identical forward and backward.

- csrc/flash_fwd.cu `flash_fwd_mla_varlen` is the causal, variable-length
  prefill of latent attention (models/tower.py): qk width 192 (128 nope +
  64 rope, the rope key shared by the heads), v width 128, sequences
  packed back to back by `cu_seqlens`, bf16 on the tensor cores;
  `mla_varlen_plain` is its function in plain PyTorch.

Terminal blocks only: scores_prev is None and the scores are not emitted, so
S is never materialized.  The mask is the reference's finite 1e8 penalty, and
columns past Lkv are skipped inside the kernels instead of zero-padded: a
fully masked row is then uniform over its real keys, as the plain path has
it.  The JAX wrapper pads kv to a multiple of 128 and averages such a row
over the padded length; the port does not copy that.

`flash_scored_attention` takes the kernels for CUDA tensors and the plain
PyTorch versions (`flash_forward_plain`, `flash_backward_plain`) only for CPU
tensors.  When a gradient is needed it goes through `FlashAttention`, the
`torch.autograd.Function` in place of JAX `_make_flash`'s custom VJP.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .attention import MASK_PENALTY, _scored_attention_xla, merge_heads, split_heads
from .cuda_binding import (MAX_HEAD_DIM, Kernel, check_like, check_qkv,
                           needs_grad, ptr)


def flash_supported(lq: int, lkv: int, mask, scores_prev,
                    emit_scores: bool, d_head: int = 128) -> bool:
    """Whether the flash kernel implements this call's exact semantics."""
    if scores_prev is not None or emit_scores:
        return False  # the score tensor has a consumer — it must materialize
    if mask is not None and mask.ndim != 2:
        return False
    if d_head > MAX_HEAD_DIM:
        return False
    return True


def flash_forward_plain(q, k, v, mask, *, n_heads: int, stats: bool = False):
    """The forward kernel's function in plain PyTorch: softmax(q·kᵀ/√dh −
    1e8(1−mask))·v accumulated in f32, returned at the input dtype.  With
    `stats`, returns (o, m, l): the row max m of the masked scores and
    l = Σ exp(s − m), (B, H, Lq) each at the accumulation dtype."""
    ctx, s = _scored_attention_xla(q, k, v, mask, None, None, n_heads=n_heads)
    if not stats:
        return ctx
    m = s.amax(dim=-1)
    return ctx, m, torch.exp(s - m[..., None]).sum(dim=-1)


def flash_backward_plain(q, k, v, mask, o, do, m, l, *, n_heads: int):
    """The backward kernels' function in plain PyTorch, accumulated in f32:
    from the forward's output o and row stats m, l and the cotangent do,
    returns (dq, dk, dv) at the input dtype and dmask (B, Lkv) f32 (None
    without a mask), the per-head rows 1e8·Σ_q ds summed over heads."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qh, kh, vh, oh, doh = (split_heads(t, n_heads).to(acc)
                           for t in (q, k, v, o, do))
    inv_sqrt = 1.0 / math.sqrt(qh.shape[-1])
    s = (qh @ kh.transpose(-2, -1)) / math.sqrt(qh.shape[-1])
    if mask is not None:
        s = s - MASK_PENALTY * (1.0 - mask.to(acc)[:, None, None, :])
    p = torch.exp(s - m.to(acc)[..., None]) * (1.0 / l.to(acc)[..., None])
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    dv = p.transpose(-2, -1) @ doh
    ds = p * (doh @ vh.transpose(-2, -1) - delta)
    dq = (ds @ kh) * inv_sqrt
    dk = (ds.transpose(-2, -1) @ qh) * inv_sqrt
    dmask = None if mask is None else (MASK_PENALTY * ds.sum(dim=2)).sum(dim=1)
    return (merge_heads(dq).to(q.dtype), merge_heads(dk).to(k.dtype),
            merge_heads(dv).to(v.dtype), dmask)


def _check_qkv(name, q, k, v, mask, n_heads):
    """`check_qkv`, after refusing inputs that need a gradient: the bare
    kernels record no autograd graph."""
    if needs_grad(q, k, v, mask):
        raise RuntimeError(f"{name} records no autograd graph: a call that "
                           "needs a gradient goes through FlashAttention")
    return check_qkv(name, q, k, v, mask, n_heads)


class FlashForwardKernel(Kernel):
    """`flash_fwd` in csrc/flash_fwd.cu.  `stats_launches` counts the
    launches that also wrote the row stats (the training forward)."""

    name = library = "flash_fwd"
    n_pointers = 7

    def __init__(self):
        super().__init__()
        self.stats_launches = 0

    def reset(self) -> None:
        with self._lock:
            self.launches = self.stats_launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], *, n_heads: int,
                 stats: bool = False):
        """q (B, Lq, D), k/v (B, Lkv, D) on one CUDA device, f32 or bf16;
        mask None or (B, Lkv).  Returns o (B, Lq, D) at q's dtype, and with
        `stats` (o, m, l) with m, l (B, H, Lq) f32."""
        b, lq, lkv, dh, mask = _check_qkv(self.name, q, k, v, mask, n_heads)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = torch.empty_like(q)
        m = l = None
        if stats:
            m = torch.empty(b, n_heads, lq, dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
        self._launch(q.device, [ptr(t) for t in (q, k, v, mask, o, m, l)],
                     (b, n_heads, lq, lkv, dh), q.dtype == torch.bfloat16)
        if not stats:
            return o
        self._count("stats_launches")
        return o, m, l


class _FlashBackwardKernel(Kernel):
    library = "flash_bwd"

    def _inputs(self, q, k, v, mask, o, do, m, l, n_heads):
        b, lq, lkv, dh, mask = _check_qkv(self.name, q, k, v, mask, n_heads)
        o = check_like("o", o, q.shape, q.dtype, q.device)
        do = check_like("do", do, q.shape, q.dtype, q.device)
        m = check_like("m", m, (b, n_heads, lq), torch.float32, q.device)
        l = check_like("l", l, (b, n_heads, lq), torch.float32, q.device)
        ins = [t.contiguous() for t in (q, k, v)] + [mask, o, do, m, l]
        return ins, (b, n_heads, lq, lkv, dh)


class FlashBwdDqKernel(_FlashBackwardKernel):
    """`flash_bwd_dq` in csrc/flash_bwd.cu."""

    name = "flash_bwd_dq"
    n_pointers = 9

    def __call__(self, q, k, v, mask, o, do, m, l, *, n_heads: int):
        """The forward's q, k, v, mask, output o and stats m, l, and the
        cotangent do (like q).  Returns dq at q's dtype."""
        ins, dims = self._inputs(q, k, v, mask, o, do, m, l, n_heads)
        dq = torch.empty_like(ins[0])
        self._launch(q.device, [ptr(t) for t in ins + [dq]], dims,
                     q.dtype == torch.bfloat16)
        return dq


class FlashBwdDkvKernel(_FlashBackwardKernel):
    """`flash_bwd_dkv` in csrc/flash_bwd.cu."""

    name = "flash_bwd_dkv"
    n_pointers = 11

    def __call__(self, q, k, v, mask, o, do, m, l, *, n_heads: int,
                 want_dmask: bool = True):
        """As FlashBwdDqKernel.  Returns (dk, dv) at k's dtype and dmask
        (B, Lkv) f32: the kernel's per-head rows 1e8·Σ_q ds summed over
        heads; None without a mask or when `want_dmask` is false."""
        ins, dims = self._inputs(q, k, v, mask, o, do, m, l, n_heads)
        dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
        dmh = None
        if want_dmask and mask is not None:
            b, h, _, lkv, _ = dims
            dmh = torch.empty(b, h, lkv, dtype=torch.float32, device=q.device)
        self._launch(q.device, [ptr(t) for t in ins + [dk, dv, dmh]], dims,
                     q.dtype == torch.bfloat16)
        return dk, dv, None if dmh is None else dmh.sum(dim=1)


#: the latent attention variant's widths: qk = nope + rope, and v
MLA_NOPE, MLA_ROPE, MLA_V = 128, 64, 128


def mla_varlen_plain(q, kv, k_pe, cu_seqlens, *, n_heads: int):
    """`flash_fwd_mla_varlen`'s function in plain PyTorch, one sequence at a
    time: q (T, H, nope + rope), kv (T, H, nope + v) (k_nope then v per
    head), k_pe (T, rope) shared by the heads, `cu_seqlens` (S + 1,) the
    sequences' bounds.  Causal softmax(q·kᵀ/√(nope + rope))·v in f32 within
    each sequence; returns o (T, H, v) at q's dtype."""
    t, h, dqk = q.shape
    nope = dqk - k_pe.shape[-1]
    dv = kv.shape[-1] - nope
    o = q.new_empty(t, h, dv)
    bounds = [int(x) for x in torch.as_tensor(cu_seqlens).tolist()]
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b == a:
            continue
        qs = q[a:b].float().transpose(0, 1)                    # (H, L, qk)
        k = torch.cat([kv[a:b, :, :nope].float(),
                       k_pe[a:b, None, :].float().expand(b - a, h, -1)],
                      dim=-1).transpose(0, 1)
        v = kv[a:b, :, nope:].float().transpose(0, 1)
        s = qs @ k.transpose(-2, -1) / math.sqrt(dqk)
        causal = torch.ones(b - a, b - a, dtype=torch.bool,
                            device=q.device).triu(1)
        p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
        o[a:b] = (p @ v).transpose(0, 1).to(q.dtype)
    return o


class FlashMlaVarlenKernel(Kernel):
    """`flash_fwd_mla_varlen` in csrc/flash_fwd.cu: the causal,
    variable-length prefill of latent attention at qk 192 and v 128, bf16
    on the tensor cores (models/tower.py)."""

    name = "flash_fwd_mla_varlen"
    library = "flash_fwd"
    n_pointers = 5

    def __call__(self, q, kv, k_pe, cu_seqlens, max_len: int):
        """q (T, H, 192), kv (T, H, 256), k_pe (T, 64) bf16 on one CUDA
        device; `cu_seqlens` (S + 1,) int32 there; `max_len` the longest
        sequence.  Returns o (T, H, 128) bf16."""
        t, h, dqk = q.shape
        if q.device.type != "cuda" or q.dtype != torch.bfloat16:
            raise ValueError(f"{self.name} takes bf16 CUDA tensors, got "
                             f"{q.dtype} on {q.device}")
        if (dqk != MLA_NOPE + MLA_ROPE or tuple(kv.shape) != (t, h, MLA_NOPE + MLA_V)
                or tuple(k_pe.shape) != (t, MLA_ROPE)):
            raise ValueError(f"shapes q {tuple(q.shape)}, kv {tuple(kv.shape)},"
                             f" k_pe {tuple(k_pe.shape)}: expected (T, H, 192),"
                             f" (T, H, 256), (T, 64)")
        for name_, x in (("kv", kv), ("k_pe", k_pe)):
            if x.dtype != q.dtype or x.device != q.device:
                raise ValueError(f"{name_} is {x.dtype} on {x.device}")
        if cu_seqlens.dtype != torch.int32 or cu_seqlens.device != q.device:
            raise ValueError("cu_seqlens must be int32 on q's device")
        q, kv, k_pe = q.contiguous(), kv.contiguous(), k_pe.contiguous()
        o = q.new_empty(t, h, MLA_V)
        self._launch(q.device, [ptr(x) for x in (q, kv, k_pe, cu_seqlens, o)],
                     (cu_seqlens.numel() - 1, h, t, int(max_len), dqk), True)
        return o


flash_forward_kernel = FlashForwardKernel()
flash_bwd_dq_kernel = FlashBwdDqKernel()
flash_bwd_dkv_kernel = FlashBwdDkvKernel()
flash_mla_varlen_kernel = FlashMlaVarlenKernel()
KERNELS = (flash_forward_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
           flash_mla_varlen_kernel)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernels: the forward saves q, k,
    v, the mask, o and the row stats m, l; the backward returns dq, dk, dv
    and, when the mask needs one, dmask at the mask's dtype.  c gets no
    gradient (JAX returns zeros for it: the gate has no use in a terminal
    block).  CPU tensors take the plain versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, c, n_heads):
        if q.device.type == "cpu":
            o, m, l = flash_forward_plain(q, k, v, mask, n_heads=n_heads,
                                          stats=True)
        else:
            o, m, l = flash_forward_kernel(q, k, v, mask, n_heads=n_heads,
                                           stats=True)
        ctx.save_for_backward(q, k, v, mask, o, m, l)
        ctx.n_heads = n_heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, m, l = ctx.saved_tensors
        want_dmask = mask is not None and ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            dq, dk, dv, dmask = flash_backward_plain(
                q, k, v, mask, o, do, m, l, n_heads=ctx.n_heads)
        else:
            args = (q, k, v, mask, o, do.contiguous(), m, l)
            dq = flash_bwd_dq_kernel(*args, n_heads=ctx.n_heads)
            dk, dv, dmask = flash_bwd_dkv_kernel(*args, n_heads=ctx.n_heads,
                                                 want_dmask=want_dmask)
        dmask = dmask.to(mask.dtype) if want_dmask else None
        return dq, dk, dv, dmask, None, None


def flash_scored_attention(q, k, v, mask, c, *, n_heads: int):
    """Terminal-block scored attention without materializing S; returns
    (ctx, None).  Callers check `flash_supported` first.  A call that needs
    a gradient goes through `FlashAttention`; otherwise CUDA tensors launch
    the forward kernel and CPU tensors take `flash_forward_plain`."""
    if needs_grad(q, k, v, mask):
        return FlashAttention.apply(q, k, v, mask, c, n_heads), None
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, n_heads=n_heads), None
    return flash_forward_kernel(q, k, v, mask, n_heads=n_heads), None
