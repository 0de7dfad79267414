"""The whole `minus` attention block in one kernel: `impl="pallas_fused"`
(named after the JAX package's ops/fused_block.py), forward and backward.

csrc/fused_block.cu `fused_block` replaces the JAX package's whole-block
Pallas kernel (ops/fused_block.py `_forward`): score-chained attention, the
output projection, the reference's Linear over concat[q, proj(ctx)] as two
products on the split weight, and LayerNorm, in one launch:

    S   = q·kᵀ/√dh (+ c·S_prev) − 1e8·(1 − mask)     f32, post-mask
    ctx = softmax(S)·v
    out = LN(q·W_minus[:, :D]ᵀ + (ctx·W_projᵀ)·W_minus[:, D:]ᵀ)   at q's dtype

Where one block can hold a query-row tile with every head (head width up to
16, D up to 96: mosei_trans) and the grid is not a few items with long keys,
it launches one such block per tile, its heads' warps in parallel and the
epilogue in the block's own shared memory (the "tile" path); otherwise as
thread-block clusters, one block per head of a tile, ctx and x passing
between them through distributed shared memory (the "cluster" path).  Both
run each head's attention through scored_fwd's own per-head body
(csrc/scored_head.cuh), so S is bit-identical to csrc/scored_fwd.cu's, and
P·V and the epilogue's three products on the tensor cores in split-TF32
form.  Like scored_fwd it has four variants, S_prev given or not
times S emitted or not; the JAX kernel always reads S_prev (zeros when there
is none) and always writes S.  It can also write each head's row stats m, l
as scored_fwd does.  The weights keep torch's (out, in) layout, as
`MinusBlock` stores them.

`FusedMinusBlock` stands in for JAX `_make`'s custom VJP.  Its backward
follows the JAX one: x and y are recomputed from ctx (the kernel's
residual on the card, the plain forward's on the CPU), then the LayerNorm,
combine and projection backward as plain products, then the attention's
backward through the score-chained backward kernels of
ops/pallas_attention.py (`scored_backward_kernel`, which reads the
forward's row stats and so sweeps the keys once; `scored_backward_plain`
on the CPU), from the emitted S, or rebuilding s where the block emitted
none.  CUDA tensors launch the kernels and CPU tensors take the plain
versions; there is no other fallback.
"""

from __future__ import annotations

from typing import Optional

import ctypes

import torch
import torch.nn.functional as F

from .cuda_binding import check_like, check_qkv, needs_grad
from .pallas_attention import (_check_gate, _check_grad_free, _VariantKernel,
                               scored_backward_kernel, scored_backward_plain,
                               scored_forward_plain)

LN_EPS = 1e-5
MAX_DIM = 1024


def _plain_parts(q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w, ln_b,
                 *, n_heads: int, emit_scores: bool):
    """(out at q's dtype, S f32 or None, ctx at q's dtype), accumulated in
    f32 (or wider)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    d = q.shape[-1]
    ctx, scores = scored_forward_plain(q.to(acc), k.to(acc), v.to(acc), mask,
                                       scores_prev, c, n_heads=n_heads,
                                       emit_scores=emit_scores)
    w = minus_w.to(acc)
    y = F.linear(q.to(acc), w[:, :d]) + F.linear(
        F.linear(ctx, proj_w.to(acc)), w[:, d:])
    out = F.layer_norm(y, (d,), ln_w.to(acc), ln_b.to(acc), LN_EPS)
    return out.to(q.dtype), scores, ctx.to(q.dtype)


def fused_block_plain(q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w,
                      ln_b, *, n_heads: int, emit_scores: bool = True):
    """The kernel's function in plain PyTorch, accumulated in f32: scored
    attention through `scored_forward_plain`, then the epilogue of
    `MinusBlock.forward`.  Returns (out at q's dtype, S (B, H, Lq, Lkv) f32
    or None)."""
    out, scores, _ = _plain_parts(q, k, v, mask, scores_prev, c, proj_w,
                                  minus_w, ln_w, ln_b, n_heads=n_heads,
                                  emit_scores=emit_scores)
    return out, scores


PATHS = ("tile", "cluster")


class FusedBlockKernel(_VariantKernel):
    """`fused_block` in csrc/fused_block.cu; `variant_launches` counts per
    (has S_prev, emits S), `path_launches` per path the kernel's plan took:
    "tile" (one block holds every head of its row tile) or "cluster" (a
    cluster of one block per head)."""

    name = library = "fused_block"
    n_pointers = 14

    def __init__(self):
        super().__init__()
        self.path_launches = dict.fromkeys(PATHS, 0)
        self._paths = {}

    def reset(self) -> None:
        super().reset()
        with self._lock:
            self.path_launches = dict.fromkeys(PATHS, 0)

    def geometry(self, b: int, n_heads: int, lq: int, lkv: int, dh: int,
                 dtype=torch.float32) -> dict:
        """The launch a call of these sizes makes, from the kernel's own
        plan: its path, the cluster size (1 on the tile path), the query
        rows of a block's tile, the blocks of the grid, the warps of a block
        and each block's dynamic shared memory in bytes."""
        fn = self._bind_geometry()
        out = (ctypes.c_int * 6)()
        rc = fn(b, n_heads, lq, lkv, dh, int(dtype == torch.bfloat16), out)
        if rc != 0:
            raise RuntimeError(f"fused_block_geometry failed with CUDA error {rc}")
        return dict(path=PATHS[0] if out[4] else PATHS[1], cluster=out[0],
                    rows=out[1], blocks=out[2], warps=out[5],
                    smem_bytes=out[3])

    def _bind_geometry(self):
        from ..utils import native

        fn = native.load(self.library).fused_block_geometry
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        return fn

    def _path(self, device, dims) -> str:
        """The path a launch of these sizes takes on `device` (the plan
        reads the card's SM count), asked of the kernel once per sizes."""
        key = (device.index, dims)
        path = self._paths.get(key)
        if path is None:
            with torch.cuda.device(device):
                path = self.geometry(*dims)["path"]
            self._paths[key] = path
        return path

    def __call__(self, q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w,
                 ln_b, *, n_heads: int, emit_scores: bool = True,
                 save_ctx: bool = False, stats: bool = False):
        """q (B, Lq, D), k/v (B, Lkv, D) on one CUDA device, f32 or bf16,
        D ≤ 1024 and head width 1-256; mask None or (B, Lkv); scores_prev
        None or (B, H, Lq, Lkv) f32 with the gate c (one value on the
        device); proj_w (D, D), minus_w (D, 2D), ln_w and ln_b (D,) at q's
        dtype.  Returns (out like q, S (B, H, Lq, Lkv) f32 or None, ctx like
        q when `save_ctx`, else None), and with `stats` also the row stats
        (2, B, H, Lq) f32 (m, l) that the backward reads."""
        _check_grad_free(self.name, q, k, v, mask, scores_prev, c, proj_w,
                         minus_w, ln_w, ln_b, via="FusedMinusBlock")
        b, lq, lkv, dh, mask = check_qkv(self.name, q, k, v, mask, n_heads)
        d = q.shape[-1]
        if d > MAX_DIM:
            raise ValueError(f"{self.name} takes D up to {MAX_DIM}, got {d}")
        weights = [check_like(wname, w, shape, q.dtype, q.device)
                   for wname, w, shape in (
                       ("proj_w", proj_w, (d, d)),
                       ("minus_w", minus_w, (d, 2 * d)),
                       ("ln_w", ln_w, (d,)), ("ln_b", ln_b, (d,)))]
        if scores_prev is not None:
            scores_prev = check_like("scores_prev", scores_prev,
                                     (b, n_heads, lq, lkv), torch.float32,
                                     q.device)
        c = _check_gate(scores_prev, c, q)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
        scores = (torch.empty(b, n_heads, lq, lkv, dtype=torch.float32,
                              device=q.device) if emit_scores else None)
        ctx = torch.empty_like(q) if save_ctx else None
        row_stats = (torch.empty(2, b, n_heads, lq, dtype=torch.float32,
                                 device=q.device) if stats else None)
        dims = (b, n_heads, lq, lkv, dh)
        self._run([q, k, v, mask, scores_prev, c, *weights, out, scores, ctx,
                   row_stats], dims, (scores_prev is not None, emit_scores))
        self._count("path_launches", self._path(q.device, dims))
        return ((out, scores, ctx, row_stats) if stats
                else (out, scores, ctx))


fused_block_kernel = FusedBlockKernel()
KERNELS = (fused_block_kernel,)


def _flat(x):
    return x.reshape(-1, x.shape[-1])


class FusedMinusBlock(torch.autograd.Function):
    """The whole minus block with its backward, in place of JAX `_make`'s
    custom VJP.  The forward saves its inputs, the emitted S and, when a
    gradient is needed (`save_ctx`), ctx and, on the card, the row stats;
    the backward takes the cotangents of out and of S (None where nothing
    downstream reads them) and returns dq, dk, dv, dmask (at the mask's
    dtype, when the mask needs a
    gradient), dS_prev and dc (at c's dtype; c gets none without S_prev,
    where JAX's zeros give exactly 0), and the gradients of proj_w, minus_w
    (its two halves joined along dim 1), ln_w and ln_b in their layouts.
    Returns (out, S) when S is emitted, else out."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w,
                ln_b, n_heads, emit_scores, save_ctx):
        ctx.set_materialize_grads(False)
        stats = None
        if q.device.type == "cpu":
            out, scores, attn = _plain_parts(
                q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w, ln_b,
                n_heads=n_heads, emit_scores=emit_scores)
        elif save_ctx:
            out, scores, attn, stats = fused_block_kernel(
                q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w, ln_b,
                n_heads=n_heads, emit_scores=emit_scores, save_ctx=True,
                stats=True)
        else:
            out, scores, attn = fused_block_kernel(
                q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w, ln_b,
                n_heads=n_heads, emit_scores=emit_scores)
        ctx.save_for_backward(q, k, v, mask, scores_prev, c, proj_w, minus_w,
                              ln_w, ln_b, scores, attn if save_ctx else None,
                              stats)
        ctx.n_heads = n_heads
        return (out, scores) if emit_scores else out

    @staticmethod
    def backward(ctx, dout, dscores=None):
        (q, k, v, mask, scores_prev, c, proj_w, minus_w, ln_w, ln_b, scores,
         attn, stats) = ctx.saved_tensors
        if attn is None:
            raise RuntimeError("FusedMinusBlock saved no ctx: call it through "
                               "fused_minus_block")
        acc = torch.promote_types(q.dtype, torch.float32)
        d = q.shape[-1]
        wp, wm = proj_w.to(acc), minus_w.to(acc)
        wq, wx = wm[:, :d], wm[:, d:]
        qa, ca = q.to(acc), attn.to(acc)
        # recompute the epilogue's intermediates from ctx
        x = ca @ wp.T
        y = qa @ wq.T + x @ wx.T
        mean = y.mean(dim=-1, keepdim=True)
        var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + LN_EPS)
        xhat = (y - mean) * rstd
        # LayerNorm backward (torch semantics: biased variance)
        g_out = (torch.zeros_like(qa) if dout is None else dout.to(acc))
        g = g_out * ln_w.to(acc)
        dy = rstd * (g - g.mean(dim=-1, keepdim=True)
                     - xhat * (g * xhat).mean(dim=-1, keepdim=True))
        dln_w = (g_out * xhat).sum(dim=(0, 1))
        dln_b = g_out.sum(dim=(0, 1))
        # the minus combine and the projection, in torch's (out, in) layout
        dq_direct = dy @ wq
        dx = dy @ wx
        dminus_w = torch.cat([_flat(dy).T @ _flat(qa), _flat(dy).T @ _flat(x)],
                             dim=1)
        dctx = (dx @ wp).to(q.dtype)
        dproj_w = _flat(dx).T @ _flat(ca)
        # the attention's backward: the score-chained backward kernels
        want_dmask = mask is not None and ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            dq, dk, dv, dmask, dsprev, dc = scored_backward_plain(
                q, k, v, mask, scores_prev, c, scores, dscores, dctx,
                n_heads=ctx.n_heads)
        else:
            dq, dk, dv, dmask, dsprev, dc = scored_backward_kernel(
                q, k, v, mask, scores_prev, c, scores, dscores, dctx,
                n_heads=ctx.n_heads, out=attn, stats=stats,
                want_dmask=want_dmask)
            if dc is not None:
                dc = dc.to(c.dtype).reshape(c.shape)
        dmask = dmask.to(q.dtype).to(mask.dtype) if want_dmask else None
        return ((dq.to(acc) + dq_direct).to(q.dtype), dk, dv, dmask, dsprev,
                dc, dproj_w.to(proj_w.dtype), dminus_w.to(minus_w.dtype),
                dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype), None, None, None)


def fused_minus_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor],
                      scores_prev: Optional[torch.Tensor], c: torch.Tensor,
                      proj_w: torch.Tensor, minus_w: torch.Tensor,
                      ln_scale: torch.Tensor, ln_bias: torch.Tensor, *,
                      n_heads: int, emit_scores: bool = True):
    """The whole minus block in one kernel: returns (q', S or None).
    Drop-in for `MinusBlock.forward` with inactive dropout, with the JAX
    function's arguments, the weights in torch's layout (proj_w (D, D),
    minus_w (D, 2D), as `MinusBlock` stores them) and `emit_scores` (False
    skips the S write: a stream's last block).  `mask=None` counts as all
    ones; a 3-D mask raises, as in JAX.  Every call goes through
    `FusedMinusBlock`, which keeps the backward's ctx residual only where a
    gradient is needed."""
    if mask is not None and mask.ndim != 2:
        raise NotImplementedError("fused minus block supports 2-D key masks")
    save_ctx = needs_grad(q, k, v, mask, scores_prev, c, proj_w, minus_w,
                          ln_scale, ln_bias)
    out = FusedMinusBlock.apply(q, k, v, mask, scores_prev, c, proj_w,
                                minus_w, ln_scale, ln_bias, n_heads,
                                emit_scores, save_ctx)
    return out if emit_scores else (out, None)
