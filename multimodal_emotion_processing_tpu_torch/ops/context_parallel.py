"""Context-parallel (sequence-sharded) residual-score attention
(ops/context_parallel.py of the JAX package), over `torch.distributed`.

The reference bounds its sequences (<= 275 tokens), so CP is off by
default; it is the scaling path for artificially long sequences.  The
residual-score chain needs every block to emit its masked scores, so a
psum-mode block keeps S sharded over the kv axis, each rank owning its kv
block of S, and computes the global softmax with collectives:

    local:   S_i = Q·K_iᵀ/√d + c·S_prev,i − 1e8(1−mask_i)
    global:  m = max_i(rowmax S_i);  Z = Σ_i Σ exp(S_i − m)
    output:  ctx = Σ_i exp(S_i − m)·V_i / Z          (replicated)

The ring mode shards Q on its rows and passes the K/V/mask blocks round
the ranks (`ring_scored_attention`).

Every rank runs the model on the same (replicated) inputs and returns the
same outputs; inside the attention each takes its shard.  The gradients
are the single device's: the replicated query and gate enter through
`comm.copy_to` (their cotangents summed over the ranks), the SUM
all-reduces of Z and e·V have the identity backward (`comm.reduce_from`:
the cotangent of a replicated output already reaches every rank, and a
backward that summed again would return them world-size times too large),
and the emitted S is all-gathered whole (`comm.gather_from`), so that the
next block takes its shard of a plain tensor.  No kernel runs here: plain
products and collectives, as in JAX.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import comm
from .attention import MASK_PENALTY, merge_heads, split_heads

# The ambient CP binding of `impl="cp"`: (mesh, axis name, mode), set by
# `cp_context` and read by ops.attention.scored_attention at each call.
_ACTIVE: list = []


@contextlib.contextmanager
def cp_context(mesh, axis: str = "context", mode: str = "psum"):
    """Bind the mesh and axis that `impl="cp"` attention runs over:

        mesh = world_mesh((world_size,), ("context",))
        with cp_context(mesh):                # or mode="ring"
            logits = model(batch, impl="cp")

    mode "psum": Q replicated, kv sharded, the global softmax by MAX and
    SUM all-reduces (any sequence length).  mode "ring": Q sharded on its
    rows, the kv blocks passed neighbour to neighbour
    (`ring_scored_attention`); Lq and Lkv must divide the axis size."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    if mode not in ("psum", "ring"):
        raise ValueError(f"unknown cp mode {mode!r}")
    _ACTIVE.append((mesh, axis, mode))
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def _world_cp(device):
    from ..parallel.mesh import world, world_mesh, world_size

    with world(device):
        with cp_context(world_mesh((world_size(),), ("context",), device)):
            yield


def ensure_cp(impl: str, *, device=None):
    """A context manager for entry points: a no-op unless `impl == "cp"`
    with no cp_context active, in which case it binds a psum-mode
    ("context",) mesh over every rank of the world (a world of one rank,
    made on `device` for the block, is JAX's one-device, degenerate CP).
    Callers wanting ring mode or another mesh enter cp_context
    themselves."""
    if impl != "cp" or _ACTIVE:
        return contextlib.nullcontext()
    return _world_cp(device)


def current_cp():
    if not _ACTIVE:
        raise RuntimeError(
            "impl='cp' requires an active cp_context(mesh): wrap the model "
            "call, `with cp_context(mesh): model(batch, impl='cp')`")
    return _ACTIVE[-1]


def _defaults(q, k, mask, scores_prev, n_heads):
    b, lq, _ = q.shape
    lkv = k.shape[1]
    if mask is None:
        mask = torch.ones((b, lkv), dtype=q.dtype, device=q.device)
    if scores_prev is None:
        scores_prev = torch.zeros((b, n_heads, lq, lkv), dtype=torch.float32,
                                  device=q.device)
    return mask, scores_prev


def scored_attention_cp(q, k, v, mask: Optional[torch.Tensor],
                        scores_prev: Optional[torch.Tensor], c, *,
                        n_heads: int, mesh, axis: str = "context"):
    """psum-mode CP attention of the (replicated) q (B, Lq, D), k, v
    (B, Lkv, D), a 2-D key mask and S_prev (B, H, Lq, Lkv).  A kv length
    that does not divide the axis is padded with zero keys of mask 0 (the
    −1e8 penalty removes them from the softmax, as it does real masked
    keys) and the scores are sliced back.  Returns (ctx (B, Lq, D)
    replicated, scores (B, H, Lq, Lkv) whole)."""
    lkv = k.shape[1]
    mask, scores_prev = _defaults(q, k, mask, scores_prev, n_heads)
    if mask.ndim != 2:
        raise NotImplementedError("CP attention supports 2-D key masks")
    group = mesh.group(axis)
    pad = (-lkv) % mesh.shape[axis]
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
        scores_prev = F.pad(scores_prev, (0, pad))
    acc = torch.promote_types(q.dtype, torch.float32)
    qh = split_heads(comm.copy_to(q, group), n_heads).to(acc)
    kh = split_heads(comm.split_to(k, group, 1), n_heads).to(acc)
    vh = split_heads(comm.split_to(v, group, 1), n_heads).to(acc)
    ml = comm.chunk_of(mask, group, 1).to(acc)
    sl = comm.split_to(scores_prev, group, 3)
    s = (qh @ kh.transpose(-2, -1)) / math.sqrt(qh.shape[-1])
    s = s + comm.copy_to(c, group).to(acc) * sl
    s = s - MASK_PENALTY * (1.0 - ml[:, None, None, :])
    # the stabiliser alone: softmax is shift-invariant, so the detached max
    # is exact (JAX stop_gradients it; pmax has no derivative)
    m = comm.all_reduce(s.detach().amax(dim=-1, keepdim=True), group,
                        dist.ReduceOp.MAX)
    e = torch.exp(s - m)
    z = comm.reduce_from(e.sum(dim=-1, keepdim=True), group)
    ctx = comm.reduce_from(e @ vh, group) / z
    scores = comm.gather_from(s, group, 3)
    if pad:
        scores = scores[..., :lkv]
    return merge_heads(ctx.to(q.dtype)), scores


def ring_scored_attention(q, k, v, mask: Optional[torch.Tensor],
                          scores_prev: Optional[torch.Tensor], c, *,
                          n_heads: int, mesh, axis: str = "context",
                          emit_scores: bool = True):
    """Ring attention with the residual-score chain (JAX
    `ring_scored_attention`): Q sharded on its rows over `axis`, each rank
    starting with its own K/V/mask block; the blocks go one hop round the
    ring per step (`comm.ring_shift`, whose backward sends the cotangents
    the other way), n − 1 hops, and each rank runs an online softmax over
    the blocks as they arrive, so only its Lq/n query rows materialise.
    Each rank owns the whole score rows of its queries: S is built
    q-sharded, the layout the next block takes its S_prev in.
    `emit_scores=False` (terminal blocks) builds no score accumulator and
    returns (ctx, None).  Lq and Lkv must divide the axis size.  Returns
    (ctx (B, Lq, D), scores (B, H, Lq, Lkv) or None), both whole."""
    b, lq, _ = q.shape
    lkv = k.shape[1]
    n = mesh.shape[axis]
    if lq % n or lkv % n:
        raise ValueError(f"ring CP needs Lq ({lq}) and Lkv ({lkv}) divisible "
                         f"by the '{axis}' axis size ({n})")
    mask, scores_prev = _defaults(q, k, mask, scores_prev, n_heads)
    if mask.ndim != 2:
        raise NotImplementedError("ring CP attention supports 2-D key masks")
    group = mesh.group(axis)
    me = dist.get_rank(group)
    blk = lkv // n
    acc = torch.promote_types(q.dtype, torch.float32)
    qh = split_heads(comm.split_to(q, group, 1), n_heads).to(acc)
    kl = comm.split_to(k, group, 1)
    vl = comm.split_to(v, group, 1)
    ml = comm.chunk_of(mask, group, 1)
    sl = comm.split_to(scores_prev, group, 2)   # our query rows, every column
    cg = comm.copy_to(c, group).to(acc)
    inv_sqrt = 1.0 / math.sqrt(qh.shape[-1])
    shape = qh.shape[:3] + (1,)
    m_run = torch.full(shape, -math.inf, dtype=acc, device=q.device)
    z_run = torch.zeros(shape, dtype=acc, device=q.device)
    out = torch.zeros_like(qh)
    columns = [None] * n
    for t in range(n):
        # after t hops of send-to-(i+1), rank i holds block (i - t) % n
        j = (me - t) % n
        kh = split_heads(kl, n_heads).to(acc)
        vh = split_heads(vl, n_heads).to(acc)
        s_blk = (qh @ kh.transpose(-2, -1)) * inv_sqrt
        s_blk = s_blk + cg * sl[..., j * blk:(j + 1) * blk]
        s_blk = s_blk - MASK_PENALTY * (1.0 - ml.to(acc)[:, None, None, :])
        if emit_scores:
            columns[j] = s_blk
        m_new = torch.maximum(m_run, s_blk.amax(dim=-1, keepdim=True))
        scale = torch.exp(m_run - m_new)
        e = torch.exp(s_blk - m_new)
        z_run = z_run * scale + e.sum(dim=-1, keepdim=True)
        out = out * scale + e @ vh
        m_run = m_new
        if t < n - 1:
            kl, vl, ml = comm.ring_shift((kl, vl, ml), group)
    ctx = comm.gather_from(merge_heads((out / z_run).to(q.dtype)), group, 1)
    if not emit_scores:
        return ctx, None
    return ctx, comm.gather_from(torch.cat(columns, dim=-1), group, 2)
