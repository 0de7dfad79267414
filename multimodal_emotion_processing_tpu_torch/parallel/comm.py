"""Collectives of the port's parallel paths over `torch.distributed`, and
the autograd functions that carry them through a backward.

JAX's GSPMD inserts these collectives and their transposes itself; here
each is written out, with the backward its use needs:

  * `reduce_from` (Megatron's g): a SUM all-reduce forward, the identity
    backward.  A row-parallel product or a psum softmax ends in one: the
    output is replicated, so every rank already holds its whole cotangent,
    and summing it again would make the gradients group-size times too
    large;
  * `copy_to` (Megatron's f): the identity forward, a SUM all-reduce
    backward.  A replicated tensor that feeds rank-local partial work (the
    query of a kv-sharded softmax, a column-parallel product, a gate every
    rank reads) gets its gradient summed from the ranks' parts;
  * `gather_from`: an all-gather along a dim forward; backward, the rank's
    own chunk of the cotangent (downstream is replicated, so each rank's
    cotangent is already whole);
  * `split_to`: the rank's own chunk forward; an all-gather of the
    cotangents backward;
  * `ring_shift`: tensors sent to the next rank of the group and received
    from the previous (JAX's `ppermute` by +1); backward, the cotangents go
    the other way round the ring (its transpose).

Every function takes the process group of one mesh axis.  Gloo drives its
collectives from the host and cannot send a CUDA tensor point to point: in
the gloo branch alone (`_staged`) a CUDA tensor goes through a host copy
for every collective.  NCCL never stages through the host.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _staged(group, t: torch.Tensor) -> bool:
    """Whether this collective stages `t` through a host copy: a CUDA tensor
    on a gloo group (gloo runs on the host)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM, *,
               inplace: bool = False) -> torch.Tensor:
    """A reduced copy of `t` over `group`, or `t` itself reduced in place
    (no autograd)."""
    out = t.detach() if inplace else t.detach().clone()
    if _staged(group, out):
        host = out.cpu()
        dist.all_reduce(host, op=op, group=group)
        out.copy_(host)
    else:
        dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order (no
    autograd)."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    staged = _staged(group, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if staged else out


def chunk_of(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous chunk of `t` along `dim`."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not divide "
                         f"the group of {n} ranks")
    return t.chunk(n, dim=dim)[dist.get_rank(group)]


def send_recv_ring(tensors: Sequence[torch.Tensor], group,
                   step: int) -> List[torch.Tensor]:
    """Each tensor sent to the rank `step` places on round the group's ring
    and received from the rank `step` places back (no autograd)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    outs, ops, copies = [], [], []
    for t in tensors:
        send = t.detach().contiguous()
        staged = _staged(group, send)
        if staged:
            send = send.cpu()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        copies.append((recv, t.device if staged else None))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for recv, dev in copies:
        outs.append(recv if dev is None else recv.to(dev))
    return outs


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.group, ctx.dim).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk_of(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(send_recv_ring(tensors, group, +1))

    @staticmethod
    def backward(ctx, *grads):
        # every rank sends as many tensors as it received: a missing
        # cotangent (the mask's) travels as zeros of its shape
        grads = [torch.zeros(s, dtype=d, device=dev) if g is None else g
                 for g, (s, d, dev) in zip(grads, ctx.like)]
        back = send_recv_ring(grads, ctx.group, -1)
        return (None, *(g if need else None for g, need
                        in zip(back, ctx.needs_input_grad[1:])))


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _SplitTo.apply(x, group, dim)


def ring_shift(tensors: Sequence[torch.Tensor], group) -> tuple:
    """The tensors one hop round the ring (to rank + 1, from rank − 1), in
    one exchange; differentiable in every floating tensor."""
    return _RingShift.apply(group, *tensors)
