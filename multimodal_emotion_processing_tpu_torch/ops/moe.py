"""The routed experts of a sparse mixture-of-experts layer (models/tower.py):
a grouped SwiGLU over the (token, choice) rows sorted by expert, and the
combination of each token's rows.

The kernels are written by hand in CUDA C++ (csrc/moe.cu, whose header
says what bounds them), all experts in one launch a product:

- `moe_gate_up`: h = silu(x·W_gateᵀ) * (x·W_upᵀ) of each sorted row, x read
  through the rows' token index, the gate and up weights of an expert one
  (2F, K) tensor interleaved in groups of eight rows (`interleave_gate_up`);
- `moe_down`: y = w · (h·W_downᵀ), the row's routing weight applied in f32;
- `moe_combine`: out += shared + Σ_k y[pos[t, k]] into the f32 residual,
  the k rows in the router's order, then the shared expert's: a fixed
  order, no atomics.

`sort_by_expert` makes the kernels' row order from a router's choice;
`routed_plain` and `combine_plain` are the kernels' functions in plain
PyTorch, the tower's path on the CPU (models/tower.py).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_binding import Kernel, launch_stream, ptr

#: rows of the gate and up weights that alternate in W13
GROUP = 8


def interleave_gate_up(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """(F, K) gate and up rows as one (2F, K) tensor, alternating in groups
    of GROUP rows: gate rows 0-7, up rows 0-7, gate rows 8-15, ..."""
    f, k = gate.shape
    return torch.stack([gate.reshape(f // GROUP, GROUP, k),
                        up.reshape(f // GROUP, GROUP, k)], dim=1).reshape(2 * f, k)


def split_gate_up(w13: torch.Tensor):
    """The (gate, up) rows of an interleaved (2F, K) tensor."""
    two_f, k = w13.shape
    g = w13.reshape(two_f // (2 * GROUP), 2, GROUP, k)
    return g[:, 0].reshape(-1, k), g[:, 1].reshape(-1, k)


def sort_by_expert(choice, weights, n_experts: int):
    """The (token, choice) rows of a router's `choice` (T, k) sorted by
    expert, stably: (rows (T k,) int32 the token of each sorted row,
    offsets (E + 1,) int32 each expert's first sorted row, row_w (T k,)
    f32 each sorted row's weight, pos (T, k) int32 the sorted row of each
    (token, choice), counts (E,) int64 each expert's rows).  Torch ops,
    no host sync."""
    t, k = choice.shape
    flat = choice.reshape(-1)
    experts, order = torch.sort(flat, stable=True)
    # the bounds from the sorted ids: torch.bincount on a card reads the
    # input's max back to the host, a wait in every layer
    bounds = torch.searchsorted(experts, torch.arange(
        n_experts + 1, dtype=experts.dtype, device=flat.device))
    offsets = bounds.int()
    counts = bounds.diff()
    rows = torch.div(order, k, rounding_mode="floor").int()
    row_w = weights.reshape(-1)[order].float().contiguous()
    pos = torch.empty(t * k, dtype=torch.int32, device=flat.device)
    pos[order] = torch.arange(t * k, dtype=torch.int32, device=flat.device)
    return rows, offsets, row_w, pos.view(t, k), counts


def routed_plain(x, rows, offsets, w13, w2, row_w):
    """Both grouped products in plain PyTorch, expert by expert, f32
    accumulation: y (M, D) at x's dtype for the sorted rows."""
    y = x.new_zeros(rows.shape[0], w2.shape[1])
    bounds = [int(v) for v in offsets.tolist()]
    for e, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        if b == a:
            continue
        xe = x[rows[a:b].long()].float()
        gate, up = split_gate_up(w13[e].float())
        h = (F.silu(xe @ gate.t()) * (xe @ up.t())).to(x.dtype)
        y[a:b] = ((h.float() @ w2[e].float().t())
                  * row_w[a:b, None].float()).to(x.dtype)
    return y


def combine_plain(out, y, pos, shared):
    """out (T, D) f32 += Σ_k y[pos[:, k]] (in k's order) + shared."""
    s = torch.zeros_like(out)
    for j in range(pos.shape[1]):
        s += y[pos[:, j].long()].float()
    if shared is not None:
        s += shared.float()
    out += s
    return out


class _MoeKernel(Kernel):
    library = "moe"
    argtypes = ()

    def _bind(self):
        if self._fn is None:
            from ..utils import native

            fn = getattr(native.load(self.library), self.name)
            fn.argtypes = list(self.argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _call(self, device, *args) -> None:
        stream = launch_stream(device)
        with torch.cuda.device(device):
            rc = self._bind()(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {rc}")
        self._count(stream=stream)


_P, _I = ctypes.c_void_p, ctypes.c_int


def _check(name, **tensors):
    dev = None
    for k, t in tensors.items():
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be a contiguous CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {k} is on {t.device}, not {dev}")
        dev = t.device
    return dev


class MoeGateUpKernel(_MoeKernel):
    """`moe_gate_up` in csrc/moe.cu."""

    name = "moe_gate_up"
    argtypes = (_P,) * 5 + (_I,) * 4

    def __call__(self, x, rows, offsets, w13):
        """x (T, K) bf16; rows (M,) int32; offsets (E + 1,) int32; w13
        (E, 2F, K) bf16 interleaved.  Returns h (M, F) bf16."""
        dev = _check(self.name, x=x, rows=rows, offsets=offsets, w13=w13)
        e, n, k = w13.shape
        h = x.new_empty(rows.shape[0], n // 2)
        self._call(dev, ptr(x), ptr(rows), ptr(offsets), ptr(w13), ptr(h),
                   rows.shape[0], n, k, e)
        return h


class MoeDownKernel(_MoeKernel):
    """`moe_down` in csrc/moe.cu."""

    name = "moe_down"
    argtypes = (_P,) * 5 + (_I,) * 4

    def __call__(self, h, offsets, w2, row_w):
        """h (M, F) bf16 sorted; w2 (E, D, F) bf16; row_w (M,) f32.
        Returns y (M, D) bf16."""
        dev = _check(self.name, h=h, offsets=offsets, w2=w2, row_w=row_w)
        e, n, k = w2.shape
        y = h.new_empty(h.shape[0], n)
        self._call(dev, ptr(h), ptr(offsets), ptr(w2), ptr(row_w), ptr(y),
                   h.shape[0], n, k, e)
        return y


class MoeCombineKernel(_MoeKernel):
    """`moe_combine` in csrc/moe.cu."""

    name = "moe_combine"
    argtypes = (_P,) * 4 + (_I,) * 3

    def __call__(self, out, y, pos, shared):
        """out (T, D) f32, added to in place; y (T k, D) bf16; pos (T, k)
        int32; shared (T, D) bf16 or None."""
        ts = dict(out=out, y=y, pos=pos)
        if shared is not None:
            ts["shared"] = shared
        dev = _check(self.name, **ts)
        t, d = out.shape
        self._call(dev, ptr(y), ptr(pos), ptr(shared), ptr(out), t, d,
                   pos.shape[1])
        return out


gate_up_kernel = MoeGateUpKernel()
down_kernel = MoeDownKernel()
combine_kernel = MoeCombineKernel()
KERNELS = (gate_up_kernel, down_kernel, combine_kernel)
