"""Flash (online-softmax) attention for terminal blocks, forward only.

The kernel is csrc/flash_fwd.cu, written by hand in CUDA C++ for Hopper.  It
replaces the JAX package's two forward Pallas kernels
(ops/flash_attention.py `_flash_forward_whole` and `_flash_forward`): one
kernel walks kv tiles of at most 64 keys with the running max and sum in f32,
so every kv length, from one key to thousands, takes the same loop.  The
source's header says what bounds it on the card.

Terminal blocks only: scores_prev is None and the scores are not emitted, so
S is never materialized.  The mask is the reference's finite 1e8 penalty, and
columns past Lkv are skipped inside the kernel instead of zero-padded: a
fully masked row is then uniform over its real keys, as the plain path has
it.  The JAX wrapper pads kv to a multiple of 128 and averages such a row
over the padded length; the port does not copy that.

`flash_scored_attention` launches the kernel for CUDA tensors and takes the
plain PyTorch version only for CPU tensors.  The backward kernels belong to
training and are not ported yet, so a call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .attention import _scored_attention_xla

MAX_HEAD_DIM = 256


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


def flash_forward_plain(q, k, v, mask, *, n_heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: softmax(q·kᵀ/√dh − 1e8(1−mask))·v
    accumulated in f32, returned at the input dtype."""
    return _scored_attention_xla(q, k, v, mask, None, None, n_heads=n_heads)[0]


class FlashForwardKernel:
    """ctypes binding of `flash_fwd` in csrc/flash_fwd.cu.

    `launches` counts the kernel launches this wrapper made; nothing else
    changes it except `reset()`."""

    name = "flash_fwd"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._fn = None

    def reset(self) -> None:
        with self._lock:
            self.launches = 0

    def _bind(self):
        if self._fn is None:
            from ..utils import native

            fn = native.load(self.name).flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], *, n_heads: int) -> torch.Tensor:
        """q (B, Lq, D), k/v (B, Lkv, D) on one CUDA device, f32 or bf16;
        mask None or (B, Lkv).  Returns o (B, Lq, D) at q's dtype."""
        if q.device.type != "cuda":
            raise ValueError(f"flash_fwd runs on CUDA tensors, got {q.device}")
        if q.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
        if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
            raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                             f"v {tuple(v.shape)}: expected (B, L, D)")
        b, lq, d = q.shape
        lkv = k.shape[1]
        if k.shape[0] != b or k.shape[2] != d or d % n_heads:
            raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                             f"not share (B, D) with D divisible by {n_heads}")
        dh = d // n_heads
        if not 1 <= dh <= MAX_HEAD_DIM:
            raise ValueError(f"head width {dh} outside 1..{MAX_HEAD_DIM}")
        for name, t in (("k", k), ("v", v)):
            if t.dtype != q.dtype or t.device != q.device:
                raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                                 f"{q.dtype} on {q.device}")
        if mask is not None:
            if tuple(mask.shape) != (b, lkv) or mask.device != q.device:
                raise ValueError(f"mask {tuple(mask.shape)} on {mask.device}: "
                                 f"expected ({b}, {lkv}) on {q.device}")
            mask = mask.to(torch.float32).contiguous()
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = torch.empty_like(q)
        fn = self._bind()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    mask.data_ptr() if mask is not None else None,
                    o.data_ptr(), b, n_heads, lq, lkv, dh,
                    int(q.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"flash_fwd launch failed with CUDA error {rc}")
        with self._lock:
            self.launches += 1
        return o


flash_forward_kernel = FlashForwardKernel()


def flash_scored_attention(q, k, v, mask, c, *, n_heads: int):
    """Terminal-block scored attention without materializing S; returns
    (ctx, None).  Callers check `flash_supported` first.  CUDA tensors
    launch the kernel; CPU tensors take `flash_forward_plain`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, mask)):
        raise NotImplementedError(
            "the flash backward kernels are not ported yet: run the forward "
            "under torch.no_grad() or use impl='xla' for training")
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, n_heads=n_heads), None
    return flash_forward_kernel(q, k, v, mask, n_heads=n_heads), None
