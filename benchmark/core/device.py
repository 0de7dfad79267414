"""The card: the check that it is there, its name and power limit, the
float32 settings a run has, and its peak memory."""

from __future__ import annotations

import subprocess
import sys

import torch


class NoCard(RuntimeError):
    """The run asked for more CUDA cards than this machine has."""


def require_cards(n: int) -> None:
    """A run measures the card: with none, or fewer than the cell asks
    for, it fails and never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures an NVIDIA GPU and has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} CUDA devices; "
                     f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def power_line() -> str:
    """`nvidia-smi`'s name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def set_float32(tf32: bool) -> None:
    """Whether float32 products may run in TF32: off for the program and
    its reference (the configurations state float32), on only for the
    reference's lower-precision control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def describe(device, count: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
