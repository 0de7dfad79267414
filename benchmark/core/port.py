"""What the benchmark takes from the program under test, the port
`multimodal_emotion_processing_tpu_torch`: its public entry points, its
configurations, and its kernels' launch counters.  Nothing else of the
program is read; the JAX package is never imported."""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict

from .spec import ROOT

PACKAGE = "multimodal_emotion_processing_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_emotion_processing_tpu")


class NotInCheckout(RuntimeError):
    """The port was not found in the checkout the benchmark runs from."""


def import_port():
    """The port's package, from this checkout and nowhere else."""
    try:
        pkg = importlib.import_module(PACKAGE)
    except ImportError as e:
        raise NotInCheckout(f"the program under test ({PACKAGE}) is not in "
                            f"this checkout: {e}") from e
    where = Path(pkg.__file__).resolve()
    if ROOT not in where.parents:
        raise NotInCheckout(f"{PACKAGE} was imported from {where}, outside "
                            f"the checkout {ROOT}")
    return pkg


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is, whole, one the benchmark must never load: JAX and the JAX
    package (whose name the port's begins with)."""
    return sorted({name.split(".")[0] for name in modules}
                  & set(FORBIDDEN))


def experiment(doc: dict):
    """The port's ExperimentConfig that a configuration file states: its
    registered base, every model and train field as the file gives it."""
    from multimodal_emotion_processing_tpu_torch import configs

    exp = configs.with_overrides(configs.get(doc["registry"]),
                                 {"model": doc["model"], "train": doc["train"]})
    for section in ("model", "train"):
        got = getattr(exp, section)
        for k, v in doc[section].items():
            have = getattr(got, k)
            if (list(have) if isinstance(have, tuple) else have) != v:
                raise ValueError(f"{section}.{k}: the file states {v!r}, the "
                                 f"port's config resolved to {have!r}")
    return exp


def load_weights(model, weights: Dict) -> None:
    """The benchmark's weights into a port model whose state dict has the
    same names and shapes, or a ValueError naming the difference."""
    sd = model.state_dict()
    if set(sd) != set(weights):
        raise ValueError(
            f"the port's model and the reference differ in their weights: "
            f"only the port has {sorted(set(sd) - set(weights))[:5]}, only "
            f"the reference {sorted(set(weights) - set(sd))[:5]}")
    for k, v in weights.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: the port's shape {tuple(sd[k].shape)}, "
                             f"the reference's {tuple(v.shape)}")
    model.load_state_dict(weights)


def kernel_counters() -> Dict[str, int]:
    """Launches so far of every hand-written kernel the port counts
    (`ops.cuda_binding.Kernel.launches`)."""
    from multimodal_emotion_processing_tpu_torch.ops import (
        flash_attention, fused_block, pallas_attention)

    out = {}
    for mod in (pallas_attention, fused_block, flash_attention):
        for k in getattr(mod, "KERNELS", ()):
            out[k.name] = k.launches
    return out
