"""Model registry: one builder per head type; configs pick the head."""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .heads import ConcatTrans

_HEADS = {"concat_trans": ConcatTrans}


def build_model(cfg, *, device=None, seed: int = 0) -> torch.nn.Module:
    """A model for `cfg` (a ModelConfig, or an ExperimentConfig whose .model
    is used) on `device` ("cuda" unless "cpu" is asked for), initialized
    from a `torch.Generator` seeded with `seed` on that device."""
    mcfg = getattr(cfg, "model", cfg)
    if mcfg.head not in _HEADS:
        raise NotImplementedError(f"head {mcfg.head!r} is not ported yet")
    if (mcfg.block, mcfg.unify, mcfg.use_position_embedding) != (
            "minus", "linear", False):
        raise NotImplementedError(
            f"block {mcfg.block!r} with unify {mcfg.unify!r} is not ported "
            "yet; this slice has the minus block with the linear unify")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = _HEADS[mcfg.head](mcfg)
    model = model.to_empty(device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
