"""Model registry: one builder per head type; configs pick the head."""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .heads import ConcatLinear, ConcatTrans, GridOnly, StateTransfer

_HEADS = {"concat_trans": ConcatTrans, "concat_linear": ConcatLinear,
          "grid_only": GridOnly, "state_transfer": StateTransfer}
# the (block, unify, position embeddings) each head is ported with; the
# grid-free `concat_linear` as rencecps's config names them
PORTED = {"concat_trans": (("minus", "linear", False),
                           ("minus", "linear_ln", False)),
          "concat_linear": (("minus", "linear", False),),
          "grid_only": (("realformer", "conv_multires", True),),
          "state_transfer": (("realformer", "conv", True),)}


def is_ported(cfg) -> bool:
    """Whether the port has the head and (block, unify, position
    embeddings) of ModelConfig `cfg`."""
    return (cfg.block, cfg.unify, cfg.use_position_embedding) in PORTED.get(
        cfg.head, ())


def build_model(cfg, *, device=None, seed: int = 0) -> torch.nn.Module:
    """A model for `cfg` (a ModelConfig, or an ExperimentConfig whose .model
    is used) on `device` ("cuda" unless "cpu" is asked for), initialized
    from a `torch.Generator` seeded with `seed` on that device."""
    mcfg = getattr(cfg, "model", cfg)
    if mcfg.head not in _HEADS:
        raise NotImplementedError(f"head {mcfg.head!r} is not ported yet")
    if not is_ported(mcfg):
        raise NotImplementedError(
            f"head {mcfg.head!r} with block {mcfg.block!r}, unify "
            f"{mcfg.unify!r} and position embeddings "
            f"{mcfg.use_position_embedding} is not ported yet; it is ported "
            f"with (block, unify, position embeddings) in "
            f"{PORTED[mcfg.head]}")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = _HEADS[mcfg.head](mcfg)
    model = model.to_empty(device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
