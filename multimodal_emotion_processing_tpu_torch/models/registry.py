"""Model registry: one builder per head type; configs pick the head."""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .heads import ConcatLinear, ConcatTrans, GridOnly, StateTransfer

_HEADS = {"concat_trans": ConcatTrans, "concat_linear": ConcatLinear,
          "grid_only": GridOnly, "state_transfer": StateTransfer}
BLOCKS = ("minus", "realformer")
# the unifies each grid head runs in JAX (models/grid.py, heads.py): the
# pair and paragraph heads take one (B, L, dm) visual input, the robot head
# its three resolution slots; `concat_linear` has no grid and ignores its
# block, unify and position fields
UNIFIES = {"concat_trans": ("linear", "linear_ln", "conv"),
           "state_transfer": ("linear", "linear_ln", "conv"),
           "grid_only": ("conv_multires",)}


def check_combination(cfg) -> None:
    """Raise ValueError unless ModelConfig `cfg` is a combination the JAX
    package builds and runs: `concat_linear` with any fields; the other
    heads with block `minus` or `realformer` and the unifies in `UNIFIES`,
    with or without position embeddings."""
    if cfg.head not in _HEADS:
        raise ValueError(f"unknown head {cfg.head!r}; the heads are "
                         f"{sorted(_HEADS)}")
    if cfg.head == "concat_linear":
        return
    if cfg.block not in BLOCKS or cfg.unify not in UNIFIES[cfg.head]:
        raise ValueError(
            f"head {cfg.head!r} with block {cfg.block!r} and unify "
            f"{cfg.unify!r}: head {cfg.head!r} takes block in {BLOCKS} and "
            f"unify in {UNIFIES[cfg.head]}, with or without position "
            "embeddings")


def build_model(cfg, *, device=None, seed: int = 0) -> torch.nn.Module:
    """A model for `cfg` (a ModelConfig, or an ExperimentConfig whose .model
    is used) on `device` ("cuda" unless "cpu" is asked for), initialized
    from a `torch.Generator` seeded with `seed` on that device."""
    mcfg = getattr(cfg, "model", cfg)
    check_combination(mcfg)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = _HEADS[mcfg.head](mcfg)
    model = model.to_empty(device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
