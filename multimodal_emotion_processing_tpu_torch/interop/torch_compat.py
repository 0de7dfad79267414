"""Carry JAX-package weights into the port.

The JAX package keeps parameters as nested dicts with Linear kernels stored
(in, out); the port's modules carry the reference's state-dict key names
with torch's (out, in) layout.  `from_jax_params` maps one onto the other
(the same mapping as the JAX package's `to_reference_state_dict`, kept here
as the port's own copy), so `model.load_state_dict(from_jax_params(p, cfg))`
loads JAX weights as they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.grid import STREAMS


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _arr(x) -> np.ndarray:
    # a copy: np.asarray of a framework array may be a view of its storage
    return np.array(x, dtype=np.float32, copy=True)


def _minus_block(blk, base: str, out: Dict) -> None:
    out[f"{base}.proj.weight"] = _t(blk["proj"]["w"])
    out[f"{base}.minus.weight"] = _t(blk["minus"]["w"])
    out[f"{base}.norm1.weight"] = _arr(blk["norm"]["scale"])
    out[f"{base}.norm1.bias"] = _arr(blk["norm"]["bias"])
    out[f"{base}.c"] = _arr(blk["c"])


def _grid(g, prefix: str, cfg, out: Dict) -> None:
    u = f"{prefix}unify_dimension"
    out[f"{u}.linguistic.weight"] = _t(g["unify"]["l"]["w"])
    out[f"{u}.visual.weight"] = _t(g["unify"]["v"]["w"])
    out[f"{u}.acoustic.weight"] = _t(g["unify"]["a"]["w"])
    for s, (name, _, _) in enumerate(STREAMS):
        for i in range(cfg.n_layers):
            _minus_block(g["blocks"][name][i],
                         f"{prefix}multimodal_blocks.{cfg.n_layers * s + i}", out)
    out[f"{prefix}classifier.weight"] = _t(g["classifier"]["w"])


def from_jax_params(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX-package params (a nested dict of arrays, numpy or jax) of a
    `concat_trans` model with minus blocks and the linear unify -> a
    reference-keyed state dict of CPU float32 tensors."""
    cfg = getattr(cfg, "model", cfg)
    if (cfg.head, cfg.block, cfg.unify) != ("concat_trans", "minus", "linear"):
        raise NotImplementedError(
            f"head {cfg.head!r} / block {cfg.block!r} / unify {cfg.unify!r} "
            "is not ported yet")
    out: Dict[str, np.ndarray] = {}
    for gname in ("intensity", "stimulation"):
        _grid(params[gname], f"{gname}.", cfg, out)
    out["trans"] = _arr(params["trans"])
    out["norm1.weight"] = _arr(params["norm"]["scale"])
    out["norm1.bias"] = _arr(params["norm"]["bias"])
    out["out.weight"] = _t(params["out"]["w"])
    out["out.bias"] = _arr(params["out"]["b"])
    return {k: torch.from_numpy(v) for k, v in out.items()}
