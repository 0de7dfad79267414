"""Carry JAX-package weights into the port.

The JAX package keeps parameters as nested dicts with Linear kernels stored
(in, out); the port's modules carry the reference's state-dict key names
with torch's (out, in) layout, and (out, in, 1) for the kernel-1 convs.
`from_jax_params` maps one onto the other (the same mapping, key order
included, as the JAX package's `to_reference_state_dict`, kept here as the
port's own copy), so `model.load_state_dict(from_jax_params(p, cfg))` loads
JAX weights as they are.  Ported families: `concat_trans` (minus blocks,
the linear unify, or Ren-MME's `linear_ln` unify with its names: the
unify's shared `norm1`, the blocks' `norm2`, the top `norm3`),
`concat_linear` (rencecps's grid-free head), `grid_only` (RealFormer
blocks, multi-resolution conv unify, position embeddings) and
`state_transfer` (RealFormer blocks, the bias-free conv unify, position
embeddings, the feature head).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.grid import STREAMS
from ..models.layers import minus_norm_names
from ..models.registry import is_ported


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _arr(x) -> np.ndarray:
    # a copy: np.asarray of a framework array may be a view of its storage
    return np.array(x, dtype=np.float32, copy=True)


def _conv(w) -> np.ndarray:
    return _t(w)[:, :, None]


def _ln(p, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _arr(p["scale"])
    out[f"{key}.bias"] = _arr(p["bias"])


def _minus_block(blk, base: str, out: Dict, norm: str) -> None:
    out[f"{base}.proj.weight"] = _t(blk["proj"]["w"])
    out[f"{base}.minus.weight"] = _t(blk["minus"]["w"])
    _ln(blk["norm"], f"{base}.{norm}", out)
    out[f"{base}.c"] = _arr(blk["c"])


def _realformer_block(blk, base: str, out: Dict) -> None:
    for i, k in enumerate(("wq", "wk", "wv")):
        out[f"{base}.w_qkv.{i}.weight"] = _t(blk[k]["w"])
    out[f"{base}.proj.weight"] = _t(blk["proj"]["w"])
    for nk in ("norm1", "norm2"):
        out[f"{base}.{nk}.weight"] = _arr(blk[nk]["scale"])
        out[f"{base}.{nk}.bias"] = _arr(blk[nk]["bias"])
    out[f"{base}.ffn.0.weight"] = _t(blk["ffn1"]["w"])
    out[f"{base}.ffn.0.bias"] = _arr(blk["ffn1"]["b"])
    out[f"{base}.ffn.2.weight"] = _t(blk["ffn2"]["w"])
    out[f"{base}.ffn.2.bias"] = _arr(blk["ffn2"]["b"])
    for g in ("a", "b", "c"):
        out[f"{base}.{g}"] = _arr(blk[g])


def _grid(g, prefix: str, cfg, out: Dict) -> None:
    """The grid's unify, positions and blocks; its head is the caller's."""
    u = f"{prefix}unify_dimension"
    if cfg.unify in ("linear", "linear_ln"):
        out[f"{u}.linguistic.weight"] = _t(g["unify"]["l"]["w"])
        out[f"{u}.visual.weight"] = _t(g["unify"]["v"]["w"])
        out[f"{u}.acoustic.weight"] = _t(g["unify"]["a"]["w"])
        if cfg.unify == "linear_ln":
            _ln(g["unify"]["ln"], f"{u}.norm1", out)
    elif cfg.unify == "conv":
        for ours, theirs in (("l", "linguistic"), ("v", "visual"),
                             ("a", "acoustic")):
            out[f"{u}.{theirs}.weight"] = _conv(g["unify"][ours]["w"])
    else:   # conv_multires
        for ours, theirs in (("l", "linguistic"), ("v256", "visual_256"),
                             ("v512", "visual_512"), ("v1024", "visual_1024"),
                             ("a", "acoustic")):
            out[f"{u}.{theirs}.weight"] = _conv(g["unify"][ours]["w"])
            out[f"{u}.{theirs}.bias"] = _arr(g["unify"][ours]["b"])
    if cfg.use_position_embedding:
        for ours, theirs in (("pos_l", "linguistic"), ("pos_v", "visual"),
                             ("pos_a", "acoustic")):
            out[f"{prefix}{theirs}_position.position_embeddings.weight"] = _arr(
                g[ours]["table"])
    for s, (name, _, _) in enumerate(STREAMS):
        for i in range(cfg.n_layers):
            blk = g["blocks"][name][i]
            base = f"{prefix}multimodal_blocks.{cfg.n_layers * s + i}"
            if cfg.block == "minus":
                _minus_block(blk, base, out, minus_norm_names(cfg)[0])
            else:
                _realformer_block(blk, base, out)


def _linear(p, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _t(p["w"])
    if "b" in p:
        out[f"{key}.bias"] = _arr(p["b"])


def from_jax_params(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX-package params (a nested dict of arrays, numpy or jax) of a
    ported family (`concat_trans` with minus blocks and the linear or
    `linear_ln` unify, `concat_linear`, `grid_only` with RealFormer
    blocks, the conv_multires unify and position embeddings, or
    `state_transfer` with RealFormer blocks, the conv unify and position
    embeddings) -> a reference-keyed state dict of CPU float32 tensors."""
    cfg = getattr(cfg, "model", cfg)
    if not is_ported(cfg):
        raise NotImplementedError(
            f"head {cfg.head!r} / block {cfg.block!r} / unify {cfg.unify!r} "
            "is not ported yet")
    out: Dict[str, np.ndarray] = {}
    if cfg.head == "concat_linear":
        _linear(params["intensity"], "intensity", out)
        _linear(params["stimulation"], "stimulation", out)
        out["trans"] = _arr(params["trans"])
        _ln(params["norm"], "norm", out)
        _linear(params["out"], "out", out)
    elif cfg.head == "grid_only":
        _grid(params, "", cfg, out)
        _linear(params["classifier"], "classifier", out)
    elif cfg.head == "state_transfer":
        feature = params["feature"]
        _grid(feature, "feature.", cfg, out)
        _linear(feature["fc"], "feature.fully_connected", out)
        _ln(feature["ln"], "feature.normalization", out)
        _linear(params["classifier"], "classifier", out)
        out["trans"] = _arr(params["trans"])
    else:
        for gname in ("intensity", "stimulation"):
            _grid(params[gname], f"{gname}.", cfg, out)
            _linear(params[gname]["classifier"], f"{gname}.classifier", out)
        out["trans"] = _arr(params["trans"])
        _ln(params["norm"], minus_norm_names(cfg)[1], out)
        _linear(params["out"], "out", out)
    return {k: torch.from_numpy(v) for k, v in out.items()}
