"""Plain PyTorch forwards of the benchmark's two models, from their
published descriptions, on a dict of weights keyed by the reference
scripts' state-dict names (the names the port's `state_dict()` carries).

- "concat_trans" (cmu-mosei/run.py:207-339): two minus grids, the
  previous utterance through `intensity`, the current through
  `stimulation`; each a bias-free Linear per modality, nine directed
  streams of `minus` blocks (attention with no Q/K/V projections,
  x = proj(ctx), LayerNorm(minus([q ; x]))), every layer's output
  collected, features concatenated per target, targets concatenated on
  the sequence axis as [l, a, v], mean and max pooling, a bias-free
  classifier; then out = Linear([this ; LN(Σ this·last·trans)]).
- "grid_only" (robot_demo.py:293-441): one RealFormer grid: kernel-1
  convolutions with bias (the three visual slots to dim / 3 each,
  concatenated), learned positions, blocks with Q/K/V projections,
  q = LN1(q + a·proj(ctx)), q = LN2(q + b·FFN(q)), a classifier with bias.

Attention (cmu-mosei/run.py:236-257): S = Q·Kᵀ/√dh (+ c·S_prev when the
stream's previous block emitted S) − 1e8·(1 − mask), softmax, ·V; the
masked S goes on to the next block of the stream.  Every product runs in
the caller's float32 setting: the harness turns TF32 off for the
reference and on for its lower-precision control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

MASK_PENALTY = 1.0e8
LN_EPS = 1e-5
STREAMS = (("l", "l"), ("l", "v"), ("l", "a"), ("v", "v"), ("v", "l"),
           ("v", "a"), ("a", "a"), ("a", "l"), ("a", "v"))


def _minus_grid_shapes(m, prefix: str) -> List[Tuple[str, tuple]]:
    d = m.dim
    out = [(f"{prefix}unify_dimension.linguistic.weight", (d, m.l_dim)),
           (f"{prefix}unify_dimension.visual.weight", (d, m.v_dim)),
           (f"{prefix}unify_dimension.acoustic.weight", (d, m.a_dim))]
    for j in range(9 * m.n_layers):
        blk = f"{prefix}multimodal_blocks.{j}."
        out += [(blk + "proj.weight", (d, d)), (blk + "minus.weight", (d, 2 * d)),
                (blk + "norm1.weight", (d,)), (blk + "norm1.bias", (d,)),
                (blk + "c", (1,))]
    out.append((f"{prefix}classifier.weight", (m.n_emotions, 6 * d * m.n_layers)))
    return out


def _realformer_grid_shapes(m) -> List[Tuple[str, tuple]]:
    d, d3 = m.dim, m.dim // 3
    out = []
    for name, cin, cout in (("linguistic", m.l_dim, d),
                            ("visual_256", m.v_dims_multires[0], d3),
                            ("visual_512", m.v_dims_multires[1], d3),
                            ("visual_1024", m.v_dims_multires[2], d3),
                            ("acoustic", m.a_dim, d)):
        out += [(f"unify_dimension.{name}.weight", (cout, cin, 1)),
                (f"unify_dimension.{name}.bias", (cout,))]
    for name, length in (("linguistic", m.l_len), ("visual", m.v_len),
                         ("acoustic", m.a_len)):
        out.append((f"{name}_position.position_embeddings.weight", (length, d)))
    f = m.ffn * d
    for j in range(9 * m.n_layers):
        blk = f"multimodal_blocks.{j}."
        out += [(blk + f"w_qkv.{i}.weight", (d, d)) for i in range(3)]
        out += [(blk + "proj.weight", (d, d)),
                (blk + "norm1.weight", (d,)), (blk + "norm1.bias", (d,)),
                (blk + "norm2.weight", (d,)), (blk + "norm2.bias", (d,)),
                (blk + "ffn.0.weight", (f, d)), (blk + "ffn.0.bias", (f,)),
                (blk + "ffn.2.weight", (d, f)), (blk + "ffn.2.bias", (d,)),
                (blk + "a", (1,)), (blk + "b", (1,)), (blk + "c", (1,))]
    out += [("classifier.weight", (m.n_emotions, 6 * d * m.n_layers)),
            ("classifier.bias", (m.n_emotions,))]
    return out


def param_shapes(model: str, m) -> List[Tuple[str, tuple]]:
    """(state-dict name, shape) of every weight, in a fixed order."""
    if model == "concat_trans":
        e = m.n_emotions
        return (_minus_grid_shapes(m, "intensity.")
                + _minus_grid_shapes(m, "stimulation.")
                + [("trans", (e, e, e)), ("norm1.weight", (e,)),
                   ("norm1.bias", (e,)), ("out.weight", (e, 2 * e)),
                   ("out.bias", (e,))])
    if model == "grid_only":
        return _realformer_grid_shapes(m)
    raise ValueError(f"no reference model {model!r}")


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def attention(q, k, v, mask, s_prev, c, n_heads: int):
    """(ctx (B, Lq, D), masked S (B, H, Lq, Lkv))."""
    b, lq, d = q.shape
    lkv, dh = k.shape[1], d // n_heads
    qh = q.reshape(b, lq, n_heads, dh).transpose(1, 2)
    kh = k.reshape(b, lkv, n_heads, dh).transpose(1, 2)
    vh = v.reshape(b, lkv, n_heads, dh).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2) / math.sqrt(dh)
    if s_prev is not None:
        s = s + c * s_prev
    s = s - MASK_PENALTY * (1.0 - mask[:, None, None, :])
    ctx = torch.softmax(s, dim=-1) @ vh
    return ctx.transpose(1, 2).reshape(b, lq, d), s


def _pool(collected):
    cat = torch.cat([torch.cat(collected[t], dim=2) for t in ("l", "a", "v")],
                    dim=1)
    return torch.cat([cat.mean(dim=1), torch.max(cat, dim=1).values], dim=1)


def _streams(src, masks, n_layers: int, block):
    collected = {"l": [], "v": [], "a": []}
    for s, (qm, kvm) in enumerate(STREAMS):
        q, scores = src[qm], None
        for i in range(n_layers):
            q, scores = block(n_layers * s + i, q, src[kvm], masks[kvm], scores)
            collected[qm].append(q)
    return collected


def minus_grid(p: Dict[str, torch.Tensor], prefix: str, m, l, v, a,
               l_mask, v_mask, a_mask) -> torch.Tensor:
    u = prefix + "unify_dimension."
    src = {"l": F.linear(l, p[u + "linguistic.weight"]),
           "v": F.linear(v, p[u + "visual.weight"]),
           "a": F.linear(a, p[u + "acoustic.weight"])}
    masks = {"l": l_mask, "v": v_mask, "a": a_mask}

    def block(j, q, kv, mask, scores):
        b = f"{prefix}multimodal_blocks.{j}."
        ctx, scores = attention(q, kv, kv, mask, scores, p[b + "c"], m.n_heads)
        x = F.linear(ctx, p[b + "proj.weight"])
        y = F.linear(torch.cat([q, x], dim=-1), p[b + "minus.weight"])
        return _ln(y, p[b + "norm1.weight"], p[b + "norm1.bias"]), scores

    pooled = _pool(_streams(src, masks, m.n_layers, block))
    return F.linear(pooled, p[prefix + "classifier.weight"])


def concat_trans(p: Dict[str, torch.Tensor], m, batch) -> torch.Tensor:
    """Logits (B, E) of a pair batch: l/v/a (B, 2, len, dim), masks
    (B, 2, len)."""
    def grid(prefix, slot):
        return minus_grid(p, prefix, m, *(batch[k][:, slot] for k in (
            "l", "v", "a", "l_mask", "v_mask", "a_mask")))

    last = grid("intensity.", 0)
    this = grid("stimulation.", 1)
    fused = torch.einsum("bg,be,geh->bh", this, last, p["trans"])
    normed = _ln(fused, p["norm1.weight"], p["norm1.bias"])
    return F.linear(torch.cat([this, normed], dim=1), p["out.weight"],
                    p["out.bias"])


def grid_only(p: Dict[str, torch.Tensor], m, batch) -> torch.Tensor:
    """Logits (B, E) of a robot batch: l, v256, v512, v1024, a
    (B, len, dim) and their masks."""
    def conv(name, x):
        w = p[f"unify_dimension.{name}.weight"]
        return F.linear(x, w[:, :, 0], p[f"unify_dimension.{name}.bias"])

    v = torch.cat([conv("visual_256", batch["v256"]),
                   conv("visual_512", batch["v512"]),
                   conv("visual_1024", batch["v1024"])], dim=-1)
    src = {"l": conv("linguistic", batch["l"]), "v": v,
           "a": conv("acoustic", batch["a"])}
    for key, name in (("l", "linguistic"), ("v", "visual"), ("a", "acoustic")):
        table = p[f"{name}_position.position_embeddings.weight"]
        src[key] = src[key] + table[: src[key].shape[1]]
    masks = {k: batch[k + "_mask"] for k in ("l", "v", "a")}

    def block(j, q, kv, mask, scores):
        b = f"multimodal_blocks.{j}."
        ctx, scores = attention(F.linear(q, p[b + "w_qkv.0.weight"]),
                                F.linear(kv, p[b + "w_qkv.1.weight"]),
                                F.linear(kv, p[b + "w_qkv.2.weight"]),
                                mask, scores, p[b + "c"], m.n_heads)
        x = F.linear(ctx, p[b + "proj.weight"])
        q = _ln(q + p[b + "a"] * x, p[b + "norm1.weight"], p[b + "norm1.bias"])
        h = F.linear(torch.relu(F.linear(q, p[b + "ffn.0.weight"],
                                         p[b + "ffn.0.bias"])),
                     p[b + "ffn.2.weight"], p[b + "ffn.2.bias"])
        q = _ln(q + p[b + "b"] * h, p[b + "norm2.weight"], p[b + "norm2.bias"])
        return q, scores

    pooled = _pool(_streams(src, masks, m.n_layers, block))
    return F.linear(pooled, p["classifier.weight"], p["classifier.bias"])


MODELS = {"concat_trans": concat_trans, "grid_only": grid_only}


def forward(model: str, p, m, batch) -> torch.Tensor:
    return MODELS[model](p, m, batch)
