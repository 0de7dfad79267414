"""The least time one call of a port kernel could take on one H100: each
input byte read once and each output byte written once at HBM's
3.35 TB/s, against the call's products at the peak of its arithmetic;
the larger of the two is the bound.

`_bound`, `attention_bound`, `scored_bound`, `scored_bwd_bounds` and
`fused_bound` are frozen copies of `chip_smoke.py:611,601,932,1072,1426`.
One thing is added: the operand type "split_tf32", which the port's f32
score-chained kernels run (each f32 product as three TF32 products on the
tensor cores, at most 495 / 3 TFLOP/s), with f32's four bytes an element.
A kernel's share of its roofline is its bound over its device time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "split_tf32": 495e12 / 3}
SPLIT_TF32_FLOPS = 495e12 / 3


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b, h, lq, lkv, dh, dtype_name, mask_itemsize):
    """Least time for o = softmax(q·kᵀ/√dh + neg)·v on this card: q, k, v
    and the mask read once and o written once, against the two products'
    flops at the peak of the operand type."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    d = h * dh
    nbytes = (2 * b * lq * d + 2 * b * lkv * d) * itemsize + b * lkv * mask_itemsize
    return _bound(nbytes, 4.0 * b * h * lq * lkv * dh, dtype_name)


def scored_bound(b, h, lq, lkv, dh, dtype_name, has_sprev, emit):
    """Least time for one scored_fwd call on this card: q, k, v, the f32
    mask, S_prev (f32, when given) read once, ctx and S (f32, when emitted)
    written once, against the two products' 4·B·H·Lq·Lkv·dh flops at the
    peak of the operand type."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    d = h * dh
    scores = b * h * lq * lkv * 4
    nbytes = ((2 * b * lq * d + 2 * b * lkv * d) * itemsize + b * lkv * 4
              + scores * (int(has_sprev) + int(emit)))
    return _bound(nbytes, 4.0 * b * h * lq * lkv * dh, dtype_name)


def scored_bwd_bounds(b, h, lq, lkv, dh, dtype_name, has_sprev, emit):
    """Least times for the score-chained backward on this card, per kernel
    and for the pair.  The pair reads q, k, v, dctx, the forward's ctx and
    row stats (m, l) and the f32 mask once, S_prev when given, S and
    dscores when S was emitted, and writes dq, dk, dv and (with S_prev)
    dS_prev, against 8 B·H·Lq·Lkv·dh flops (dp, dq, dk, dv), 10 where s is
    rebuilt.  scored_bwd_dq: q, k, v, dctx, ctx, the mask, the stats,
    S_prev, S and dscores in; dq, the row stats with delta and dS_prev
    out; dp and dq (+ s).  scored_bwd_dkv: q, k, v, dctx, the mask, S and
    dscores (S_prev only where s is rebuilt) and the stats with delta in; dk
    and dv out; dp, dk and dv (+ s)."""
    it = 2 if dtype_name == "bfloat16" else 4
    q_like, kv_like = b * lq * h * dh * it, b * lkv * h * dh * it
    score = b * h * lq * lkv * 4
    stats = 3 * b * h * lq * 4
    fwd_stats = 2 * b * h * lq * 4
    common = 2 * q_like + 2 * kv_like + b * lkv * 4 + 2 * score * int(emit)
    unit = float(b * h * lq * lkv * dh)
    s_flops = 0 if emit else 2
    sprev_in = score * int(has_sprev)
    return {
        "scored_bwd_dq": _bound(common + q_like + fwd_stats + sprev_in
                                + q_like + stats + sprev_in,
                                (4 + s_flops) * unit, dtype_name),
        "scored_bwd_dkv": _bound(common + sprev_in * int(not emit) + stats
                                 + 2 * kv_like, (6 + s_flops) * unit,
                                 dtype_name),
        "pair": _bound(common + q_like + fwd_stats + 2 * sprev_in + q_like
                       + 2 * kv_like, (8 + s_flops) * unit, dtype_name)}


def fused_bound(b, h, lq, lkv, dh, dtype_name, has_sprev, emit, save_ctx):
    """Least time for one fused_block call on this card: q, k, v, the f32
    mask, the three D x D weights and the LayerNorm's two vectors read
    once, S_prev (f32) when given, out written once, S (f32) and the ctx
    residual when asked for, against 4·B·H·Lq·Lkv·dh flops for the
    attention plus 6·B·Lq·D² for the three products, at the peak of the
    operand type (bound_ms); and the same at the split-TF32 rate, 495/3
    TFLOP/s, at which the kernel runs every f32 product on the tensor cores
    (bound_split_tf32_ms)."""
    it = 2 if dtype_name == "bfloat16" else 4
    d = h * dh
    scores = b * h * lq * lkv * 4
    nbytes = ((2 * b * lq * d + 2 * b * lkv * d + 3 * d * d + 2 * d) * it
              + b * lkv * 4 + scores * (int(has_sprev) + int(emit))
              + b * lq * d * it * int(save_ctx))
    flops = 4.0 * b * h * lq * lkv * dh + 6.0 * b * lq * d * d
    out = _bound(nbytes, flops, dtype_name)
    out["bound_split_tf32_ms"] = max(out["bytes_ms"],
                                     flops / SPLIT_TF32_FLOPS * 1e3)
    return out


STREAMS = (("l", "l"), ("l", "v"), ("l", "a"), ("v", "v"), ("v", "l"),
           ("v", "a"), ("a", "a"), ("a", "l"), ("a", "v"))


def stream_shapes(m):
    """(Lq, Lkv) of the grid's nine streams, in the reference order."""
    lens = {"l": m.l_len, "v": m.v_len, "a": m.a_len}
    return [(lens[q], lens[kv]) for q, kv in STREAMS]
