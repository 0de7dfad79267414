"""The text tower's arithmetic (`moonlight_trans`): its useful FLOPs, and
the least time of its expert, combine and attention kernels at the card's
peaks.
`c` is the configuration file's `tower` section (config.json's keys).

Useful FLOPs count each multiply-add of the model's products once as two
operations, nothing for norms, RoPE, the softmax or the router's sort:
per token every layer's projections, the dense or shared SwiGLU and the
chosen experts' SwiGLU and the router's logits; per causal (query, key)
pair of a sequence, per layer and head, q·k over the qk width and p·v
over the v width.  The embedding lookup and the absent output head count
nothing.
"""

from __future__ import annotations

from typing import Dict, Sequence

from . import flops

BF16 = 2   # bytes


def attention_macs_per_token(c: Dict) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    r = c["kv_lora_rank"]
    return (d * h * qk + d * (r + c["qk_rope_head_dim"])
            + r * h * (c["qk_nope_head_dim"] + c["v_head_dim"])
            + h * c["v_head_dim"] * d)


def routed_macs_per_token(c: Dict) -> int:
    """The chosen experts' SwiGLU of one MoE layer."""
    return c["num_experts_per_tok"] * 3 * c["hidden_size"] * c["moe_intermediate_size"]


def flops_per_token(c: Dict) -> float:
    """Useful FLOPs of one token through the whole tower, attention scores
    aside (`flops_per_causal_pair`)."""
    d = c["hidden_size"]
    dense = c["first_k_dense_replace"]
    moe = c["num_hidden_layers"] - dense
    shared = 3 * d * c["moe_intermediate_size"] * c["n_shared_experts"]
    router = d * c["n_routed_experts"]
    macs = (c["num_hidden_layers"] * attention_macs_per_token(c)
            + dense * 3 * d * c["intermediate_size"]
            + moe * (routed_macs_per_token(c) + shared + router))
    return 2.0 * macs


def flops_per_causal_pair(c: Dict) -> float:
    """FLOPs of one (query, key ≤ query) pair in every layer and head."""
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return (2.0 * (qk + c["v_head_dim"]) * c["num_attention_heads"]
            * c["num_hidden_layers"])


def causal_pairs(lengths: Sequence[int]) -> int:
    return sum(n * (n + 1) // 2 for n in lengths)


def expert_bound_s(c: Dict, routed) -> float:
    """Least time of the two grouped expert products (gate and up, then
    down) over `routed`, the routed rows of each (MoE layer, expert)
    summed over some batches: per layer the larger of the rows' FLOPs at
    the bf16 peak and the bytes at the HBM rate (each used expert's
    weights read once, each row's input read, its F-wide activation
    written and read, its output written)."""
    d, f = c["hidden_size"], c["moe_intermediate_size"]
    peak = flops.PEAK_TFLOPS["bfloat16"] * 1e12
    total = 0.0
    for layer in routed:
        rows = float(sum(layer))
        used = sum(1 for n in layer if n > 0)
        ops = rows * 2.0 * 3 * d * f
        nbytes = BF16 * (used * 3 * d * f + rows * (2 * d + 2 * f))
        total += max(ops / peak, nbytes / flops.HBM_BYTES_PER_S)
    return total


def combine_bound_s(c: Dict, routed) -> float:
    """Least time of the combination of each token's routed rows over
    `routed` (as `expert_bound_s`): its bytes at the HBM rate, each
    routed row's output and its int32 place read, each token's shared
    expert output read and its f32 residual read and written."""
    d, k = c["hidden_size"], c["num_experts_per_tok"]
    total = 0.0
    for layer in routed:
        rows = float(sum(layer))
        nbytes = rows * (BF16 * d + 4) + rows / k * (BF16 * d + 2 * 4 * d)
        total += nbytes / flops.HBM_BYTES_PER_S
    return total


def attention_bound_s(c: Dict, batches: Sequence[Sequence[int]]) -> float:
    """Least time of the latent attention kernel over batches of sequence
    lengths, every layer: per batch and layer the larger of the causal
    FLOPs at the bf16 peak and the bytes (q, the per-head k_nope and v,
    the shared k_pe read once, o written) at the HBM rate."""
    h = c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    per_token = BF16 * (h * qk + h * (c["qk_nope_head_dim"] + c["v_head_dim"])
                        + c["qk_rope_head_dim"] + h * c["v_head_dim"])
    per_pair = 2.0 * (qk + c["v_head_dim"]) * h
    peak = flops.PEAK_TFLOPS["bfloat16"] * 1e12
    total = 0.0
    for lens in batches:
        ops = per_pair * causal_pairs(lens)
        nbytes = per_token * sum(lens)
        total += c["num_hidden_layers"] * max(ops / peak,
                                              nbytes / flops.HBM_BYTES_PER_S)
    return total
