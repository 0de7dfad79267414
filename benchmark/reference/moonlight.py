"""The plain reference of the text tower of `moonlight_trans`: a frozen
copy of the port's multimodal_emotion_processing_tpu_torch/models/
tower_reference.py as it stood when the cell was written (the yardstick
does not import the program), plus `head_crop`, the sentence features as
data/masking.summary_masking's head crop makes them.

DeepSeek-V3's decoder block as Moonlight-16B-A3B publishes it
(https://huggingface.co/moonshotai/Moonlight-16B-A3B), in float32 PyTorch,
one unpacked sequence at a time, a materialised causal mask, a loop over
the experts:

    x = embed[ids]
    per layer:  x += MLA(rmsnorm(x));  x += FFN(rmsnorm(x))
    out = rmsnorm(x)

MLA (no q LoRA): q = h Wq split per head into 128 nope + 64 rope dims;
[c, k_pe] = h Wkv_a, c = rmsnorm(c), [k_nope, v] = c Wkv_b per head;
RoPE (θ = rope_theta, the interleaved pairs of the DeepSeek checkpoints)
on q_rope and on k_pe, which every head shares; softmax(q·kᵀ/√192 + causal
mask)·v, then Wo.  FFN: SwiGLU of intermediate_size in the first
first_k_dense_replace layers; after them the sigmoid router (scores in
f32, the top num_experts_per_tok of score + e_score_correction_bias,
weights the chosen scores over their sum times routed_scaling_factor),
the routed SwiGLU experts of moe_intermediate_size, plus the shared
experts, one SwiGLU of n_shared_experts · moe_intermediate_size.

Departures from the published model, each on purpose:
- the output head (lm_head) is not run: the pair model reads the final
  norm's hidden states;
- the group step of `noaux_tc` routing is left out: with n_group =
  topk_group = 1 it chooses every expert (`forward` refuses other values);
- RoPE comes out as the evens' then the odds' halves of each rotated pair
  (the published code's order after its permutation), which a dot product
  of two rotated vectors does not see;
- weights are taken as given (bf16-valued ones are upcast) and every
  operation runs in float32 with TF32 off; the published model runs in
  bf16.

`weight(name, shape)` gives one tensor under the checkpoint's name; it is
asked for each layer's weights when that layer runs and they are dropped
after it, so the float32 model never lives whole.  `forward`'s `fault`,
`prefixes` and `expert_input` plant the comparison's faults and its
lower-precision control (drivers/tower_eval.py).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F


def _cfg(cfg) -> Dict:
    return dict(cfg)


def layer_names(c: Dict, i: int) -> List:
    """(name, shape) of layer i's weights under the checkpoint's names."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, rope, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    r = c["kv_lora_rank"]
    p = f"model.layers.{i}."
    out = [(p + "input_layernorm.weight", (d,)),
           (p + "self_attn.q_proj.weight", (h * (nope + rope), d)),
           (p + "self_attn.kv_a_proj_with_mqa.weight", (r + rope, d)),
           (p + "self_attn.kv_a_layernorm.weight", (r,)),
           (p + "self_attn.kv_b_proj.weight", (h * (nope + dv), r)),
           (p + "self_attn.o_proj.weight", (d, h * dv)),
           (p + "post_attention_layernorm.weight", (d,))]
    if i < c["first_k_dense_replace"]:
        f = c["intermediate_size"]
        return out + [(p + "mlp.gate_proj.weight", (f, d)),
                      (p + "mlp.up_proj.weight", (f, d)),
                      (p + "mlp.down_proj.weight", (d, f))]
    f, e = c["moe_intermediate_size"], c["n_routed_experts"]
    out += [(p + "mlp.gate.weight", (e, d)),
            (p + "mlp.gate.e_score_correction_bias", (e,))]
    for j in range(e):
        q = f"{p}mlp.experts.{j}."
        out += [(q + "gate_proj.weight", (f, d)), (q + "up_proj.weight", (f, d)),
                (q + "down_proj.weight", (d, f))]
    s = f * c["n_shared_experts"]
    q = p + "mlp.shared_experts."
    return out + [(q + "gate_proj.weight", (s, d)), (q + "up_proj.weight", (s, d)),
                  (q + "down_proj.weight", (d, s))]


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x (..., L, dim) rotated in interleaved pairs by each position."""
    dim = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=x.device) / dim)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = ang.cos(), ang.sin()
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _swiglu(x, gate, up, down):
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def _attention(c, w, p, x, pos, starts, fault):
    """MLA over one sequence x (L, D); `starts` the first rows of the parts
    that share no attention (the sequence alone: [0])."""
    n, d = x.shape
    h = c["num_attention_heads"]
    nope, rope, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    r = c["kv_lora_rank"]
    a = _rms(x, w[p + "input_layernorm.weight"], c["rms_norm_eps"])
    q = F.linear(a, w[p + "self_attn.q_proj.weight"]).view(n, h, nope + rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:].transpose(0, 1), pos,
                                        c["rope_theta"]).transpose(0, 1)], dim=-1)
    kva = F.linear(a, w[p + "self_attn.kv_a_proj_with_mqa.weight"])
    ckv = _rms(kva[:, :r], w[p + "self_attn.kv_a_layernorm.weight"],
               c["rms_norm_eps"])
    k_pe = kva[:, r:]
    if fault != "no_kpe_rope":
        k_pe = _rope(k_pe, pos, c["rope_theta"])
    kv = F.linear(ckv, w[p + "self_attn.kv_b_proj.weight"]).view(n, h, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe[:, None, :].expand(n, h, rope)], dim=-1)
    v = kv[..., nope:]
    s = torch.einsum("ihd,jhd->hij", q, k) / math.sqrt(nope + rope)
    rows = torch.arange(n, device=x.device)
    allowed = rows[None, :] <= rows[:, None]
    part = torch.zeros(n, dtype=torch.long, device=x.device)
    for st in starts[1:]:
        part[st:] += 1
    if fault != "cross_boundary":
        allowed = allowed & (part[None, :] == part[:, None])
    s = s.masked_fill(~allowed[None], float("-inf"))
    o = torch.einsum("hij,jhd->ihd", torch.softmax(s, dim=-1), v)
    return F.linear(o.reshape(n, h * dv), w[p + "self_attn.o_proj.weight"])


def _feed_forward(c, w, p, i, x, fault, expert_input, choices):
    a = _rms(x, w[p + "post_attention_layernorm.weight"], c["rms_norm_eps"])
    if i < c["first_k_dense_replace"]:
        return _swiglu(a, w[p + "mlp.gate_proj.weight"], w[p + "mlp.up_proj.weight"],
                       w[p + "mlp.down_proj.weight"])
    k = c["num_experts_per_tok"] - (1 if fault == "top5" else 0)
    scores = torch.sigmoid(F.linear(a, w[p + "mlp.gate.weight"]))
    biased = scores if fault == "no_bias" else (
        scores + w[p + "mlp.gate.e_score_correction_bias"])
    choice = torch.topk(biased, k, dim=-1).indices
    if choices is not None:
        choices.append(choice)
    weight = scores.gather(1, choice)
    if c["norm_topk_prob"]:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    weight = weight * c["routed_scaling_factor"]
    ae = expert_input(a)
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        tok, slot = (choice == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        q = f"{p}mlp.experts.{e}."
        y = _swiglu(ae[tok], w[q + "gate_proj.weight"], w[q + "up_proj.weight"],
                    w[q + "down_proj.weight"])
        out.index_add_(0, tok, y * weight[tok, slot, None])
    if fault == "partial_rows" and i == c["num_hidden_layers"] - 1:
        out[torch.arange(len(out), device=out.device) % 5 < 2] = 0.0
    if fault != "no_shared":
        q = p + "mlp.shared_experts."
        out = out + _swiglu(a, w[q + "gate_proj.weight"], w[q + "up_proj.weight"],
                            w[q + "down_proj.weight"])
    return out


def forward(cfg, weight: Callable, sequences: Sequence[torch.Tensor], *,
            prefixes: Optional[Sequence[Optional[torch.Tensor]]] = None,
            fault: Optional[str] = None,
            expert_input: Callable = lambda a: a,
            choices: Optional[list] = None) -> List[torch.Tensor]:
    """The final norm's hidden states (L_i, hidden) f32 of each sequence of
    token ids.  `weight(name, shape)` gives a weight (upcast here).

    For the comparison's faults and control: `prefixes[i]`, token ids run
    before sequence i as a part of its own (positions restarting at 0),
    which it may attend to only under `fault="cross_boundary"`; `fault`
    "top5" (one expert fewer), "no_bias" (the correction bias left out of
    the choice), "no_shared" (the shared experts left out),
    "no_kpe_rope" (no RoPE on k_pe), "partial_rows" (no routed output
    in the last layer for two rows in five); `expert_input(a)` what the routed
    experts read of their normed input (a rounding, for the control).
    `choices`, a list, gets each MoE layer's chosen experts (L_i, k) of
    each sequence in turn."""
    c = _cfg(cfg)
    if c["n_group"] != 1 or c["topk_group"] != 1 or c["q_lora_rank"] is not None:
        raise ValueError("the reference runs one routing group and no q LoRA")
    dev = sequences[0].device
    prefixes = prefixes or [None] * len(sequences)
    parts, pos, starts = [], [], []
    for ids, pre in zip(sequences, prefixes):
        a = 0 if pre is None else len(pre)
        parts.append(ids if pre is None else torch.cat([pre, ids]))
        pos.append(torch.cat([torch.arange(a, device=dev),
                              torch.arange(len(ids), device=dev)]))
        starts.append([0, a] if a else [0])
    emb = weight("model.embed_tokens.weight",
                 (c["vocab_size"], c["hidden_size"]))
    xs = [emb[ids.long()].float() for ids in parts]
    del emb
    for i in range(c["num_hidden_layers"]):
        w = {n: weight(n, s).float() for n, s in layer_names(c, i)}
        p = f"model.layers.{i}."
        for j, (x, ps, st) in enumerate(zip(xs, pos, starts)):
            x = x + _attention(c, w, p, x, ps, st, fault)
            xs[j] = x + _feed_forward(c, w, p, i, x, fault, expert_input,
                                       choices)
        del w
    norm = weight("model.norm.weight", (c["hidden_size"],)).float()
    return [_rms(x, norm, c["rms_norm_eps"])[st[-1]:]
            for x, st in zip(xs, starts)]


def head_crop(hidden, l_len: int):
    """One sentence's hidden states (n, D) as the grid's word features:
    the 3 summary frames (max, min, mean over its tokens), then its first
    l_len − 3 tokens, zero past its end; the mask covers n + 3 frames up
    to l_len (none for an empty sentence).  Returns (l_len, D), (l_len,)."""
    n, d = hidden.shape
    feat = torch.zeros(l_len, d, dtype=torch.float32, device=hidden.device)
    mask = torch.zeros(l_len, dtype=torch.float32, device=hidden.device)
    if n == 0:
        return feat, mask
    feat[0] = hidden.amax(dim=0)
    feat[1] = hidden.amin(dim=0)
    feat[2] = hidden.mean(dim=0)
    body = hidden[: l_len - 3]
    feat[3: 3 + len(body)] = body
    mask[: min(n + 3, l_len)] = 1.0
    return feat, mask
