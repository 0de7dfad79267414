"""A large language model as the text tower of the pair model: the hidden
states of a transcript's tokens become the grid's word features.

Emotion recognition reads its text modality from a language model's hidden
states rather than from GloVe or BERT features (MERBench, Lian et al.).
`Tower` is the decoder of DeepSeek-V3's block (arXiv:2412.19437; its latent
attention is DeepSeek-V2's, arXiv:2405.04434) at the sizes of a published
model (`TOWERS`), frozen and run in eval mode, prefill only:

    x = embed[ids]                                      (f32 residual)
    per layer i:
      h = rmsnorm(x);  q = h Wq  (H x (128 nope + 64 rope));  RoPE on q_rope
      [c, k_pe] = h Wkv_a;  c = rmsnorm(c);  [k_nope, v] = c Wkv_b (per head)
      RoPE on k_pe (64, shared by the heads);  k = [k_nope, k_pe]
      x += causal softmax(q kᵀ / √192) v  Wo          (within each sequence)
      h = rmsnorm(x)
      layer < first_k_dense_replace:  x += SwiGLU(h)    (intermediate_size)
      else:  s = sigmoid(h Wr) in f32;  choice = top-k of s + bias;
             w = s[choice] / Σ s[choice] · routed_scaling_factor
             x += Σ_k w_k SwiGLU_{choice_k}(h) + SwiGLU_shared(h)
    out = rmsnorm(x)                                    (f32)

RoPE is the DeepSeek checkpoints' interleaved layout: the 64 rope dims are
taken as 32 (even, odd) pairs, each rotated by pos·θ^(-2i/64), and come
out as the evens' then the odds' halves (the order does not change a dot
product of two rotated vectors).  The router is DeepSeek-V3's `noaux_tc`
with one group (n_group = topk_group = 1: the group step chooses every
expert), the k choices in descending order of the biased score.  The
output head is neither held nor run: the grid reads hidden states.

Products run at the tower's dtype (bf16: bf16 operands, f32 accumulation);
the router's logits, sigmoid, choice and normalisation, the RMSNorm
statistics, RoPE and the softmax run in f32, and the residual stream is
kept in f32.  A batch's sequences are packed back to back (`cu_seqlens`,
int32), positions restart at 0 in each, and no pad token reaches a layer.

On a CUDA device (bf16 only) the attention is `flash_fwd_mla_varlen`
(ops/flash_attention.py) and the routed experts are `moe_gate_up`,
`moe_down` and `moe_combine` (ops/moe.py); routing, the stable sort and the
per-expert offsets are torch ops inside the span `tower.route`; the dense
layer, the shared experts, the projections, norms and RoPE are cuBLAS and
torch ops.  On the CPU the same rows run through the kernels' plain
versions (`mla_varlen_plain`, `routed_plain`, `combine_plain`).

`TowerFeed` joins the tower to the pair model: `pack` (host, span
`tower.pack`) packs a batch's transcripts; `features` (device) runs the
tower once and turns each sentence's hidden states into the grid's `l` /
`l_mask` as data/masking.summary_masking's head crop does for word
features (span `tower.gather`).  eval/ensemble.Ensemble(tower=) shares one
tower's output among its members.

`TowerStats` counts sequences, tokens and the routed rows of each (MoE
layer, expert); the rows accumulate in an int64 tensor on the tower's
device and are read only by `stats()`, so no batch waits on them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import spans


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """A decoder's published settings, under its config.json's keys."""
    num_hidden_layers: int
    hidden_size: int
    vocab_size: int
    num_attention_heads: int
    q_lora_rank: Optional[int]
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    first_k_dense_replace: int
    intermediate_size: int
    n_routed_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    n_shared_experts: int
    n_group: int
    topk_group: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    scoring_func: str
    topk_method: str
    rms_norm_eps: float
    rope_theta: float
    hidden_act: str
    max_position_embeddings: int

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


#: https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json
TOWERS: Dict[str, TowerConfig] = {
    "moonlight_16b_a3b": TowerConfig(
        num_hidden_layers=27, hidden_size=2048, vocab_size=163840,
        num_attention_heads=16, q_lora_rank=None, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        first_k_dense_replace=1, intermediate_size=11264,
        n_routed_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
        n_shared_experts=2, n_group=1, topk_group=1,
        routed_scaling_factor=2.446, norm_topk_prob=True,
        scoring_func="sigmoid", topk_method="noaux_tc", rms_norm_eps=1e-5,
        rope_theta=50000.0, hidden_act="silu", max_position_embeddings=8192),
}


def _check_supported(cfg: TowerConfig) -> None:
    if cfg.q_lora_rank is not None:
        raise NotImplementedError("q_lora_rank: only a full-rank q_proj")
    if cfg.n_group != 1 or cfg.topk_group != 1:
        raise NotImplementedError("group-limited routing: only one group")
    if (cfg.scoring_func, cfg.topk_method, cfg.hidden_act) != (
            "sigmoid", "noaux_tc", "silu"):
        raise NotImplementedError("only sigmoid scores, noaux_tc and silu")
    if cfg.qk_rope_head_dim % 2:
        raise ValueError("qk_rope_head_dim must be even")


def weight_shapes(cfg: TowerConfig):
    """(name, shape) of every published weight the tower holds, under the
    checkpoint's names: the embedding, each layer's (`layer_shapes`), then
    the final norm; the output head is left out."""
    d = cfg.hidden_size
    out = [("model.embed_tokens.weight", (cfg.vocab_size, d))]
    for i in range(cfg.num_hidden_layers):
        out += layer_shapes(cfg, i)
    out.append(("model.norm.weight", (d,)))
    return out


def layer_shapes(cfg: TowerConfig, i: int):
    """(name, shape) of layer i's weights, under the checkpoint's names."""
    d, h = cfg.hidden_size, cfg.num_attention_heads
    p = f"model.layers.{i}."
    out = [(p + "input_layernorm.weight", (d,)),
           (p + "self_attn.q_proj.weight", (h * cfg.qk_head_dim, d)),
           (p + "self_attn.kv_a_proj_with_mqa.weight",
            (cfg.kv_lora_rank + cfg.qk_rope_head_dim, d)),
           (p + "self_attn.kv_a_layernorm.weight", (cfg.kv_lora_rank,)),
           (p + "self_attn.kv_b_proj.weight",
            (h * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank)),
           (p + "self_attn.o_proj.weight", (d, h * cfg.v_head_dim)),
           (p + "post_attention_layernorm.weight", (d,))]
    if i < cfg.first_k_dense_replace:
        f = cfg.intermediate_size
        return out + [(p + "mlp.gate_proj.weight", (f, d)),
                      (p + "mlp.up_proj.weight", (f, d)),
                      (p + "mlp.down_proj.weight", (d, f))]
    f, e = cfg.moe_intermediate_size, cfg.n_routed_experts
    out += [(p + "mlp.gate.weight", (e, d)),
            (p + "mlp.gate.e_score_correction_bias", (e,))]
    for j in range(e):
        q = f"{p}mlp.experts.{j}."
        out += [(q + "gate_proj.weight", (f, d)), (q + "up_proj.weight", (f, d)),
                (q + "down_proj.weight", (d, f))]
    s = f * cfg.n_shared_experts
    q = p + "mlp.shared_experts."
    return out + [(q + "gate_proj.weight", (s, d)), (q + "up_proj.weight", (s, d)),
                  (q + "down_proj.weight", (d, s))]


# ---------------------------------------------------------------------------
# the equations' pieces


def rms_norm(x, w, eps: float, dtype):
    """x / rms(x) · w with the statistics in f32, returned at `dtype`."""
    x = x.float()
    y = x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dtype)


def rope_tables(positions, dim: int, theta: float):
    """cos, sin (T, dim / 2) f32 of each position's angles pos·θ^(-2i/dim)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim)
    ang = positions.float()[:, None] * inv[None, :]
    return ang.cos(), ang.sin()


def apply_rope(x, cos, sin):
    """The interleaved rotation of x's last dim (pairs 2i, 2i + 1) in f32;
    out [evens·cos − odds·sin, odds·cos + evens·sin]."""
    x = x.float().unflatten(-1, (x.shape[-1] // 2, 2))
    a, b = x[..., 0], x[..., 1]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def swiglu(h, gate_up, down):
    """down(silu(gate) · up) with gate and up one (2F, K) product, the
    activation in f32."""
    g, u = F.linear(h, gate_up).chunk(2, dim=-1)
    return F.linear((F.silu(g.float()) * u.float()).to(h.dtype), down)


class TowerStats:
    """Sequences and tokens the tower ran, and the routed rows of each
    (MoE layer, expert), accumulated on the device."""

    def __init__(self, n_moe: int, n_experts: int, device):
        self.sequences = 0
        self.tokens = 0
        self.routed = torch.zeros(n_moe, n_experts, dtype=torch.int64,
                                  device=device)

    def snapshot(self) -> dict:
        """The counts so far; reading the routed rows waits for the device."""
        return {"sequences": self.sequences, "tokens": self.tokens,
                "routed": self.routed.to("cpu", copy=True).numpy()}


class TowerLayer(nn.Module):
    def __init__(self, cfg: TowerConfig, index: int, dtype):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_attention_heads
        self.cfg, self.index = cfg, index
        self.dense = index < cfg.first_k_dense_replace
        f32 = dict(dtype=torch.float32)
        lo = dict(dtype=dtype)
        self.attn_norm = nn.Parameter(torch.empty(d, **f32), requires_grad=False)
        self.q_proj = nn.Parameter(torch.empty(h * cfg.qk_head_dim, d, **lo),
                                   requires_grad=False)
        self.kv_a = nn.Parameter(torch.empty(
            cfg.kv_lora_rank + cfg.qk_rope_head_dim, d, **lo), requires_grad=False)
        self.kv_norm = nn.Parameter(torch.empty(cfg.kv_lora_rank, **f32),
                                    requires_grad=False)
        self.kv_b = nn.Parameter(torch.empty(
            h * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank, **lo),
            requires_grad=False)
        self.o_proj = nn.Parameter(torch.empty(d, h * cfg.v_head_dim, **lo),
                                   requires_grad=False)
        self.mlp_norm = nn.Parameter(torch.empty(d, **f32), requires_grad=False)
        if self.dense:
            f = cfg.intermediate_size
            self.gate_up = nn.Parameter(torch.empty(2 * f, d, **lo),
                                        requires_grad=False)
            self.down = nn.Parameter(torch.empty(d, f, **lo), requires_grad=False)
            return
        f, e = cfg.moe_intermediate_size, cfg.n_routed_experts
        s = f * cfg.n_shared_experts
        self.router = nn.Parameter(torch.empty(e, d, **lo), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(e, **f32), requires_grad=False)
        # each expert's gate and up rows interleaved (ops/moe.interleave_gate_up)
        self.w13 = nn.Parameter(torch.empty(e, 2 * f, d, **lo), requires_grad=False)
        self.w2 = nn.Parameter(torch.empty(e, d, f, **lo), requires_grad=False)
        self.shared_gate_up = nn.Parameter(torch.empty(2 * s, d, **lo),
                                           requires_grad=False)
        self.shared_down = nn.Parameter(torch.empty(d, s, **lo),
                                        requires_grad=False)

    def slots(self) -> Dict[str, Callable[[torch.Tensor], None]]:
        """Checkpoint name -> a function that copies that tensor into place."""
        from ..ops.moe import GROUP

        p = f"model.layers.{self.index}."

        def whole(param):
            return lambda t: param.copy_(t)

        def rows(param, a, b):
            return lambda t: param[a:b].copy_(t)

        out = {p + "input_layernorm.weight": whole(self.attn_norm),
               p + "self_attn.q_proj.weight": whole(self.q_proj),
               p + "self_attn.kv_a_proj_with_mqa.weight": whole(self.kv_a),
               p + "self_attn.kv_a_layernorm.weight": whole(self.kv_norm),
               p + "self_attn.kv_b_proj.weight": whole(self.kv_b),
               p + "self_attn.o_proj.weight": whole(self.o_proj),
               p + "post_attention_layernorm.weight": whole(self.mlp_norm)}
        if self.dense:
            f = self.cfg.intermediate_size
            out.update({p + "mlp.gate_proj.weight": rows(self.gate_up, 0, f),
                        p + "mlp.up_proj.weight": rows(self.gate_up, f, 2 * f),
                        p + "mlp.down_proj.weight": whole(self.down)})
            return out
        f, d = self.cfg.moe_intermediate_size, self.cfg.hidden_size
        s = f * self.cfg.n_shared_experts

        def half(j, which):
            def put(t):
                self.w13[j].view(f // GROUP, 2, GROUP, d)[:, which].copy_(
                    t.reshape(f // GROUP, GROUP, d))
            return put

        out.update({p + "mlp.gate.weight": whole(self.router),
                    p + "mlp.gate.e_score_correction_bias": whole(self.bias)})
        for j in range(self.cfg.n_routed_experts):
            q = f"{p}mlp.experts.{j}."
            out[q + "gate_proj.weight"] = half(j, 0)
            out[q + "up_proj.weight"] = half(j, 1)
            out[q + "down_proj.weight"] = whole(self.w2[j])
        q = p + "mlp.shared_experts."
        out.update({q + "gate_proj.weight": rows(self.shared_gate_up, 0, s),
                    q + "up_proj.weight": rows(self.shared_gate_up, s, 2 * s),
                    q + "down_proj.weight": whole(self.shared_down)})
        return out

    # -- attention ----------------------------------------------------------

    def attention(self, x, cos, sin, cu_seqlens, max_len: int, kernels: bool):
        cfg = self.cfg
        t, dt = x.shape[0], self.q_proj.dtype
        h = rms_norm(x, self.attn_norm, cfg.rms_norm_eps, dt)
        nope = cfg.qk_nope_head_dim
        q = F.linear(h, self.q_proj).view(t, cfg.num_attention_heads,
                                          cfg.qk_head_dim)
        q[..., nope:] = apply_rope(q[..., nope:], cos[:, None], sin[:, None]).to(dt)
        kva = F.linear(h, self.kv_a)
        c = rms_norm(kva[:, : cfg.kv_lora_rank], self.kv_norm, cfg.rms_norm_eps, dt)
        k_pe = apply_rope(kva[:, cfg.kv_lora_rank:], cos, sin).to(dt)
        kv = F.linear(c, self.kv_b).view(t, cfg.num_attention_heads,
                                         nope + cfg.v_head_dim)
        if kernels:
            from ..ops.flash_attention import flash_mla_varlen_kernel

            o = flash_mla_varlen_kernel(q, kv, k_pe, cu_seqlens, max_len)
        else:
            from ..ops.flash_attention import mla_varlen_plain

            o = mla_varlen_plain(q, kv, k_pe, cu_seqlens,
                                 n_heads=cfg.num_attention_heads)
        x += F.linear(o.reshape(t, -1), self.o_proj).float()

    # -- feed-forward ---------------------------------------------------------

    def route(self, h):
        """(choice (T, k) int64, weights (T, k) f32) of the router, in f32."""
        cfg = self.cfg
        scores = F.linear(h.float(), self.router.float()).sigmoid()
        choice = torch.topk(scores + self.bias.float(), cfg.num_experts_per_tok,
                            dim=-1, sorted=True).indices
        w = scores.gather(1, choice)
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return choice, w * cfg.routed_scaling_factor

    def feed_forward(self, x, stats: TowerStats, kernels: bool):
        cfg = self.cfg
        h = rms_norm(x, self.mlp_norm, cfg.rms_norm_eps, self.q_proj.dtype)
        if self.dense:
            x += swiglu(h, self.gate_up, self.down).float()
            return
        li = self.index - cfg.first_k_dense_replace
        shared = swiglu(h, self.shared_gate_up, self.shared_down)
        from ..ops import moe

        with spans.span("tower.route"):
            choice, w = self.route(h)
            rows, offsets, row_w, pos, counts = moe.sort_by_expert(
                choice, w, cfg.n_routed_experts)
            stats.routed[li] += counts
        if kernels:
            hid = moe.gate_up_kernel(h.contiguous(), rows, offsets, self.w13)
            y = moe.down_kernel(hid, offsets, self.w2, row_w)
            moe.combine_kernel(x, y, pos, shared.contiguous())
        else:
            y = moe.routed_plain(h, rows, offsets, self.w13, self.w2, row_w)
            moe.combine_plain(x, y, pos, shared)


class Tower(nn.Module):
    """The frozen decoder (module docstring) at `cfg`'s sizes; products at
    `dtype`.  Build it on the meta device and fill it, so the weights are
    made once where they live:

        with torch.device("meta"):
            tower = Tower(cfg)
        tower.to_empty(device="cuda")
        tower.fill(lambda name, shape: ...)   # one tensor per checkpoint name
    """

    def __init__(self, cfg: TowerConfig, dtype=torch.bfloat16):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        d = cfg.hidden_size
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d, dtype=dtype),
                                  requires_grad=False)
        self.layers = nn.ModuleList(TowerLayer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = nn.Parameter(torch.empty(d, dtype=torch.float32),
                                 requires_grad=False)
        self._stats = None
        self.eval()

    @property
    def dtype(self):
        return self.embed.dtype

    def stats(self) -> TowerStats:
        dev = self.embed.device
        if self._stats is None or self._stats.routed.device != dev:
            self._stats = TowerStats(self.cfg.n_moe_layers,
                                     self.cfg.n_routed_experts, dev)
        return self._stats

    @torch.no_grad()
    def fill(self, make: Callable[[str, Tuple[int, ...]], torch.Tensor]) -> None:
        """Copy `make(name, shape)` into place for every weight the tower
        holds (`weight_shapes`), one tensor at a time."""
        slots = {"model.embed_tokens.weight": lambda t: self.embed.copy_(t),
                 "model.norm.weight": lambda t: self.norm.copy_(t)}
        for layer in self.layers:
            slots.update(layer.slots())
        for name, shape in weight_shapes(self.cfg):
            slots[name](make(name, shape))

    @torch.no_grad()
    def forward(self, ids, cu_seqlens, positions, max_len: int):
        """ids (T,) the packed tokens; cu_seqlens (S + 1,) int32; positions
        (T,) each token's place in its sequence; max_len the longest
        sequence (a host int).  Returns the final norm's hidden states
        (T, hidden) f32."""
        with spans.span("tower.forward"):
            cfg = self.cfg
            kernels = ids.device.type == "cuda"
            if kernels and self.dtype != torch.bfloat16:
                raise ValueError(f"the tower's kernels take bf16; this tower "
                                 f"is {self.dtype} on {ids.device}")
            stats = self.stats()
            stats.sequences += cu_seqlens.shape[0] - 1
            stats.tokens += ids.shape[0]
            x = self.embed[ids.long()].float()
            cos, sin = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
            for layer in self.layers:
                layer.attention(x, cos, sin, cu_seqlens, max_len, kernels)
                layer.feed_forward(x, stats, kernels)
            return rms_norm(x, self.norm, cfg.rms_norm_eps, torch.float32)


# ---------------------------------------------------------------------------
# the tower as the pair model's text modality


def pack(tokens, n_tokens, sentences):
    """Host packing of a batch of transcripts: tokens (B, Lpad) int, each
    row's first n_tokens[b] real; sentences (B, 2, 2) each pair's two
    sentence spans [start, end) within its row.  Returns (ids (T,) int32,
    cu_seqlens (B + 1,) int32, positions (T,) int32, gather (B, 2, W) int64
    rows of the packed tokens, sentence lengths (B, 2) int32, max_len)."""
    with spans.span("tower.pack"):
        tokens = np.asarray(tokens)
        n = np.asarray(n_tokens, dtype=np.int64).reshape(-1)
        sent = np.asarray(sentences, dtype=np.int64)
        real = np.arange(tokens.shape[1])[None, :] < n[:, None]
        ids = tokens[real].astype(np.int32)
        cu = np.zeros(len(n) + 1, np.int32)
        cu[1:] = np.cumsum(n)
        positions = (np.arange(len(ids)) - np.repeat(cu[:-1], n)).astype(np.int32)
        lens = (sent[..., 1] - sent[..., 0]).astype(np.int32)
        width = max(1, int(lens.max()))
        gather = (cu[:-1, None, None].astype(np.int64) + sent[..., :1]
                  + np.arange(width)[None, None, :])
        gather = np.clip(gather, 0, max(len(ids) - 1, 0))
        return ids, cu, positions, gather, lens, int(n.max())


def head_crop(hidden, gather, lens, l_len: int):
    """Each sentence's hidden states as data/masking.summary_masking's head
    crop makes word features: the 3 summary frames (max, min, mean over
    the sentence's tokens), then its first l_len − 3 tokens, zero past its
    end; the mask covers len + 3 frames up to l_len (none for an empty
    sentence).  hidden (T, D); gather (B, 2, W) rows of it, lens (B, 2).
    Returns l (B, 2, l_len, D) f32 and l_mask (B, 2, l_len) f32."""
    b, s, w = gather.shape
    g = hidden[gather.reshape(-1)].view(b, s, w, -1).float()
    lens = lens.long()
    valid = (torch.arange(w, device=g.device)[None, None, :]
             < lens[..., None])[..., None]
    empty = (lens == 0)[..., None]
    mx = g.masked_fill(~valid, float("-inf")).amax(dim=2).masked_fill(empty, 0.0)
    mn = g.masked_fill(~valid, float("inf")).amin(dim=2).masked_fill(empty, 0.0)
    mean = (g * valid).sum(dim=2) / lens.clamp(min=1)[..., None].float()
    body = (g * valid)[:, :, : l_len - 3]
    if body.shape[2] < l_len - 3:
        body = F.pad(body, (0, 0, 0, l_len - 3 - body.shape[2]))
    feat = torch.cat([torch.stack([mx, mn, mean], dim=2), body], dim=2)
    frames = torch.arange(l_len, device=g.device)[None, None, :]
    mask = ((frames < (lens + 3).clamp(max=l_len)[..., None])
            & (lens > 0)[..., None]).float()
    return feat, mask


#: the keys a transcript sample adds to a pair sample (data/synthetic.py)
TOKEN_KEYS = ("tokens", "n_tokens", "sentences")
#: the keys `TowerFeed.pack` puts in their place
PACKED_KEYS = ("tower_ids", "tower_cu", "tower_pos", "tower_gather",
               "tower_lens")


class TowerFeed:
    """A frozen tower as the text modality of pair batches whose samples
    carry `TOKEN_KEYS` in place of `l` / `l_mask`; `l_len` is the grid's."""

    def __init__(self, tower: Tower, l_len: int):
        self.tower = tower
        self.l_len = int(l_len)

    def pack(self, batch: Dict) -> Tuple[Dict, int]:
        """(the host batch with `PACKED_KEYS` in place of `TOKEN_KEYS`,
        the longest sequence)."""
        rest = {k: v for k, v in batch.items() if k not in TOKEN_KEYS}
        ids, cu, pos, gather, lens, max_len = pack(
            batch["tokens"], batch["n_tokens"], batch["sentences"])
        rest.update(tower_ids=ids, tower_cu=cu, tower_pos=pos,
                    tower_gather=gather, tower_lens=lens)
        return rest, max_len

    def features(self, batch: Dict, max_len: int) -> Dict:
        """The device batch with `l` / `l_mask` from the tower in place of
        `PACKED_KEYS`."""
        rest = {k: v for k, v in batch.items() if k not in PACKED_KEYS}
        hidden = self.tower(batch["tower_ids"], batch["tower_cu"],
                            batch["tower_pos"], max_len)
        with spans.span("tower.gather"):
            rest["l"], rest["l_mask"] = head_crop(
                hidden, batch["tower_gather"], batch["tower_lens"], self.l_len)
        return rest
