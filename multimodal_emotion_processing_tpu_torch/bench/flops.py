"""Analytic FLOPs accounting for MFU reporting (bench/flops.py of the JAX
package, its formulas figure for figure).

The reference publishes no FLOPs or utilization numbers; this module gives
every config an analytic matmul-FLOPs count, so that a throughput can be
reported as achieved TFLOP/s and as a share of the card's peak (MFU).
Counts cover the matmul terms only (projections, QKᵀ, AV, epilogues,
classifiers, where essentially all the FLOPs are); the softmax, LayerNorm
and pooling elementwise work is O(L·D) against the O(L²·D) + O(L·D²)
matmuls and is omitted, which makes the reported MFU a slight
underestimate.

A matmul (m, k) @ (k, n) counts 2·m·k·n FLOPs.  Head splitting does not
change FLOP counts.  Backward ≈ 2× forward (dW and dX per matmul), so a
train step counts 3× forward, the standard MFU convention; a step under
`ModelConfig.remat` recomputes each block's forward in the backward, work
this convention does not count.
"""

from __future__ import annotations

# NVIDIA H100 SXM peaks (data sheet, dense, at its 700 W limit), TFLOP/s:
# bf16 on the tensor cores, TF32 on the tensor cores, f32 outside them
PEAK_TFLOPS = {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0}


def _grid_forward_flops(m) -> float:
    """One 9-stream grid forward, per sample (models/grid.py)."""
    d = m.dim
    lens = {"l": m.l_len, "v": m.v_len, "a": m.a_len}
    f = 0.0
    # unify projections (linear and 1x1-conv count identically)
    if m.unify == "conv_multires":
        # robot: three visual resolution slots -> dim/3 each
        # (robot_demo.py:297-310); l/a project to full dim
        f += 2 * m.l_len * m.l_dim * d + 2 * m.a_len * m.a_dim * d
        f += sum(2 * m.v_len * vd * (d // 3) for vd in m.v_dims_multires)
    else:
        f += (2 * m.l_len * m.l_dim * d + 2 * m.v_len * m.v_dim * d
              + 2 * m.a_len * m.a_dim * d)
    # nine directed streams x n_layers blocks
    for qm in ("l", "v", "a"):
        for kvm in ("l", "v", "a"):
            lq, lkv = lens[qm], lens[kvm]
            per_layer = 0.0
            if m.block == "realformer":
                # separate Q/K/V projections (others/realformer.py:157,188)
                per_layer += 2 * lq * d * d + 2 * 2 * lkv * d * d
                # ReLU FFN of width ffn*d (others/realformer.py:163-168)
                per_layer += 2 * 2 * lq * d * (m.ffn * d)
            per_layer += 2 * lq * lkv * d      # QK^T scores
            per_layer += 2 * lq * lkv * d      # attention @ V
            per_layer += 2 * lq * d * d        # output proj
            if m.block == "minus":
                per_layer += 2 * lq * (2 * d) * d   # concat-minus Linear
            f += m.n_layers * per_layer
    return f


def _grid_head_flops(m, collect: str) -> float:
    """Classifier / feature head on the pooled (dim*6*k) vector."""
    k = m.n_layers if collect == "per_layer" else 1
    pooled = m.dim * 6 * k
    if collect == "final":   # realformer feature head: FC dim*6 -> dim
        return 2 * pooled * m.dim
    return 2 * pooled * m.n_emotions


def forward_flops_per_sample(m) -> float:
    """Matmul FLOPs of ONE model forward for one sample, per config head."""
    e = m.n_emotions
    trans = 2 * e * e * e + 2 * e * e      # rank-3 bilinear (heads.py)
    out = 2 * (2 * e) * e                  # Linear(2E -> E)
    if m.head == "concat_trans":
        # two grids (intensity on the previous slot, stimulation on the
        # current, cmu-mosei/run.py:329-331) + transition head
        grid = _grid_forward_flops(m) + _grid_head_flops(m, "per_layer")
        return 2 * grid + trans + out
    if m.head == "concat_linear":
        # rencecps: two Linears(l_dim -> E) + transition (rencecps/run.py:130-148)
        return 2 * (2 * m.l_dim * e) + trans + out
    if m.head == "state_transfer":
        # p_len clips through one grid + classifier(dim -> 2E) + the cheap
        # gated recurrence (others/realformer.py:266-286)
        grid = _grid_forward_flops(m) + _grid_head_flops(m, "final")
        per_clip = grid + 2 * m.dim * (2 * e) + 2 * e * e
        return m.p_len * per_clip
    if m.head == "grid_only":
        return _grid_forward_flops(m) + _grid_head_flops(m, "per_layer")
    raise ValueError(m.head)


def train_flops_per_sample(m) -> float:
    """Forward + backward ≈ 3x forward (standard MFU convention)."""
    return 3.0 * forward_flops_per_sample(m)


def mfu(samples_per_sec: float, flops_per_sample: float,
        peak_tflops: float = PEAK_TFLOPS["bfloat16"]) -> float:
    """Fraction of peak: achieved FLOP/s over the card's peak."""
    return samples_per_sec * flops_per_sample / (peak_tflops * 1e12)
