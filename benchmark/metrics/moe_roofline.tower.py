"""moe_roofline.tower (%): the least time of the routed experts' kernels
(`moe_gate_up` and `moe_down`, csrc/moe.cu `moe_gemm_kernel`, and
`moe_combine`, `moe_combine_kernel`) over the traced batches
(reference/tower_flops.py `expert_bound_s` and `combine_bound_s` of the
routed rows of each MoE layer and expert, from the tower's counts at the
traced stretch's edges) over their device time in the trace.  Read only
if the kernels' launch counters, the traced batches and the trace agree
(up to a thousandth of the launches may be missing from the trace).
Layer: the kernels."""

from ..core import device as card
from ..reference import profile, tower_flops

KERNELS = ("moe_gate_up", "moe_down", "moe_combine")
TRACED = ("moe_gemm_kernel", "moe_combine_kernel")


def read(rec):
    t, w = rec.trace, rec.work
    if t is None or "traced_routed" not in w:
        return None
    c = w["tower"]
    seconds = events = 0
    for needle in TRACED:
        s, n = profile.matching(t.ops, needle)
        seconds, events = seconds + s, events + n
    launches = sum(w["traced_moe_launches"].get(k, 0) for k in KERNELS)
    expected = len(KERNELS) * w["traced_batches"] * (
        c["num_hidden_layers"] - c["first_k_dense_replace"])
    if seconds <= 0 or launches != expected or not (
            expected - expected // 1000 <= events <= expected):
        card.log(f"[{rec.cell}] {TRACED}: {events} traced, {launches} "
                 f"counted, {expected} expected: not read")
        return None
    routed = w["traced_routed"]
    bound = (tower_flops.expert_bound_s(c, routed)
             + tower_flops.combine_bound_s(c, routed)) * events / expected
    return 100.0 * bound / seconds
