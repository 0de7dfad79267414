"""mla_roofline.tower (%): the least time of the latent attention kernel
(`flash_fwd_mla_varlen`, csrc/flash_fwd.cu `flash_fwd_mla_kernel`) over
the traced batches (reference/tower_flops.py `attention_bound_s` of each
batch's sequence lengths, every layer) over its device time in the
trace.  Read only if its launch counter, the traced batches and the
trace agree (up to a thousandth of the launches may be missing from the
trace).  Layer: the kernels."""

from ..core import device as card
from ..reference import profile, tower_flops


def read(rec):
    t, w = rec.trace, rec.work
    if t is None or "traced_lengths" not in w:
        return None
    c = w["tower"]
    seconds, events = profile.matching(t.ops, "flash_fwd_mla_kernel")
    launches = t.launches.get("flash_fwd_mla_varlen", 0)
    expected = w["traced_batches"] * c["num_hidden_layers"]
    if seconds <= 0 or launches != expected or not (
            expected - expected // 1000 <= events <= expected):
        card.log(f"[{rec.cell}] flash_fwd_mla_kernel: {events} traced, "
                 f"{launches} counted, {expected} expected: not read")
        return None
    bound = (tower_flops.attention_bound_s(c, w["traced_lengths"])
             * events / expected)
    return 100.0 * bound / seconds
