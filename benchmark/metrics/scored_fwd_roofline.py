"""scored_fwd_roofline.<cell> (%): the least time of every `scored_fwd`
launch in the traced stretch (reference/roofline.py `scored_bound` at
each launch's batch and stream shape, S_prev read where the block chains
one, S written where the next block reads it, f32 products at the
split-TF32 rate) over their device time in the trace.  Layer: the
kernels."""

from ..core import readers
from ..reference import roofline


def read(rec):
    m = rec.model
    dh = m.dim // m.n_heads
    return readers.kernel_share(
        rec, ["scored_fwd_kernel"], ["scored_fwd"], "forward",
        lambda b, lq, lkv, sp, em: roofline.scored_bound(
            b, m.n_heads, lq, lkv, dh, "split_tf32", sp, em)["bound_ms"])
