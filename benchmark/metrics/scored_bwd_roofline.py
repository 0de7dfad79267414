"""scored_bwd_roofline.<cell> (%): the least time of every backward pair
(`scored_bwd_dq` and `scored_bwd_dkv`, one pair a block) in the traced
stretch (reference/roofline.py `scored_bwd_bounds`, the pair, f32
products at the split-TF32 rate) over the two kernels' device time in
the trace.  Layer: the kernels."""

from ..core import readers
from ..reference import roofline


def read(rec):
    m = rec.model
    dh = m.dim // m.n_heads

    def bound(b, lq, lkv, has_sprev, emit):
        # one pair, both launches, for each block's backward
        return roofline.scored_bwd_bounds(b, m.n_heads, lq, lkv, dh,
                                          "split_tf32", has_sprev,
                                          emit)["pair"]["bound_ms"]

    return readers.kernel_share(
        rec, ["scored_bwd_dq_kernel", "scored_bwd_dkv_kernel"],
        ["scored_bwd_dq", "scored_bwd_dkv"], "backward", bound)
