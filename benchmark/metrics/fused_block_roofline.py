"""fused_block_roofline.<cell> (%): the least time of every
`fused_block` launch in the traced stretch (reference/roofline.py
`fused_bound` at the grid's stream shapes, f32 products at the
split-TF32 rate, no S_prev, no S and no ctx residual written) over their
device time in the trace.  Layer: the kernels."""

from ..core import readers
from ..reference import roofline


def _bound(b, lq, lkv, has_sprev, emit, m):
    return roofline.fused_bound(b, m.n_heads, lq, lkv, m.dim // m.n_heads,
                                "split_tf32", has_sprev, emit, False)["bound_ms"]


def read(rec):
    m = rec.model
    return readers.kernel_share(
        rec, ["fused_block_kernel"], ["fused_block"], "forward",
        lambda b, lq, lkv, sp, em: _bound(b, lq, lkv, sp, em, m))
