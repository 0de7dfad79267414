"""mfu.<cell> of a forward-only cell (%): the single-sample member
forwards the window ran outside its traced stretch (`work["forwards"]`:
pairs or requests times the members; padding rows do not count), times
one forward's analytic matmul FLOPs (reference/flops.py), over that
wall, of the configuration's peak.  Layer: the model step."""

from ..core import readers


def read(rec):
    return readers.mfu(rec, rec.work["forwards"], readers.forward_flops(rec))
