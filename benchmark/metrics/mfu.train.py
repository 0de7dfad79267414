"""mfu.train (%): pairs trained outside the traced epoch over that wall,
times three forwards' analytic matmul FLOPs (reference/flops.py; the
backward as two forwards), of the configuration's peak.  Layer: the
model step."""

from ..core import readers


def read(rec):
    return readers.mfu(rec, rec.work["samples"], 3 * readers.forward_flops(rec))
