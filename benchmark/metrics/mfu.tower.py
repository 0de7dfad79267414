"""mfu.tower (%): the useful FLOPs the window ran outside its traced
stretch, over that wall, of the configuration's peak (989 TFLOP/s, bf16):
the tower's per token (reference/tower_flops.py `flops_per_token`, every
layer's projections and SwiGLUs, the chosen experts only) and per causal
(query, key) pair (`flops_per_causal_pair`), then the members' grid
forwards (reference/flops.py).  Layer: the model step."""

from ..core import readers
from ..reference import flops, tower_flops


def read(rec):
    w = rec.work
    c = w.get("tower")
    if c is None or rec.window_s <= 0:
        return None
    total = (w["tower_tokens"] * tower_flops.flops_per_token(c)
             + w["causal_pairs"] * tower_flops.flops_per_causal_pair(c)
             + w["forwards"] * flops.forward_flops_per_sample(rec.model))
    if total <= 0:
        return None
    return 100.0 * total / rec.window_s / readers.peak_flops(rec)
