"""idle_share.<cell> (%): 1 − device busy / wall over the traced
stretch, busy being the union of the device's kernel, copy and fill
intervals (reference/profile.py).  Layer: the device."""

from ..core import readers


def read(rec):
    return readers.idle_share(rec)
