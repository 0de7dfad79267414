"""step_ms.<cell> (ms): the epochs' seconds (`EpochStats.seconds`) over
their optimizer steps, the mean over the window's epochs outside the
traced one (each epoch's valid pass included).  Layer: the epoch driver."""


def read(rec):
    if rec.work["steps"] <= 0:
        return None
    return 1e3 * rec.work["epoch_seconds"] / rec.work["steps"]
