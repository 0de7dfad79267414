"""outside_share.<cell> (%): the share of the window's wall (the traced
stretch left out) outside the epochs' own seconds (`EpochStats.seconds`,
the train and valid steps of each epoch): checkpoint saves, member
boundaries (loaders, state, the step's capture) and the fit's
bookkeeping.  Layer: the k-fold driver."""


def read(rec):
    if rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.work["epoch_seconds"] / rec.window_s)
