"""batch_fill.<cell> (%): requests over the rows of the batches that ran
them (each batch padded up to its bucket), over the window before its
traced half (`BatchingServer.stats()`).  Layer: batching."""


def read(rec):
    if rec.work["batch_rows"] <= 0:
        return None
    return 100.0 * rec.work["requests"] / rec.work["batch_rows"]
