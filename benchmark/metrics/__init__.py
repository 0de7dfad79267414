"""Per-layer metric readers, each with `read(record)`: the value, or None
where the run has nothing to read.  A metric `<family>.<cell>` reads with
`<family>.py`, or with `<family>.<cell>.py` where its arithmetic is its
own (`spec.Cell.reader`)."""
