"""A `--trace 1` run on the CPU: the per-layer readers found by name (a
metric's own file, else its family's), the counts they divide taken
outside the traced stretch, and a reader with nothing to read leaving its
metric out rather than reporting 0."""

import time

import pytest

from benchmark.core import spec
from benchmark.core import harness
from benchmark.core.trace import Tracer

DOC = spec.manifest()
CELLS = [w["name"] for w in DOC["workloads"]]


def test_reader_is_the_metrics_own_file_else_its_familys():
    assert spec.Cell.reader("mfu.train").__file__.endswith("mfu.train.py")
    assert spec.Cell.reader("mfu.eval").__file__.endswith("mfu.py")
    assert spec.Cell.reader("idle_share.any_cell").__file__.endswith(
        "idle_share.py")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_counted_metrics(tiny, cell):
    c = spec.Cell(cell)
    result, _ = harness.run(c, seed=3_100_000_017, seconds=1.5, trace=True,
                            device="cpu", t0=time.perf_counter(),
                            overrides=tiny[cell])
    assert result["correct"]
    names = {m["name"]: m for m in c.per_layer}
    assert set(result["metrics"]) <= set(names)
    # the host's counts are read; the CPU's trace has no device activity,
    # so the device's metrics are left out, never 0
    for name, m in names.items():
        if m["source"] == "device_trace":
            assert name not in result["metrics"]
        else:
            assert result["metrics"][name]["value"] > 0


def _window(cell, tiny, seconds):
    c = spec.Cell(cell)
    ctx = harness.Context(c, 3_100_000_019, "cpu", tiny[cell],
                          time.perf_counter())
    mod = c.driver()
    program = mod.Cell(ctx)
    tracer = Tracer("cpu", True, dict)
    t = time.perf_counter()
    win = mod.window(program, seconds, tracer)
    return mod, program, tracer, win, time.perf_counter() - t


def test_eval_counts_leave_the_traced_passes_out(tiny):
    mod, program, tracer, win, elapsed = _window("mosei_trans.eval", tiny, 2.0)
    n = len(program.logits[0])
    assert len(program.logits) > 1 + mod.TRACED_PASSES
    assert win.work["samples"] == n * (len(program.logits)
                                       - mod.TRACED_PASSES)
    assert win.work["forwards"] == win.work["samples"] * win.work["members"]
    assert 0 < win.wall_s <= elapsed - tracer.summary.window_s


def test_train_counts_leave_the_traced_epoch_out(tiny):
    mod, program, tracer, win, elapsed = _window("mosei_trans.train", tiny, 2.0)
    assert tracer.summary is not None
    steps_per_epoch = win.work["steps"] // win.work["epochs"]
    assert win.attempted == win.work["steps"] + steps_per_epoch
    assert 0 < win.wall_s <= elapsed - tracer.summary.window_s
    assert win.work["epoch_seconds"] < win.wall_s
    program.release()


def _record(launched, traced):
    from collections import Counter

    from benchmark.core import port, readers
    from benchmark.core.trace import TraceSummary

    c = spec.Cell("mosei_trans.eval")
    m = port.experiment(c.config).model
    per_pass = len(list(readers.block_calls(m))) * readers.grids(m)
    summary = TraceSummary(
        window_s=1.0, busy_s=0.5, ops={"fused_block_kernel<1>": (0.25, traced)},
        gaps=[], launches={"fused_block": launched},
        passes={"forward": Counter({64: 400})})
    rec = harness.Record(cell=c.name, model=m, config=c.config, window_s=1.0,
                         work={}, trace=summary)
    return rec, 400 * per_pass


def test_kernel_share_holds_the_trace_to_the_counted_launches():
    reader = spec.Cell.reader("fused_block_roofline.eval")
    n = _record(0, 0)[1]
    whole = reader.read(_record(n, n)[0])
    assert 0 < whole < 100
    # a record the profiler dropped: the bound over the traced launches
    assert reader.read(_record(n, n - 1)[0]) == pytest.approx(
        whole * (n - 1) / n)
    # more traced than made, counters that disagree with the passes, or
    # more than a thousandth missing: nothing to read
    assert reader.read(_record(n, n + 1)[0]) is None
    assert reader.read(_record(n - 1, n - 1)[0]) is None
    assert reader.read(_record(n, n - n // 1000 - 1)[0]) is None
