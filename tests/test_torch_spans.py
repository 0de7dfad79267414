"""The port's span recorder (utils/spans.py) and the spans its layers open:
off by default with nothing recorded, parents per thread and across
threads, the capacity, the profiler's clock and thread ids, the span
trees of the Trainer, the ensemble pass and the BatchingServer, the Chrome
trace of `profile_trace`, and `capture_ms` read from its span."""

import dataclasses
import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import BatchingServer  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve.graphs import GraphedFunction  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from multimodal_emotion_processing_tpu_torch.utils import logging as ulog  # noqa: E402
from multimodal_emotion_processing_tpu_torch.utils import spans  # noqa: E402

TINY = dict(l_len=4, v_len=6, a_len=8, dim=12, n_heads=2)


@pytest.fixture
def recorder():
    """The recorder on, and off and empty again afterwards."""
    spans.drain()
    spans.enable()
    try:
        yield spans
    finally:
        spans.disable()
        spans.drain()


def _exp(name, **train):
    exp = configs.get(name)
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **TINY),
        train=dataclasses.replace(exp.train, **train))


def _by_name(drained):
    out = {}
    for s in drained["spans"]:
        out.setdefault(s[0], []).append(s)
    return out


def test_off_returns_the_shared_noop_and_records_nothing():
    spans.drain()
    assert not spans.enabled()
    s = spans.span("x")
    assert s is spans.NOOP and spans.span("y", parent=3) is spans.NOOP
    with s as inner:
        inner.attr("rows", 4)
        assert spans.current() is None and spans.stamp() is None
        spans.emit("z", 0, 1)
    assert list(spans.waited("w", iter([1, 2]))) == [1, 2]
    timer = spans.timed("t")
    with timer:
        time.sleep(0.001)
    assert timer.seconds > 0
    d = spans.drain()
    assert d["spans"] == [] and d["dropped"] == 0


def test_parents_nest_per_thread_and_cross_by_adoption(recorder):
    got = {}

    def feed(parent):
        spans.adopt(parent)
        with spans.span("feed.stack") as a:
            with spans.span("feed.gather") as b:
                got["feed"] = (a.id, b.id, threading.get_native_id())

    with spans.span("outer") as outer:
        with spans.span("inner") as inner:
            assert spans.current() == inner.id
            th = threading.Thread(target=feed, args=(spans.current(),))
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
        with spans.span("explicit", parent=12345) as ex:
            pass
    d = spans.drain()
    s = {x[0]: x for x in d["spans"]}
    assert s["outer"][4] is None and s["inner"][4] == outer.id
    assert s["explicit"][4] == 12345 and ex.id == s["explicit"][3]
    # the feed thread's first span hangs below the span passed to it
    assert s["feed.stack"][4] == inner.id
    assert s["feed.gather"][4] == got["feed"][0]
    assert s["feed.stack"][5] == got["feed"][2] != s["outer"][5]
    assert s["outer"][5] == threading.get_native_id()
    assert d["threads"][threading.get_native_id()] == threading.get_ident()
    for name, a, b, *_ in d["spans"]:
        assert a <= b
    assert s["outer"][1] <= s["inner"][1] <= s["inner"][2] <= s["outer"][2]


def test_capacity_counts_the_dropped(recorder, monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 5)
    for i in range(8):
        with spans.span("s") as sp:
            sp.attr("i", i)
    d = spans.drain()
    assert [x[6]["i"] for x in d["spans"]] == [0, 1, 2, 3, 4]
    assert d["dropped"] == 3
    assert spans.drain()["dropped"] == 0


def test_drained_times_are_the_profilers_clock_and_thread(recorder):
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64)
    ids = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with spans.span("add") as sp:
                a + a
            ids.append(sp.id)
    adds = sorted((e.start_ns(), e.end_ns(), e.device_resource_id())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == "aten::add")
    mine = sorted((x[1], x[2], x[5]) for x in spans.drain()["spans"]
                  if x[3] in ids)
    assert len(adds) == len(mine) == 20
    slack = []
    for (ea, eb, tid), (sa, sb, stid) in zip(adds, mine):
        assert tid == stid == threading.get_native_id()
        assert sa - 50_000 <= ea <= eb <= sb + 50_000
        slack.append(max(ea - sa, sb - eb))
    # the clocks agree to well inside 50 µs: the tightest span holds its
    # event that close at both ends (a loaded host only widens others)
    assert min(slack) <= 50_000


def test_trainer_fit_records_fit_epoch_step_and_feed_wait(recorder):
    exp = _exp("mosei_trans", batch_size=4)
    train = synthetic_dataset(exp.name, exp.model, 10, seed=0)
    valid = synthetic_dataset(exp.name, exp.model, 6, seed=1)
    tr = engine.Trainer(exp, exp.train, device="cpu")
    _, hist = tr.fit(loader.Batcher(train, 4, seed=1),
                     loader.Batcher(valid, 4, shuffle=False), epochs=2)
    d = spans.drain()
    by, ids = _by_name(d), {x[3]: x for x in d["spans"]}
    (fit,) = by["train.fit"]
    (init,) = by["train.init_state"]
    assert init[4] == fit[3]
    epochs = by["train.epoch"]
    assert [e[6]["epoch"] for e in epochs] == [0, 1]
    for e, h in zip(epochs, hist):
        assert e[4] == fit[3]
        assert (e[2] - e[1]) / 1e9 == h.seconds
    steps, waits = by["train.step"], by["feed.wait"]
    # 3 train and 2 valid batches an epoch; one wait more for each loader's end
    assert len(steps) == 2 * 5 and len(waits) == 2 * 7
    assert sorted(s[6]["kind"] for s in steps) == ["eval"] * 4 + ["train"] * 6
    for s in steps + waits:
        assert ids[s[4]][0] == "train.epoch"
    # on the CPU the Batcher gathers inside the consumer's wait
    for g in by["feed.gather"]:
        assert ids[g[4]][0] == "feed.wait"
    assert {s[4] for s in by["feed.stack"]} <= {w[3] for w in waits}


def test_ensemble_pass_records_waits_and_batches(recorder):
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble

    exp = _exp("mosei_trans")
    members = [build_model(exp, device="cpu", seed=i).eval() for i in range(2)]
    samples = synthetic_dataset(exp.name, exp.model, 10, seed=2)
    logits = Ensemble(members).predict_all(
        loader.Batcher(samples, 4, shuffle=False))
    assert logits.shape[0] == 10
    by = _by_name(spans.drain())
    (pas,) = by["eval.pass"]
    assert len(by["eval.batch"]) == 3 and len(by["feed.wait"]) == 4
    for s in by["eval.batch"] + by["feed.wait"]:
        assert s[4] == pas[3] and pas[1] <= s[1] <= s[2] <= pas[2]


def test_batching_server_spans_each_request(recorder):
    exp = _exp("robot_demo")
    members = [build_model(exp, device="cpu", seed=i).eval() for i in range(2)]
    samples = synthetic_dataset(exp.name, exp.model, 20, seed=5)
    with BatchingServer(members, exp.thresholds, max_delay_ms=5.0,
                        buckets=(1, 2, 4, 8)) as srv:
        futs = [srv.submit(s) for s in samples]
        for f in futs:
            f.result(timeout=120)
    d = spans.drain()
    by, ids = _by_name(d), {x[3]: x for x in d["spans"]}
    queues = by["serve.queue"]
    assert len(queues) == 20 and len({q[6]["rid"] for q in queues}) == 20
    batches = {b[3]: b for b in by["serve.batch"] if b[6]}
    assert sum(b[6]["requests"] for b in batches.values()) == 20
    calls = {c[4]: c for c in by["serve.call"]}
    assert set(calls) == set(batches)
    for q in queues:
        b, c = batches[q[4]], calls[q[4]]
        assert b[1] <= q[2] <= c[1] and q[1] <= q[2]
    for c in calls.values():
        assert c[6]["rows"] == batches[c[4]][6]["bucket"]
        assert c[6]["bytes"] > 0
    for name in ("serve.pack", "serve.launch", "serve.sync"):
        assert len(by[name]) == len(calls)
        assert all(ids[s[4]][0] == "serve.call" for s in by[name])
    for name in ("serve.collect", "serve.deliver"):
        assert {s[4] for s in by[name]} >= set(batches)


def test_profile_trace_writes_the_spans(tmp_path):
    spans.drain()
    with ulog.profile_trace(str(tmp_path), name="t") as path:
        assert spans.enabled()
        with spans.span("outer"):
            with spans.span("inner") as sp:
                sp.attr("rows", 3)
                torch.ones(8) + 1
    assert not spans.enabled() and spans.drain()["spans"] == []
    doc = json.loads(open(path).read())
    mine = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "span"}
    assert set(mine) == {"outer", "inner"}
    inner, outer = mine["inner"], mine["outer"]
    assert inner["ph"] == outer["ph"] == "X"
    assert inner["args"]["rows"] == 3
    assert inner["args"]["parent"] == outer["args"]["id"]
    assert inner["tid"] == threading.get_native_id()
    assert inner["pid"] == os.getpid()
    assert outer["ts"] <= inner["ts"] and inner["dur"] <= outer["dur"]
    add = [e for e in doc["traceEvents"] if e.get("name") == "aten::add"]
    assert add and inner["ts"] <= add[0]["ts"] <= inner["ts"] + inner["dur"]


def test_capture_ms_is_the_capture_span(recorder, monkeypatch):
    g = GraphedFunction(lambda x: x + 1, "cpu", name="probe")

    def fake_capture(key, leaves, spec):
        time.sleep(0.002)
        return "first"

    monkeypatch.setattr(g, "_capture_key", fake_capture)
    assert g._capture(None, [], None) == "first"
    (cap,) = [s for s in spans.drain()["spans"] if s[0] == "graph.capture"]
    assert cap[6] == {"name": "probe"}
    assert g.capture_ms == [(cap[2] - cap[1]) / 1e6]
    assert g.capture_ms[0] >= 2.0
