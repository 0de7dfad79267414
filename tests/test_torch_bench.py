"""PyTorch port, the measurement entry points on the CPU, held against the
JAX package where it has the same function: `utils/timing.best_window_ms`'s
contract (tests/test_aux.py's), `Batcher(pad_final=False)` and
`drop_remainder` batches bit-equal to JAX's Batcher, `bench/scaling.py`'s
points, configs and FLOPs equal to JAX's, `latency._percentiles` and the
flagship's `combined` equal to JAX's; each entry point (scaling, latency,
serving, breakdown, all_configs, the flagship and `bench` on the CLI) run
once at a tiny width with the keys of its JAX counterpart's line (the
`jax_` prefixes dropped); the breakdown's terms summing to its step; the
flagship's plausibility gate; `StreamingPredictor(wire_dtype="float16")`
against JAX's; and `Trainer(mesh=)` refusing to split R-Drop pairs."""

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.bench import flops as jflops  # noqa: E402
from multimodal_emotion_processing_tpu.bench import latency as jlatency  # noqa: E402
from multimodal_emotion_processing_tpu.bench import scaling as jscaling  # noqa: E402
from multimodal_emotion_processing_tpu.data import loader as jloader  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.serve import (  # noqa: E402
    StreamingPredictor as JStreamingPredictor)
from multimodal_emotion_processing_tpu_torch import cli, configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.bench import (  # noqa: E402
    all_configs, breakdown, flagship, flops, latency, scaling, serving)
from multimodal_emotion_processing_tpu_torch.data import loader  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_dataset)
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import StreamingPredictor  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from multimodal_emotion_processing_tpu_torch.utils.timing import (  # noqa: E402
    best_window_ms, fetch_one)
from torch_driver_common import one_intra_op_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
TINY = {"dim": 12, "n_heads": 2, "l_len": 4, "v_len": 6, "a_len": 8,
        "l_dim": 5, "v_dim": 4, "a_dim": 3}
TINY_SET = [f"model.{k}={v}" for k, v in TINY.items()] + ["train.batch_size=4"]
ROBOT_SET = ["model.dim=12", "model.n_heads=2", "model.l_len=4",
             "model.v_len=9", "model.a_len=9", "model.l_dim=7",
             "model.a_dim=5", "model.v_dims_multires=[3,4,5]",
             "train.batch_size=4"]


def _jax_root_bench():
    """The JAX package's root bench.py, loaded by path (its top level
    imports numpy and the standard library only)."""
    spec = importlib.util.spec_from_file_location("jax_root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- utils/timing ----------------------------------------------------------

def test_best_window_ms_contract():
    """Best ms/call, every window in all_windows, sync_pick applied, and
    the warm call before any timed window (tests/test_aux.py's contract)."""
    calls, picked = [], []

    def wrapped(x):
        calls.append(1)
        return {"out": x * 2.0}

    def pick(o):
        picked.append(1)
        return o["out"]

    windows = []
    ms = best_window_ms(wrapped, torch.ones(4), steps=3, reps=2,
                        sync_pick=pick, all_windows=windows)
    assert ms > 0
    assert len(windows) == 2 and min(windows) == ms
    assert len(calls) == 1 + 2 * 3      # warm-up + reps x steps
    assert len(picked) == 1 + 2         # one fetch per window and the warm call


def test_fetch_one_reads_the_first_tensor():
    assert fetch_one(torch.tensor([[3.0, 4.0]])) == 3.0
    assert fetch_one((torch.tensor(5.0), torch.tensor(6.0))) == 5.0
    assert fetch_one({"a": [torch.tensor([7.0])]}) == 7.0
    with pytest.raises(TypeError):
        fetch_one((1.0,))


# ---- data/loader.Batcher ---------------------------------------------------

def _flat(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((2, 3)).astype(np.float32),
             "m": np.ones(3, np.float32), "label": np.int32(i)}
            for i in range(n)]


@pytest.mark.parametrize("kw", [
    dict(pad_final=False),
    dict(pad_final=False, shuffle=True, seed=3),
    dict(pad_final=False, duplicate=True, shuffle=True, seed=1),
    dict(drop_remainder=True),
    dict(drop_remainder=True, duplicate=True, shuffle=True, seed=2),
    dict(drop_remainder=True, pad_final=False, shuffle=True, seed=4),
    dict(pad_final=True, shuffle=True, seed=5),
])
@pytest.mark.parametrize("n", [7, 8])
def test_batcher_matches_jax(kw, n):
    """The same samples, batch size, seed, shuffle and duplicate give the
    same batches, bit for bit, over two epochs, and the same
    steps_per_epoch."""
    kw = {"shuffle": False, **kw}
    samples = _flat(n)
    ours, theirs = loader.Batcher(samples, 3, **kw), jloader.Batcher(samples, 3, **kw)
    for _ in range(2):
        got, want = list(ours()), list(theirs())
        assert len(got) == len(want) == ours.steps_per_epoch()
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert ours.steps_per_epoch() == theirs.steps_per_epoch()


def test_batcher_ragged_unpadded_matches_jax():
    """Ragged samples (shapes that do not stack) gather row by row, with
    the first row's shape, as JAX's tests/test_data.py has them."""
    samples = [{"x": np.ones(3, np.float32)}, {"x": np.ones(3, np.float32)},
               {"x": np.ones(3, np.float32) * 2}] + [
                  {"x": np.ones(3, np.float32) * 3}] * 2
    samples = [dict(s, y=np.full(1 + (i == 0), i, np.int32))
               for i, s in enumerate(samples)]
    for kw in (dict(pad_final=False), dict(drop_remainder=True)):
        ours = list(loader.Batcher(samples, 2, shuffle=False, **kw)())
        theirs = list(jloader.Batcher(samples, 2, shuffle=False, **kw)())
        assert len(ours) == len(theirs)
        for g, w in zip(ours, theirs):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_batcher_unpadded_final_batch():
    b = list(loader.Batcher(_flat(7), 3, shuffle=False, pad_final=False)())
    assert [x["x"].shape[0] for x in b] == [3, 3, 1]
    assert all("sample_weight" not in x for x in b)
    d = loader.Batcher(_flat(7), 3, shuffle=False, drop_remainder=True)
    assert [x["x"].shape[0] for x in d()] == [3, 3] and d.steps_per_epoch() == 2


# ---- bench/scaling -----------------------------------------------------------

def test_scaling_points_and_configs_equal_jax():
    assert scaling.POINTS == jscaling.POINTS
    for name, spec in scaling.POINTS.items():
        ours, theirs = scaling._point_config(spec), jscaling._point_config(spec)
        assert dataclasses.asdict(ours.model) == dataclasses.asdict(theirs.model)
        assert dataclasses.asdict(ours.train) == dataclasses.asdict(theirs.train)
        assert flops.train_flops_per_sample(ours.model) == \
            jflops.train_flops_per_sample(theirs.model)
        assert flops.forward_flops_per_sample(ours.model) == \
            jflops.forward_flops_per_sample(theirs.model)


SCALING_KEYS = {"point", "impl", "dtype", "batch", "remat", "peak_hbm_gb",
                "dim", "lens", "train_sps", "ms_per_step",
                "train_gflops_per_sample", "achieved_tflops", "mfu",
                "infer_sps", "infer_ms_per_step", "infer_achieved_tflops",
                "infer_mfu", "compile_s"}


def test_scaling_point_smoke():
    """measure_point on a tiny point on the CPU, f32 and bf16: the JAX
    row's keys (tests/test_aux.py), the peak it divides by, sane values."""
    spec = dict(dim=16, n_heads=2, l_len=4, v_len=6, a_len=8, batch=4)
    row = scaling.measure_point("tiny", spec, dtype="float32", steps=2,
                                reps=1, device="cpu")
    assert SCALING_KEYS <= set(row)
    assert row["train_sps"] > 0 and row["infer_sps"] > 0
    assert 0 <= row["mfu"] < 1 and 0 <= row["infer_mfu"] < 1
    assert row["point"] == "tiny" and row["batch"] == 4
    assert row["peak_tflops"] == flops.PEAK_TFLOPS["float32"]
    assert row["device"] == "cpu" and row["peak_hbm_gb"] is None
    row16 = scaling.measure_point("tiny", spec, dtype="bfloat16", steps=2,
                                  reps=1, device="cpu", impl="pallas")
    assert row16["dtype"] == "bfloat16" and row16["train_sps"] > 0
    assert row16["peak_tflops"] == flops.PEAK_TFLOPS["bfloat16"]


def test_peak_for_each_row():
    assert flops.peak_for("bfloat16", "pallas") == 989.0
    assert flops.peak_for("float32", "xla") == 67.0
    assert flops.peak_for("float32", "flash") == 67.0
    assert flops.peak_for("float32", "pallas_fused") == 495.0 / 3
    assert flops.peak_for("float32", "xla", tf32=True) == 495.0


def test_scaling_main_prints_a_line_per_point(capsys):
    rows = scaling.main(["--points=ref", "--impl=xla,flash",
                         "--dtypes=float32", "--device", "cpu", "--steps", "2",
                         "--reps", "1", *[f"--set={s}" for s in TINY_SET]])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == rows and [r["impl"] for r in rows] == ["xla", "flash"]
    assert all(r["dim"] == 12 and r["batch"] == 4 for r in rows)


# ---- bench/latency and bench/serving ---------------------------------------

def test_percentiles_equal_jax():
    times = list(np.random.default_rng(0).exponential(0.01, 57))
    assert latency._percentiles(times) == jlatency._percentiles(times)


def test_latency_line(capsys):
    out = latency.main(["robot_demo", "--device", "cpu", "--reps", "12",
                        "--cpu-reps", "3", *[f"--set={s}" for s in ROBOT_SET]])
    line = json.loads(capsys.readouterr().out)
    assert line == json.loads(json.dumps(out))
    assert {"metric", "compute", "end_to_end", "torch_cpu",
            "compute_speedup_p50"} <= set(out)
    for leg in ("compute", "end_to_end", "torch_cpu"):
        assert set(out[leg]) == {"p50_ms", "p90_ms", "best_ms"}
        assert out[leg]["best_ms"] <= out[leg]["p50_ms"] <= out[leg]["p90_ms"]
    assert out["device"] == "cpu"


def test_serving_line():
    out = serving.measure("robot_demo", 6, members=2, reps=1, device="cpu",
                          buckets=(1, 2, 4), sets=ROBOT_SET)
    assert set(out) == {"config", "n_requests", "members", "sequential_rps",
                        "server_rps", "speedup", "ms_per_req",
                        "server_batches", "by_bucket", "http", "device"}
    assert out["sequential_rps"] > 0 and out["server_rps"] > 0
    assert set(out["http"]) == {"binary_rps", "json_rps", "payload_mb"}
    assert sum(int(k) * v for k, v in out["by_bucket"].items()) >= 6


# ---- bench/breakdown and bench/all_configs ---------------------------------

BREAKDOWN_KEYS = {"config", "batch", "forward_ms", "loss_delta_ms",
                  "backward_delta_ms", "optimizer_delta_ms", "train_step_ms",
                  "attention_only_sum_ms", "attention_streams_ms", "note"}


@pytest.mark.parametrize("name,impl,sets", [
    ("mosei_trans", "pallas_fused", TINY_SET),
    ("mosei_realformer", "pallas", TINY_SET + ["model.p_len=2",
                                               "train.batch_size=2"]),
])
def test_breakdown_ledger(name, impl, sets):
    """JAX's ledger keys; the four terms add up to the step within their
    rounding; nine streams, and nine +sprev ones where n_layers > 1."""
    d = breakdown.measure(name, impl, device="cpu", sets=sets, steps=2,
                          reps=1)
    assert BREAKDOWN_KEYS <= set(d)
    terms = (d["forward_ms"] + d["loss_delta_ms"] + d["backward_delta_ms"]
             + d["optimizer_delta_ms"])
    assert abs(terms - d["train_step_ms"]) <= 0.021
    n_layers = configs.get(name).model.n_layers
    assert len(d["attention_streams_ms"]) == 9 * (2 if n_layers > 1 else 1)
    assert d["attention_impl"] == breakdown.stream_impl(impl)
    assert d["train_step_ms"] > 0 and d["attention_only_sum_ms"] > 0


def test_all_configs_lines(capsys):
    rows = all_configs.main(["xla", "--configs", "mosei_trans,rencecps",
                             "--device", "cpu", "--steps", "2", "--reps", "1",
                             "--scan-k", "2", "--set=model.dim=12",
                             "--set=model.n_heads=2", "--set=model.l_len=4",
                             "--set=model.v_len=6", "--set=model.a_len=8",
                             "--set=model.l_dim=12",
                             "--set=train.batch_size=4"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == rows and [r["config"] for r in rows] == ["mosei_trans",
                                                             "rencecps"]
    for r in rows:
        assert {"config", "impl", "batch", "train_sps", "infer_sps", "scan_k",
                "scan_train_sps", "scan_infer_sps"} <= set(r)
        assert min(r[k] for k in ("train_sps", "infer_sps", "scan_train_sps",
                                  "scan_infer_sps")) > 0


def test_synth_batch_is_unpadded():
    exp = configs.get("rencecps")
    b = all_configs.synth_batch("rencecps", exp.model, 3)
    assert "sample_weight" not in b and b["label"].shape[0] == 3


# ---- the flagship and `bench` ----------------------------------------------

def test_combined_equals_jax():
    jb = _jax_root_bench()
    for tr, inf, b in ((100.0, 300.0, 64), (1.5, 2.5, 8), (7e3, 1e4, 256)):
        assert flagship.combined(tr, inf, b) == jb.combined(tr, inf, b)


def test_headline_excludes_a_candidate_above_its_peak():
    f_tr = 1e9                             # FLOPs a sample
    cand = {"xla": (1000.0, 3000.0, 67.0),               # 1 TFLOP/s
            "xla,scan k=128": (1e5, 1e6, 67.0),          # 100 TFLOP/s > 67
            "pallas": (2000.0, 2500.0, 495.0 / 3)}
    impl, value, implausible = flagship.headline(cand, 64, f_tr)
    assert implausible == ["xla,scan k=128"]
    assert impl == "pallas" and value == flagship.combined(2000.0, 2500.0, 64)
    # every candidate implausible: the least implausible is emitted
    impl, _, implausible = flagship.headline(
        {"a": (1e5, 1.0, 67.0), "b": (2e5, 1.0, 67.0)}, 64, f_tr)
    assert impl == "a" and implausible == ["a", "b"]


FLAGSHIP_SETS = [f"model.{k}={v}" for k, v in TINY.items()
                 if k not in ("l_dim", "v_dim", "a_dim")] + [
    "train.batch_size=16"]


def test_bench_command_prints_one_json_line(capsys):
    out = cli.main(["bench", "--device", "cpu", "--budget-s", "3",
                    "--scan-ks", "2,4", *[f"--set={s}" for s in FLAGSHIP_SETS]])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(out))
    assert {"metric", "value", "unit", "vs_baseline", "diagnostics"} == set(out)
    d = out["diagnostics"]
    assert out["value"] > 0 and out["vs_baseline"] > 0
    assert d["phase_errors"] == {} and d["device"] == "cpu"
    for key in ("impl", "xla", "scan", "scan_hi", "pallas", "datafed_train_sps",
                "datafed_train_sps_f32", "datafed_train_sps_scan_k8",
                "datafed_train_sps_f16_wire", "datafed_train_sps_int8_wire",
                "families", "bf16", "latency_batch1", "flops",
                "mfu_implausible_excluded", "torch_cpu", "budget_s",
                "elapsed_s"):
        assert key in d, key
    assert d["xla"]["train_sps"] > 0 and d["torch_cpu"]["train_sps"] > 0


def test_pallas_parity_on_the_cpu():
    exp = configs.with_overrides(configs.get("mosei_trans"),
                                 {"model": TINY, "train": {"batch_size": 4}})
    batch = flagship.make_batch(exp.model, 4)
    diff, rel = flagship.pallas_parity(exp, batch, torch.device("cpu"))
    assert 0 <= rel < 1e-5 and diff <= rel * 1e3


def test_bench_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for fn in (lambda: latency.main(["mosei_trans"]),
               lambda: breakdown.main([]),
               lambda: serving.main(["robot_demo", "2"]),
               lambda: all_configs.main(["--configs", "rencecps"]),
               lambda: scaling.measure_point("ref", scaling.POINTS["ref"]),
               lambda: cli.main(["bench"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# ---- StreamingPredictor(wire_dtype=) ---------------------------------------

def test_streaming_predictor_packed_f16_wire_matches_jax():
    """JAX's tests/test_train_eval.py case: the float16 packed buffer has
    half the bytes, and its probabilities stay within 5e-3 of the f32
    wire's; and the port's f16 wire gives JAX's f16 wire's answers (the
    same rounded inputs) within 2e-4."""
    exp = configs.with_overrides(configs.get("mosei_trans"), {"model": TINY})
    jexp = dataclasses.replace(jconfigs.get("mosei_trans"),
                               model=jconfigs.ModelConfig(
                                   **dataclasses.asdict(exp.model)))
    jmodel = jbuild(jexp)
    jps = [jmodel.init(jax.random.PRNGKey(i)) for i in range(2)]
    members = []
    for p in jps:
        m = build_model(exp, device="cpu")
        m.load_state_dict(from_jax_params(jax.device_get(p), exp.model))
        members.append(m.eval())
    sample = synthetic_dataset("mosei_trans", exp.model, 1, seed=5)[0]
    f32 = StreamingPredictor(members, exp.thresholds)
    f16 = StreamingPredictor(members, exp.thresholds, wire_dtype="float16")
    p0, pr0 = f32.predict(sample)
    p1, pr1 = f16.predict(sample)
    assert f16.packed_program(sample).host.dtype == torch.float16
    assert (f16.packed_program(sample).host.nbytes * 2
            == f32.packed_program(sample).host.nbytes)
    np.testing.assert_allclose(p1, p0, rtol=0, atol=5e-3)
    np.testing.assert_allclose(pr1, pr0, rtol=0, atol=5e-3)
    jf16 = JStreamingPredictor(jmodel, jps, offsets=jexp.thresholds,
                               wire_dtype="float16")
    jp, jpr = jf16.predict(sample)
    np.testing.assert_allclose(p1, jp, rtol=0, atol=2e-4)
    np.testing.assert_allclose(pr1, jpr, rtol=0, atol=2e-4)
    for bad in ("int8", "bfloat16", "float64"):
        with pytest.raises(ValueError, match="wire_dtype"):
            StreamingPredictor(members, exp.thresholds, wire_dtype=bad)


# ---- Trainer(mesh=) and R-Drop ----------------------------------------------

def test_trainer_mesh_refuses_to_split_rdrop_pairs():
    """On a data axis that batch_size does not divide, a rank's rows would
    end inside an R-Drop pair: refused at construction, before any
    collective (the same error as pipelines.run_experiment's).  A
    stand-in mesh on the CPU: the check reads its data axis only."""
    exp = configs.get("ren_mme")
    mesh = SimpleNamespace(shape={"data": 4, "model": 1},
                           device=torch.device("cpu"))
    tcfg = dataclasses.replace(exp.train, batch_size=6)
    with pytest.raises(ValueError, match=r"R-Drop's duplicate pairs .* "
                                         r"batch_size \(6\) .* axis \(4\)"):
        engine.Trainer(exp, tcfg, mesh=mesh)
    # pairs that stay whole, and a batch without R-Drop, pass the check
    engine.Trainer(exp, dataclasses.replace(tcfg, batch_size=8), mesh=mesh)
    engine.Trainer(exp, dataclasses.replace(tcfg, rdrop_kl=False), mesh=mesh)
