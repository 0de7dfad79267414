"""PyTorch port, the CLI's tools on the CPU: `summary` (each config's total
equal to the JAX package's parameter_count, its FLOPs equal to JAX's
bench/flops.py, for every config of both registries), `.json` config files
and a run's run_meta.json (configs.load_config_file, cli
apply_config_file, against JAX's), `--tuned` (bench/autotune.apply_tuned,
the cases of tests/test_autotune.py), the structure of a `tune` record at
a tiny config (the lossy gate, the stacked arm skipped, the margin rule),
`doctor --device cpu`'s keys, `--profile-dir` (a Chrome trace from the
sequential, device-resident and one-dispatch drivers) and `--debug-nans`
(the forward names the module, the backward the autograd function)."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.bench import flops as jflops  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.utils import parameter_count as jcount  # noqa: E402
from multimodal_emotion_processing_tpu_torch import cli, configs, pipelines  # noqa: E402
from multimodal_emotion_processing_tpu_torch.bench import autotune  # noqa: E402
from multimodal_emotion_processing_tpu_torch.utils import (  # noqa: E402
    parameter_breakdown, parameter_count)
from multimodal_emotion_processing_tpu_torch.utils.logging import (  # noqa: E402
    enable_nan_debugging, nan_debugging_enabled)
from torch_driver_common import one_intra_op_thread  # noqa: E402,F401

TINY_SET = ["--set=model.dim=12", "--set=model.n_heads=2", "--set=model.l_len=4",
            "--set=model.v_len=6", "--set=model.a_len=8", "--set=model.l_dim=5",
            "--set=model.v_dim=4", "--set=model.a_dim=3",
            "--set=train.batch_size=4", "--set=train.n_folds=2"]
TRAIN = ["--device", "cpu", "--epochs", "2", "--n-train", "32", "--n-test",
         "8", "--quiet"]


@pytest.mark.parametrize("name", sorted(configs.REGISTRY))
def test_summary_totals_and_flops_equal_jax(name, capsys):
    assert sorted(configs.REGISTRY) == sorted(jconfigs.REGISTRY)
    out = cli.main(["summary", name, "--device", "cpu"])
    jexp = jconfigs.get(name)
    shapes = jax.eval_shape(jbuild(jexp).init, jax.random.PRNGKey(0))
    assert out["total"] == jcount(shapes)["Total"]
    assert out["flops_per_sample"] == {
        "forward": jflops.forward_flops_per_sample(jexp.model),
        "train_step": jflops.train_flops_per_sample(jexp.model)}
    assert sum(out["parameters"].values()) == out["total"]
    assert json.loads(capsys.readouterr().out)["total"] == out["total"]


def test_parameter_breakdown_groups_by_dotted_depth():
    exp = configs.with_overrides(configs.get("mosei_trans"), cli.parse_overrides(
        [s.removeprefix("--set=") for s in TINY_SET]))
    from multimodal_emotion_processing_tpu_torch.models import build_model

    model = build_model(exp, device="cpu")
    total = parameter_count(model)
    assert total["Total"] == total["Trainable"] == sum(
        p.numel() for p in model.parameters())
    top = parameter_breakdown(model, depth=1)
    assert sorted(top) == ["intensity", "norm1", "out", "stimulation", "trans"]
    assert sum(top.values()) == total["Total"]
    deep = parameter_breakdown(model, depth=2)
    assert deep["intensity.unify_dimension"] == sum(
        p.numel() for p in model.intensity.unify_dimension.parameters())


def _args(argv):
    args = cli.build_parser().parse_args(argv)
    cli.apply_config_file(args)
    return args


def test_json_config_file_and_explicit_set(tmp_path):
    path = tmp_path / "exp.json"
    doc = {"config": "ren_mme", "model": {"dim": 32, "v_dims_multires": [1, 2, 3]},
           "train": {"batch_size": 8}}
    path.write_text(json.dumps(doc))
    args = _args(["train", str(path), "--set", "train.batch_size=4"])
    assert args.config == "ren_mme"
    exp = configs.with_overrides(configs.get("ren_mme"),
                                 cli.parse_overrides(args.set))
    assert exp.model.dim == 32 and exp.model.v_dims_multires == (1, 2, 3)
    assert exp.train.batch_size == 4          # the explicit --set wins
    assert configs.load_config_file(str(path)) == \
        jconfigs.load_config_file(str(path))
    for bad, match in (({"model": {"dim": 8}}, "names no base config"),
                       ({"config": "ren_mme", "optim": {}}, "unknown top-level")):
        path.write_text(json.dumps(bad))
        with pytest.raises(SystemExit, match=match):
            _args(["train", str(path)])
    path.write_text(json.dumps(doc))
    with pytest.raises(SystemExit, match="takes no config overrides"):
        _args(["check-data", str(path), "--data-root", "x"])
    with pytest.raises(SystemExit, match="does not exist"):
        _args(["train", str(tmp_path / "missing.json")])


def test_run_meta_json_reproduces_the_run(tmp_path):
    ck = tmp_path / "ck"
    cli.main(["train", "rencecps", *TRAIN, "--set=model.dim=16",
              "--set=model.l_dim=16", "--set=train.batch_size=4",
              "--set=train.n_folds=2", "--set=train.lr=0.003",
              "--checkpoint-dir", str(ck)])
    meta = ck / "run_meta.json"
    args = _args(["eval", str(meta), "--device", "cpu"])
    assert args.config == "rencecps"
    exp = configs.with_overrides(configs.get("rencecps"),
                                 cli.parse_overrides(args.set))
    recorded = json.loads(meta.read_text())["resolved_config"]
    assert exp.model.dim == 16 and exp.train.lr == 0.003
    assert json.loads(json.dumps(dataclasses.asdict(exp))) == recorded
    assert configs.load_config_file(str(meta)) == \
        jconfigs.load_config_file(str(meta))
    # the recorded run evaluates from its own file
    assert cli.main(["eval", str(meta), "--device", "cpu", "--n-test", "8",
                     "--quiet", "--checkpoint-dir", str(ck)]).report


def _tuned_file(tmp_path, config="rencecps", winners=None):
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({
        "config": config,
        "winners": winners or {"scan_steps": 32, "impl": "pallas",
                               "transfer_dtype": "int8", "stacked": True}}))
    return str(path)


def test_apply_tuned_fills_defaults_only(tmp_path):
    path = _tuned_file(tmp_path)
    args = cli.build_parser().parse_args(["train", "rencecps", "--tuned", path])
    applied = autotune.apply_tuned(args, path)
    assert applied == {"scan_steps": 32, "impl": "pallas",
                       "transfer_dtype": "int8"}
    assert args.scan_steps == 32 and args.impl == "pallas"
    assert args.transfer_dtype == "int8"
    # explicit flags win over the file
    args = cli.build_parser().parse_args(
        ["train", "rencecps", "--tuned", path, "--scan-steps", "8", "--impl",
         "flash"])
    applied = autotune.apply_tuned(args, path)
    assert args.scan_steps == 8 and args.impl == "flash"
    assert "scan_steps" not in applied and "impl" not in applied


def test_apply_tuned_per_command(tmp_path):
    path = _tuned_file(tmp_path, config="robot_demo",
                       winners={"stacked": True, "scan_steps": 16,
                                "impl": "pallas", "transfer_dtype": "float16"})
    args = cli.build_parser().parse_args(["serve", "--tuned", path])
    assert autotune.apply_tuned(args, path) == {"impl": "pallas"}
    args = cli.build_parser().parse_args(
        ["predict", "robot_demo", "-o", "x.npz", "--tuned", path])
    assert autotune.apply_tuned(args, path) == {"impl": "pallas",
                                                "transfer_dtype": "float16"}


def test_apply_tuned_config_mismatch(tmp_path):
    path = _tuned_file(tmp_path, config="mosei_trans")
    args = cli.build_parser().parse_args(["train", "rencecps", "--tuned", path])
    with pytest.raises(SystemExit, match="tuned for config"):
        autotune.apply_tuned(args, path)


def test_apply_tuned_losing_winners_are_noops_but_xla_pins(tmp_path):
    path = _tuned_file(tmp_path, winners={
        "scan_steps": 1, "impl": "xla", "transfer_dtype": None,
        "stacked": False})
    args = cli.build_parser().parse_args(["train", "rencecps", "--tuned", path])
    # configs carry a preferred attn_impl (the presets default to flash):
    # a measured xla winner pins it
    assert autotune.apply_tuned(args, path) == {"impl": "xla"}
    assert args.scan_steps == 1 and args.transfer_dtype is None


@pytest.mark.parametrize("winner", [True, False])
def test_apply_tuned_remat_rides_set(tmp_path, winner):
    path = _tuned_file(tmp_path, winners={"remat": winner})
    args = cli.build_parser().parse_args(["train", "rencecps", "--tuned", path])
    assert autotune.apply_tuned(args, path) == {"remat": winner}
    assert f"model.remat={str(winner).lower()}" in args.set
    args = cli.build_parser().parse_args(
        ["train", "rencecps", "--tuned", path, "--set", "model.remat=false"])
    assert autotune.apply_tuned(args, path) == {}
    assert args.set == ["model.remat=false"]


@pytest.fixture
def tiny_robot(monkeypatch):
    """robot_demo at a tiny width in the port's registry (tune takes a
    registered name)."""
    base = configs.REGISTRY["robot_demo"]

    def tiny():
        exp = base()
        return dataclasses.replace(
            exp, model=dataclasses.replace(
                exp.model, l_len=5, v_len=6, a_len=7, dim=18, n_heads=3,
                l_dim=16, a_dim=10, v_dims_multires=(4, 8, 12), n_layers=1,
                ffn=1),
            train=dataclasses.replace(exp.train, batch_size=4))

    monkeypatch.setitem(configs.REGISTRY, "robot_demo", tiny)


def test_tune_record_structure(tiny_robot):
    rec = autotune.tune("robot_demo", steps=2, reps=1, scan_ks=(2,),
                        device="cpu")
    assert rec["config"] == "robot_demo" and rec["platform"] == "cpu"
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["torch"] == torch.__version__ and rec["margin"] == autotune.MARGIN
    m, w = rec["measured"], rec["winners"]
    assert "datafed_train_sps" not in m and "transfer_dtype" not in w  # lossy
    assert m["stacked_infer_sps"] == {"skipped": "stacked grid not ported"}
    assert "stacked" not in w
    assert set(m["scan_train_sps"]) == {"1", "2"} and w["scan_steps"] in (1, 2)
    if w["scan_steps"] == 2:
        assert m["scan_train_sps"]["2"] >= autotune.MARGIN * m["scan_train_sps"]["1"]
    assert m["remat_train_sps"]["on"] > 0 and m["remat_train_sps"]["off"] > 0
    assert isinstance(w["remat"], bool)
    for impl in ("xla", "flash", "pallas"):
        assert m[impl]["train_sps"] > 0 and m[impl]["infer_sps"] > 0
    assert w["impl"] in ("xla", "flash", "pallas")
    if w["impl"] != "xla":
        assert m[w["impl"]]["train_sps"] >= autotune.MARGIN * m["xla"]["train_sps"]


def test_tune_lossy_arm_and_minus_family(tiny_robot, tmp_path, capsys):
    out = tmp_path / "tuned.json"
    rec = cli.main(["tune", "robot_demo", "--device", "cpu", "--arms",
                    "transfer,stacked", "--allow-lossy", "--steps", "2",
                    "--reps", "1", "-o", str(out)])
    assert set(rec["measured"]["datafed_train_sps"]) == {"float32", "int8",
                                                         "float16"}
    assert rec["winners"]["transfer_dtype"] in (None, "int8", "float16")
    assert json.loads(out.read_text()) == rec
    # the stacked arm does not apply to a minus family at all (JAX's rule)
    rec = autotune.tune("rencecps", arms=["stacked"], steps=2, reps=1,
                        device="cpu")
    assert rec["measured"] == {} and rec["winners"] == {}


def test_doctor_cpu_keys(capsys):
    out = cli.main(["doctor", "--device", "cpu", "--scan-k", "2", "--json-only"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert set(out) == {
        "platform", "device", "device_count", "nvidia_smi", "torch", "cuda",
        "launch_floor_ms", "graph_replay_floor_ms", "h2d_pageable_gb_s",
        "h2d_pinned_gb_s", "matmul_f32_tflop_s", "matmul_f32_peak_share",
        "matmul_tf32_tflop_s", "matmul_tf32_peak_share", "matmul_bf16_tflop_s",
        "matmul_bf16_peak_share", "sync_ms", "sync_fetch_ms",
        "sync_early_ratio", "sync_honest"}
    assert out["platform"] == "cpu" and out["launch_floor_ms"] > 0
    # no card: the card's probes read null, never a host number
    for k in ("graph_replay_floor_ms", "h2d_pageable_gb_s", "h2d_pinned_gb_s",
              "matmul_f32_peak_share", "matmul_bf16_peak_share",
              "matmul_tf32_tflop_s"):
        assert out[k] is None


@pytest.mark.parametrize("driver, flags, prefix, n", [
    ("sequential", [], "trainer", 2),
    ("device-resident", ["--device-resident"], "lockstep", 1),
    ("one-dispatch", ["--one-dispatch"], "one_dispatch", 1),
])
def test_profile_dir_writes_traces(tmp_path, driver, flags, prefix, n):
    prof = tmp_path / "prof"
    cli.main(["train", "rencecps", *TRAIN, "--set=model.dim=16",
              "--set=model.l_dim=16", "--set=train.batch_size=4",
              "--set=train.n_folds=2", "--profile-dir", str(prof), *flags])
    traces = sorted(os.listdir(prof))
    assert len(traces) == n and all(
        t.startswith(prefix) and t.endswith(".pt.trace.json") for t in traces)
    for t in traces:
        doc = json.loads((prof / t).read_text())
        assert any(e.get("ph") == "X" for e in doc["traceEvents"])


def test_debug_nans_names_the_module(tmp_path, monkeypatch):
    synthetic = pipelines._synthetic_data

    def poisoned(exp, n_train, n_test, seed=0):
        train, test = synthetic(exp, n_train, n_test, seed)
        train[0]["l"][1, 2, 3] = np.nan
        return train, test

    monkeypatch.setattr(pipelines, "_synthetic_data", poisoned)
    with pytest.raises(FloatingPointError,
                       match=r"module ConcatTrans\.stimulation\."
                             r"unify_dimension\.linguistic \(Linear\)"):
        cli.main(["train", "mosei_trans", *TRAIN, *TINY_SET, "--impl",
                  "pallas_fused", "--debug-nans"])
    assert not nan_debugging_enabled() and not torch.is_anomaly_enabled()
    # without the flag the same run trains on (the loss goes NaN)
    res = cli.main(["train", "mosei_trans", *TRAIN, *TINY_SET])
    assert np.isnan(res.fold_histories[0][0].train_loss) or np.isnan(
        res.fold_histories[1][0].valid_loss)


def test_debug_nans_names_the_backward_function():
    enable_nan_debugging(True)
    try:
        x = torch.zeros(3, requires_grad=True)
        y = (torch.sqrt(x) * 0.0).sum()     # finite forward, 0 * inf backward
        with pytest.raises(RuntimeError, match="SqrtBackward0"):
            y.backward()
    finally:
        enable_nan_debugging(False)
    assert not nan_debugging_enabled() and not torch.is_anomaly_enabled()
