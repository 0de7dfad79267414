"""PyTorch port, ensemble evaluation: the numpy modules (`train.metrics`,
the helpers of `eval.ensemble`, `eval.report`, `eval.predictions`) exactly
equal to the JAX package's on the same seeded inputs, and `Ensemble` (mean,
sum and 0.6/0.4 weights, bf16, paragraph logits, padding rows dropped)
against JAX's `Ensemble` on the same members (carried over by
`from_jax_params`) and batches: 2e-4 in f32 (tests/test_interop.py:20),
5e-2 in bf16 (tests/test_flash.py:90)."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.data.loader import Batcher as JBatcher  # noqa: E402
from multimodal_emotion_processing_tpu.eval import ensemble as jens  # noqa: E402
from multimodal_emotion_processing_tpu.eval import predictions as jpred  # noqa: E402
from multimodal_emotion_processing_tpu.eval import report as jreport  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.train import metrics as jmetrics  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval import ensemble as ens  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval import predictions, report  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import metrics  # noqa: E402

F32_TOL = 2e-4
BF16_TOL = 5e-2
TINY = dict(l_len=4, v_len=6, a_len=8, dim=12, n_heads=2, l_dim=5, v_dim=4,
            a_dim=3, p_len=3)


def _labels_logits(n=64, e=8, seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, e + 1)) > 0.6).astype(np.int32)
    # logits correlated with the labels, on a 0.05 lattice so that the
    # sweeps and grids meet ties
    logits = np.round((rng.standard_normal((n, e + 1)) + 1.5 * labels - 2.0)
                      * 20) / 20
    return logits.astype(np.float32), labels


def _same(a, b):
    """Structurally equal, floats exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b and type(a) is type(b), (a, b)


def test_metrics_equal_jax():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, 200)
    p = rng.integers(0, 2, 200)
    assert metrics.binary_counts(y, p) == jmetrics.binary_counts(y, p)
    _same(metrics.accuracy(y, p), jmetrics.accuracy(y, p))
    _same(metrics.weighted_f1(y, p), jmetrics.weighted_f1(y, p))
    _same(metrics.weighted_f1(np.ones(5), np.zeros(5)),
          jmetrics.weighted_f1(np.ones(5), np.zeros(5)))
    Y = rng.integers(0, 2, (100, 8))
    P = rng.integers(0, 2, (100, 8))
    P[:, 3] = 0                                   # a label never predicted
    _same(metrics.micro_macro_prf(Y, P), jmetrics.micro_macro_prf(Y, P))
    names = [f"e{j}" for j in range(8)]
    _same(metrics.per_emotion_report(Y, P, names),
          jmetrics.per_emotion_report(Y, P, names))


def test_threshold_helpers_equal_jax():
    logits, labels = _labels_logits()
    idx, names = list(range(8)), [f"e{j}" for j in range(8)]
    th = np.linspace(-1.0, 0.4, 8)
    _same(ens.apply_thresholds(logits, th, idx),
          jens.apply_thresholds(logits, th, idx))
    _same(ens.realformer_threshold_grid(), jens.realformer_threshold_grid())
    _same(ens.robot_threshold_grid(), jens.robot_threshold_grid())
    _same(ens.ren_mme_joint_grids(), jens.ren_mme_joint_grids())
    for grid in (ens.realformer_threshold_grid(), ens.robot_threshold_grid()):
        _same(ens.threshold_sweep(logits, labels, grid, idx, names),
              jens.threshold_sweep(logits, labels, grid, idx, names))
    _same(ens.threshold_sweep(logits, labels, [0.0, -0.5], idx, names,
                              metric=metrics.accuracy),
          jens.threshold_sweep(logits, labels, [0.0, -0.5], idx, names,
                               metric=jmetrics.accuracy))


def test_joint_threshold_grid_equal_jax_on_a_full_grid():
    """A non-degenerate grid: 5 values for each of 8 emotions (390,625
    combinations), the first maximiser in C order; and the grid-size
    guard."""
    logits, labels = _labels_logits(n=96, seed=2)
    idx, names = list(range(8)), [f"e{j}" for j in range(8)]
    grids = [[-2.5, -2.0, -1.5, -1.0, -0.5]] * 8
    got = ens.joint_threshold_grid(logits, labels, grids, idx, names)
    _same(got, jens.joint_threshold_grid(logits, labels, grids, idx, names))
    # brute force over a 3-emotion sub-grid agrees with the count tables
    sub = ens.joint_threshold_grid(logits, labels, grids[:3], idx[:3], names[:3])
    best, arg = -1.0, None
    for a in grids[0]:
        for b in grids[1]:
            for c in grids[2]:
                pred = ens.apply_thresholds(logits, [a, b, c], idx[:3])
                r = metrics.micro_macro_prf(labels[:, :3], pred)
                obj = r["micro_f1"] + r["macro_f1"]
                if obj > best + 1e-12:
                    best, arg = obj, (a, b, c)
    assert tuple(sub["thresholds"].values()) == arg
    assert sub["objective"] == pytest.approx(best, abs=1e-12)
    with pytest.raises(ValueError, match="too large"):
        ens.joint_threshold_grid(logits, labels, [list(range(9))] * 8, idx,
                                 names)


def test_group_average_equal_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((10, 4)).astype(np.float32)
    labels = rng.integers(0, 2, (10, 4))
    gids = [3, 3, 1, 0, 0, 7, 1, 2, 2, 5]
    _same(ens.group_average(logits, gids), jens.group_average(logits, gids))
    _same(ens.group_average(logits, gids, labels),
          jens.group_average(logits, gids, labels))


def test_report_equal_jax(tmp_path):
    logits, labels = _labels_logits(seed=4)
    exp = configs.get("ren_mme")
    args = (logits, labels, exp.thresholds, exp.emotion_index,
            exp.emotion_names)
    rep = report.evaluate(*args)
    _same(rep, jreport.evaluate(*args))
    assert report.format_report(rep, title="t") == jreport.format_report(
        rep, title="t")
    report.save_report(rep, str(tmp_path / "a.json"))
    jreport.save_report(rep, str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


def test_transition_matrix_equal_jax():
    """Ensemble-averaged tanh(trans) from port members (or their state
    dicts) equals JAX's from the same parameters."""
    exp = configs.get("rencecps")
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, dim=16))
    jmodel = jbuild(dataclasses.replace(
        jconfigs.get("rencecps"),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model))))
    jps = [jax.device_get(jmodel.init(jax.random.PRNGKey(i))) for i in range(3)]
    members = []
    for p in jps:
        m = build_model(exp, device="cpu")
        m.load_state_dict(from_jax_params(p, exp.model))
        members.append(m)
    want = jreport.transition_matrix(jps)
    _same(report.transition_matrix(members), want)
    _same(report.transition_matrix([m.state_dict() for m in members]), want)
    assert want.shape == (9, 9, 9)


def test_plot_transition_matrix(tmp_path):
    pytest.importorskip("matplotlib")
    mat = np.tanh(np.random.default_rng(0).standard_normal((9, 9)))
    report.plot_transition_matrix(mat, "t", str(tmp_path / "m.png"))
    assert (tmp_path / "m.png").stat().st_size > 0


def test_predictions_equal_jax(tmp_path):
    """The prediction table, its three file formats (the same bytes as
    JAX's for .csv and .jsonl, the same arrays in .npz) and the calibration
    report."""
    logits, labels = _labels_logits(n=20, seed=5)
    exp = configs.get("ren_mme")
    args = (logits, exp.thresholds, exp.emotion_index, exp.emotion_names)
    for lab in (labels, None):
        table = predictions.prediction_table(*args, labels=lab)
        jtable = jpred.prediction_table(*args, labels=lab)
        _same(table, jtable)
        for ext in ("csv", "jsonl", "npz"):
            a, b = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
            predictions.write_predictions(str(a), table)
            jpred.write_predictions(str(b), jtable)
            if ext == "npz":
                za, zb = np.load(a), np.load(b)
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k])
            else:
                assert a.read_bytes() == b.read_bytes()
    _same(predictions.calibration_report(
              predictions.prediction_table(*args, labels=labels), n_bins=5),
          jpred.calibration_report(jpred.prediction_table(*args, labels=labels),
                                   n_bins=5))
    with pytest.raises(ValueError, match="labels"):
        predictions.calibration_report(predictions.prediction_table(*args))
    with pytest.raises(ValueError, match="format"):
        predictions.write_predictions(str(tmp_path / "x.txt"), table)
    with pytest.raises(ValueError, match="thresholds"):
        predictions.prediction_table(logits, exp.thresholds[:3],
                                     exp.emotion_index, exp.emotion_names)


def _members(name, k, **model):
    exp = configs.get(name)
    exp = dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, **{**TINY, **model}))
    jexp = dataclasses.replace(
        jconfigs.get(name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)))
    jmodel = jbuild(jexp)
    rng = np.random.default_rng(7)

    def perturb(path, x):
        # gates a, b, c away from their initial 0, so the attention
        # reaches the logits
        key = str(getattr(path[-1], "key", path[-1]))
        if key in ("a", "b", "c"):
            return rng.uniform(0.25, 1.0, np.shape(x)).astype(np.float32)
        return x

    jps = [jax.tree_util.tree_map_with_path(
        perturb, jax.device_get(jmodel.init(jax.random.PRNGKey(i))))
        for i in range(k)]
    members = []
    for p in jps:
        m = build_model(exp, device="cpu")
        m.load_state_dict(from_jax_params(p, exp.model))
        members.append(m)
    return exp, jmodel, jps, members


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("name,combine,weights,impl", [
    ("mosei_trans", "mean", None, "pallas_fused"),
    ("ren_mme", "sum", None, "pallas_fused"),
    ("mosei_realformer", "mean", (0.6, 0.4), "pallas"),
])
def test_ensemble_matches_jax(name, combine, weights, impl):
    """Ensemble.logits and predict_all (7 samples in batches of 4: the
    padded row dropped) against JAX's Ensemble at xla; the paragraph
    model's logits are (B, P, E)."""
    k = 2 if weights else 3
    exp, jmodel, jps, members = _members(name, k)
    samples = synthetic_dataset(name, exp.model, 7, seed=3)
    got = ens.Ensemble(members, weights=weights, combine=combine, impl=impl)
    want = jens.Ensemble(jmodel, jps, weights=weights, combine=combine)
    out = got.predict_all(Batcher(samples, 4, shuffle=False))
    ref = want.predict_all(JBatcher(samples, 4, shuffle=False))
    assert out.shape == ref.shape and out.shape[0] == 7
    assert out.ndim == (3 if name == "mosei_realformer" else 2)
    _close(out, ref, F32_TOL)
    batch = next(iter(Batcher(samples, 4, shuffle=False)()))
    lg = got.logits(batch)
    assert lg.dtype == torch.float32
    _close(lg.numpy(), np.asarray(want.logits(batch)), F32_TOL)
    # the members' own forwards, combined by hand
    tb = {k2: torch.from_numpy(v) for k2, v in batch.items()}
    w = weights or ([1.0 / k] * k if combine == "mean" else [1.0] * k)
    with torch.no_grad():
        manual = sum(wi * m(tb, impl="xla") for wi, m in zip(w, members))
    _close(lg.numpy(), manual.numpy(), 1e-6)


def test_ensemble_bf16_matches_jax_and_keeps_members_f32():
    exp, jmodel, jps, members = _members("mosei_trans", 2)
    samples = synthetic_dataset("mosei_trans", exp.model, 4, seed=5)
    batch = next(iter(Batcher(samples, 4, shuffle=False)()))
    got = ens.Ensemble(members, dtype="bfloat16", impl="pallas_fused")
    ref = jens.Ensemble(jmodel, jps, dtype="bfloat16")
    lg = got.logits(batch)
    assert lg.dtype == torch.float32
    assert all(p.dtype == torch.float32 for m in members
               for p in m.parameters())
    _close(lg.numpy(), np.asarray(ref.logits(batch)), BF16_TOL)
    f32 = ens.Ensemble(members).logits(batch)
    _close(lg.numpy(), f32.numpy(), BF16_TOL)


def test_ensemble_rejects_bad_arguments():
    _, _, _, members = _members("mosei_trans", 2)
    with pytest.raises(ValueError, match="at least one"):
        ens.Ensemble([])
    with pytest.raises(ValueError, match="weights"):
        ens.Ensemble(members, weights=[1.0])
    with pytest.raises(ValueError, match="combine"):
        ens.Ensemble(members, combine="max")


def test_report_json_roundtrip(tmp_path):
    rep = {"per_emotion": {"happ": {"acc": 0.9, "f1": 0.8}},
           "micro_f1": 0.7, "macro_f1": 0.6}
    text = report.format_report(rep, title="t")
    assert "happ_acc: 0.900000" in text and "micro_f1: 0.700000" in text
    report.save_report(rep, str(tmp_path / "r.json"))
    assert json.load(open(tmp_path / "r.json")) == rep
