"""PyTorch port, the whole experiment: `pipelines.run_experiment` against
the JAX package's `run_experiment(vmap_folds=False)` (its sequential k-fold
driver) for `mosei_trans` (mean of the members, fixed thresholds),
`ren_mme` (R-Drop at dropout 0, summed members, the joint threshold grid)
and `mosei_realformer` (its two best members at 0.6/0.4, the 400-point
sweep, paragraph clips flattened), at tiny widths on the CPU: per-member
epoch losses and the ensemble's logits within 2e-4
(tests/test_interop.py:20), the same best epochs, thresholds and report.
Both sides start every member from the same weights: JAX's
`init_state(seed)` with the LayerNorm biases spread apart (at init they tie
across blocks and the max pool's routing would rest on the last ulp,
tests/test_torch_train.py::_spread_ln_biases) and the RealFormer gates
non-zero, carried into the port by `from_jax_params`.  Then `run_predict`
and the CLI on the CPU: `train --checkpoint-dir`, `eval`, `predict -o`
(.npz/.csv/.jsonl), `checkpoints`, `configs` and `serve --checkpoint-dir`,
which serves the trained members."""

import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import pipelines as jpipelines  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs, pipelines  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402

F32_TOL = 2e-4
TINY = dict(l_len=4, v_len=6, a_len=8, dim=12, n_heads=2, l_dim=5, v_dim=4,
            a_dim=3)
CASES = {
    # name: (model overrides, train overrides, n_train, n_test, port impl,
    #        sweep_thresholds)
    "mosei_trans": (TINY, dict(n_folds=2, batch_size=8), 24, 8,
                    "pallas_fused", False),
    "ren_mme": ({**TINY, "dim": 16, "dropout": 0.0},
                dict(n_folds=2, batch_size=4), 16, 8, "pallas_fused", True),
    "mosei_realformer": ({**TINY, "p_len": 3}, dict(n_folds=3, batch_size=4),
                         12, 6, "pallas", True),
    "robot_demo": ({**TINY, "a_dim": 5, "v_dims_multires": (3, 4, 5),
                    "dropout": 0.0}, dict(n_folds=2, batch_size=4), 16, 8,
                   "pallas", True),
    "rencecps": ({"dim": 12, "l_dim": 12, "dropout": 0.0},
                 dict(n_folds=2, batch_size=4), 16, 8, "xla", True),
}
EPOCHS = 2


def _start_weights(params, seed):
    """LayerNorm biases moved by 0.1·N(0, 1) and every gate a, b, c drawn
    from U(0.25, 1.0), from a generator seeded by the member's seed."""
    rng = np.random.default_rng(1000 + seed)

    def move(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        x = np.asarray(x)
        if names[-1] in ("a", "b", "c"):
            return rng.uniform(0.25, 1.0, x.shape).astype(np.float32)
        if names[-1] == "bias" and any("norm" in n for n in names):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, jax.device_get(params))


def _same_start(monkeypatch):
    """Patch both frameworks' init_state: JAX's member of seed s starts from
    `_start_weights`, and the port's member of seed s loads those weights."""
    by_seed = {}
    jinit = jeng.init_state

    def jax_init(model, tx, seed, **kw):
        st = jinit(model, tx, seed, **kw)
        by_seed[seed] = _start_weights(st.params, seed)
        return dataclasses.replace(st, params=jax.tree_util.tree_map(
            jax.numpy.asarray, by_seed[seed]))

    init = engine.init_state

    def port_init(cfg, tcfg, seed, **kw):
        st = init(cfg, tcfg, seed, **kw)
        st.model.load_state_dict(from_jax_params(by_seed[seed],
                                                 getattr(cfg, "model", cfg)))
        return st

    monkeypatch.setattr(jeng, "init_state", jax_init)
    monkeypatch.setattr(engine, "init_state", port_init)


def _run_both(name, tmp_path, monkeypatch):
    model, train, n_train, n_test, impl, sweep = CASES[name]
    overrides = {"model": model, "train": train}
    _same_start(monkeypatch)
    captured = {}
    collapse = jpipelines._collapse_test_outputs

    def capture(logits, samples):
        captured["logits"], captured["labels"] = collapse(logits, samples)
        return captured["logits"], captured["labels"]

    monkeypatch.setattr(jpipelines, "_collapse_test_outputs", capture)
    common = dict(n_train=n_train, n_test=n_test, epochs=EPOCHS, quiet=True,
                  sweep_thresholds=sweep, overrides=overrides)
    jres = jpipelines.run_experiment(
        name, vmap_folds=False, impl="xla",
        checkpoint_dir=str(tmp_path / "jax"), **common)
    res = pipelines.run_experiment(
        name, impl=impl, checkpoint_dir=str(tmp_path / "port"),
        device="cpu", **common)
    return res, jres, captured


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


@pytest.mark.parametrize("name", list(CASES))
def test_run_experiment_matches_jax(name, tmp_path, monkeypatch):
    res, jres, jout = _run_both(name, tmp_path, monkeypatch)
    k = CASES[name][1]["n_folds"]
    assert len(res.fold_histories) == len(jres.fold_histories) == k
    for i, (hist, jhist) in enumerate(zip(res.fold_histories,
                                          jres.fold_histories)):
        assert len(hist) == len(jhist) == EPOCHS
        for h, jh in zip(hist, jhist):
            assert h.steps == jh.steps and h.samples == jh.samples
            assert _rel(h.train_loss, jh.train_loss) <= F32_TOL, (i, h, jh)
            assert _rel(h.valid_loss, jh.valid_loss) <= F32_TOL, (i, h, jh)
    names = [f"{name}_{i + 1}" for i in range(k)]
    assert res.store.best_members(name) == names
    for n in names:
        got, want = res.store.manifest[n], jres.store.manifest[n]
        assert got["epoch"] == want["epoch"]
        assert _rel(got["valid_loss"], want["valid_loss"]) <= F32_TOL
        assert got["done"] and want["done"]
    assert res.logits.shape == jout["logits"].shape
    scale = max(1.0, float(np.abs(jout["logits"]).max()))
    np.testing.assert_allclose(res.logits / scale, jout["logits"] / scale,
                               rtol=0, atol=F32_TOL)
    np.testing.assert_array_equal(res.labels, jout["labels"])
    assert res.sweep == jres.sweep
    assert res.report == jres.report
    if name == "mosei_realformer":
        # flattened clips of the 6 paragraphs up to each first invalid clip
        assert res.logits.ndim == 2 and res.logits.shape[0] <= 6 * 3
    if CASES[name][5]:
        tuned = json.load(open(tmp_path / "port" / "thresholds.json"))
        assert tuned == json.load(open(tmp_path / "jax" / "thresholds.json"))


def test_run_predict_and_eval_from_the_store(tmp_path):
    """run_predict over the store's members gives the experiment's own eval
    logits; an eval-only run (epochs 0) gives them again and changes no
    member; a store without members and a missing store raise."""
    model, train, n_train, n_test, impl, _ = CASES["mosei_trans"]
    ov = {"model": model, "train": train}
    ck = str(tmp_path / "ck")
    res = pipelines.run_experiment("mosei_trans", n_train=n_train,
                                   n_test=n_test, epochs=1, quiet=True,
                                   overrides=ov, checkpoint_dir=ck,
                                   impl=impl, device="cpu")
    table = pipelines.run_predict("mosei_trans", checkpoint_dir=ck,
                                  n_test=n_test, overrides=ov, impl=impl,
                                  quiet=True, device="cpu")
    np.testing.assert_array_equal(table["logits"], res.logits)
    assert table["members"] == 2 and table["rows"] == n_test
    before = json.load(open(tmp_path / "ck" / "manifest.json"))
    again = pipelines.run_experiment("mosei_trans", n_train=n_train,
                                     n_test=n_test, epochs=0, quiet=True,
                                     overrides=ov, checkpoint_dir=ck,
                                     impl=impl, device="cpu")
    np.testing.assert_array_equal(again.logits, res.logits)
    assert again.report == res.report
    assert json.load(open(tmp_path / "ck" / "manifest.json")) == before
    both = pipelines.run_predict("mosei_trans", checkpoint_dir=ck,
                                 n_test=n_test, n_train=5, split="all",
                                 overrides=ov, quiet=True, device="cpu")
    assert both["rows"] == n_test + 5
    rnd = pipelines.run_predict("mosei_trans", init_random=True, n_test=3,
                                overrides=ov, quiet=True, device="cpu")
    assert rnd["members"] == 1 and rnd["rows"] == 3
    with pytest.raises(ValueError, match="no trained members"):
        pipelines.run_predict("ren_mme", checkpoint_dir=ck, quiet=True,
                              device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir required"):
        pipelines.run_predict("mosei_trans", quiet=True, device="cpu")
    with pytest.raises(ValueError, match="resume"):
        pipelines.run_experiment("mosei_trans", resume=True, device="cpu")


def test_run_experiment_without_a_store_ensembles_the_final_members():
    model, train, n_train, n_test, impl, _ = CASES["mosei_trans"]
    res = pipelines.run_experiment(
        "mosei_trans", n_train=n_train, n_test=n_test, epochs=1, quiet=True,
        overrides={"model": model, "train": train}, impl=impl, device="cpu")
    assert res.store is None and res.sweep is None
    assert res.logits.shape == (n_test, 7)
    assert set(res.report["per_emotion"]) == set(
        configs.get("mosei_trans").emotion_names)


TINY_SET = ([f"--set=model.{k}={json.dumps(v)}" for k, v in TINY.items()]
            + ["--set=train.n_folds=2", "--set=train.batch_size=4"])


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def test_cli_train_eval_predict_checkpoints_serve(tmp_path, capsys,
                                                  monkeypatch):
    """`train --checkpoint-dir` then `serve --checkpoint-dir` serves the
    trained members: each served request's logits are those of an
    Ensemble of the store's members on that sample."""
    # the CSV log alone: TensorBoard's import is not what is under test
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    ck, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    base = ["--device", "cpu", *TINY_SET]
    res = main(["train", "mosei_trans", "--epochs", "2", "--n-train", "16",
                "--n-test", "6", "--checkpoint-dir", ck, "--log-dir", logs,
                "--impl", "pallas_fused", "--quiet", *base])
    lines = _json_lines(capsys.readouterr().out)
    epochs = [x for x in lines if "epoch" in x]
    assert [(x["member"], x["epoch"]) for x in epochs] == [
        ("mosei_trans_1", 0), ("mosei_trans_1", 1),
        ("mosei_trans_2", 0), ("mosei_trans_2", 1)]
    assert all(x["steps"] == 2 and x["samples"] == 8 for x in epochs)
    assert lines[-1] == {"report": res.report}
    for d in (ck, logs):
        meta = json.load(open(f"{d}/run_meta.json"))
        assert meta["resolved_config"]["train"]["n_folds"] == 2
        assert meta["env"]["device"] == "cpu"
    assert open(f"{logs}/mosei_trans_2.csv").read().count("\n") == 3

    main(["eval", "mosei_trans", "--n-test", "6", "--checkpoint-dir", ck,
          "--quiet", *base])
    assert _json_lines(capsys.readouterr().out) == [{"report": res.report}]
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        main(["eval", "mosei_trans", *base])

    for ext in ("npz", "csv", "jsonl"):
        out = str(tmp_path / f"p.{ext}")
        table = main(["predict", "mosei_trans", "-o", out, "--n-test", "6",
                      "--checkpoint-dir", ck, "--calibration", "--quiet",
                      *base])
        summary = json.loads(capsys.readouterr().out)
        assert summary["rows"] == 6 and summary["members"] == 2
        assert "mean_ece" in summary["calibration"]
        np.testing.assert_array_equal(table["logits"], res.logits)
    assert np.load(tmp_path / "p.npz")["pred"].shape == (6, 6)
    assert open(tmp_path / "p.csv").read().count("\n") == 7
    assert len(open(tmp_path / "p.jsonl").read().splitlines()) == 6
    with pytest.raises(SystemExit, match="init-random"):
        main(["predict", "mosei_trans", "-o", out, *base])

    listing = main(["checkpoints", ck, "--prefix", "mosei_trans"])
    capsys.readouterr()
    assert sorted(listing["members"]) == ["mosei_trans_1", "mosei_trans_2"]
    m1 = listing["members"]["mosei_trans_1"]
    assert m1["done"] and m1["resume_epoch"] == 1 and m1["bytes"] > 0
    assert m1["kinds"] == ["params", "full", "resume"]
    main(["configs"])
    assert "mosei_trans_s1024: dim=1024" in capsys.readouterr().out

    # serve the store's members: batch-1 and a burst of 3
    exp = configs.with_overrides(configs.get("mosei_trans"), {
        "model": TINY, "train": {"n_folds": 2, "batch_size": 4}})
    store = CheckpointStore(ck)
    members = [store.restore_params(n, build_model(exp, device="cpu"))
               for n in store.best_members("mosei_trans")]
    ens = Ensemble(members)
    samples = synthetic_dataset("mosei_trans", exp.model, 3, seed=7)
    want = ens.logits({k: v[None] for k, v in samples[0].items()}).numpy()[0]
    emotions = main(["serve", "mosei_trans", "--checkpoint-dir", ck, *base])
    err = capsys.readouterr().err
    assert "2 trained members" in err and "seeded random" not in err
    probs = 1 / (1 + np.exp(-(want[:6] - np.asarray(exp.thresholds))))
    assert list(emotions.values()) == [round(float(p), 2) for p in probs]
    served = main(["serve", "mosei_trans", "--checkpoint-dir", ck,
                   "--concurrent", "3", *base])
    assert "seeded random" not in capsys.readouterr().err
    for (logits, _), s in zip(served, samples):
        ref = ens.logits({k: v[None] for k, v in s.items()}).numpy()[0]
        np.testing.assert_allclose(logits, ref, rtol=0, atol=1e-5)
    main(["serve", "mosei_trans", *base])
    assert "seeded random" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="no trained members"):
        main(["serve", "ren_mme", "--checkpoint-dir", ck, "--device", "cpu"])


def test_cli_sweep_resume_and_tuned_thresholds(tmp_path, capsys):
    """`train --sweep-thresholds` prints and saves the swept thresholds,
    which `predict` and `serve` then use unless --thresholds is given;
    `train --resume` on a finished store trains nothing."""
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", *TINY_SET, "--quiet"]
    main(["train", "mosei_trans", "--epochs", "1", "--n-train", "8",
          "--n-test", "6", "--checkpoint-dir", ck, "--sweep-thresholds",
          *base])
    lines = _json_lines(capsys.readouterr().out)
    sweep = lines[-1]["best_thresholds"]
    names = configs.get("mosei_trans").emotion_names
    tuned = [sweep[n]["t"] for n in names]
    saved = json.load(open(tmp_path / "ck" / "thresholds.json"))
    assert saved["thresholds"] == tuned and saved["source"] == "sweep"
    table = main(["predict", "mosei_trans", "-o", str(tmp_path / "p.npz"),
                  "--n-test", "6", "--checkpoint-dir", ck, *base])
    assert table["thresholds"] == [np.float32(t).item() for t in tuned]
    table = main(["predict", "mosei_trans", "-o", str(tmp_path / "p.npz"),
                  "--n-test", "6", "--checkpoint-dir", ck,
                  "--thresholds=0,0,0,0,0,0", *base])
    assert table["thresholds"] == [0.0] * 6
    capsys.readouterr()
    main(["serve", "mosei_trans", "--checkpoint-dir", ck,
          "--device", "cpu", *TINY_SET])
    assert "tuned thresholds" in capsys.readouterr().err
    res = main(["train", "mosei_trans", "--epochs", "1", "--n-train", "8",
                "--n-test", "6", "--checkpoint-dir", ck, "--resume", *base])
    assert res.fold_histories == [[], []]
