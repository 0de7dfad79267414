"""PyTorch port, the entry points over the model layer's new combinations and
the grid's other paths, on the CPU at tiny widths, the RealFormer gates set
non-zero (at their init of 0 the attention would not reach the logits):

- the stacked RealFormer grid through `Ensemble(stacked=True)`,
  `StreamingPredictor`, `BatchingServer` and `ParagraphStreamingPredictor`
  (`stacked_grid=True`), each against its unstacked build at 2e-4, and
  taken (the stacked path called);
- `predict --stacked-grid`, `serve --stacked-grid` (batch 1, concurrent,
  the paragraph stream) and `train --set model.block=realformer`;
  `apply_tuned` filling `stacked_grid` from a `stacked` winner;
- a new combination through the Trainer with remat (the same gradients)
  and with bf16 compute, through `export` (the artifact against
  `ensemble_serve_fn`) and `summary` (totals and FLOPs equal to JAX's);
- on two gloo ranks, a new combination's step-1 gradients at tp=2 against
  one process, and `run_predict(dp=2, stacked=True)` against one
  process's unstacked `run_predict`.
The merged and stacked paths under tensor parallelism:
tests/test_torch_lockstep_mesh.py."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_grid_paths_dist as gpd  # noqa: E402
from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.bench import flops as jflops  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.utils import parameter_count as jcount  # noqa: E402
from multimodal_emotion_processing_tpu_torch import cli, configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.bench import autotune  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model, grid  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import (  # noqa: E402
    BatchingServer, ParagraphStreamingPredictor, StreamingPredictor,
    ensemble_serve_fn)
from multimodal_emotion_processing_tpu_torch.serve.export import (  # noqa: E402
    export_predictor, load_predictor)
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402

F32_TOL = 2e-4
TINY = {
    "robot_demo": dict(l_len=4, v_len=9, a_len=7, dim=12, n_heads=2,
                       l_dim=7, a_dim=5, v_dims_multires=[3, 4, 5]),
    "mosei_realformer": dict(l_len=5, v_len=6, a_len=4, dim=12, n_heads=2,
                             l_dim=7, v_dim=3, a_dim=5, p_len=3),
    "mosei_trans": dict(l_len=4, v_len=9, a_len=7, dim=12, n_heads=2,
                        l_dim=7, v_dim=3, a_dim=5),
}
# a pair head over RealFormer blocks, the conv unify and positions: a
# combination no reference config has
NEW = dict(block="realformer", unify="conv", use_position_embedding=True)
RF_OFFSETS = (0.1, -0.3, -0.5, -0.6, -0.3, -0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Tiny models run op by op: one intra-op thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(name, **model):
    exp = configs.get(name)
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, **{**TINY[name], **model}))


def _sets(name, **model):
    return [f"--set=model.{k}={json.dumps(v)}"
            for k, v in {**TINY[name], **model}.items()]


def _members(exp, n=2, seed=0):
    """n seeded members with gates a, b ~ U(0.5, 1.5), c ~ U(0.25, 1)."""
    out = []
    for i in range(n):
        m = build_model(exp, device="cpu", seed=seed + i)
        g = torch.Generator().manual_seed(100 + seed + i)
        with torch.no_grad():
            for name, p in m.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf in ("a", "b"):
                    p.copy_(0.5 + torch.rand(p.shape, generator=g))
                elif leaf == "c":
                    p.copy_(0.25 + 0.75 * torch.rand(p.shape, generator=g))
        out.append(m)
    return out


def _batch(exp, n=4, seed=3):
    samples = synthetic_dataset(exp.name, exp.model, n, seed=seed)
    return samples, {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                     for k in samples[0]}


def _close(got, ref, tol=F32_TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


@pytest.fixture
def stacked_calls(monkeypatch):
    calls = []
    real = grid.Grid._stacked_realformer

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(grid.Grid, "_stacked_realformer", counted)
    return calls


@pytest.mark.parametrize("name,model", [("robot_demo", {}),
                                        ("mosei_realformer", {}),
                                        ("mosei_trans", NEW)])
def test_ensemble_stacked_matches_unstacked(name, model, stacked_calls):
    exp = _exp(name, **model)
    members = _members(exp)
    _, batch = _batch(exp)
    ref = Ensemble(members).logits(batch)
    assert not stacked_calls
    got = Ensemble(members, stacked=True).logits(batch)
    assert stacked_calls
    _close(got, ref)


def test_servers_take_the_stacked_grid(stacked_calls):
    exp = _exp("robot_demo")
    members = _members(exp)
    samples, _ = _batch(exp, n=3)
    off = exp.thresholds
    ref = StreamingPredictor(members, off)
    sp = StreamingPredictor(members, off, stacked_grid=True)
    for s in samples:
        for got, want in zip(sp.predict(s), ref.predict(s)):
            _close(got, want)
    n = len(stacked_calls)
    assert n
    with BatchingServer(members, off, stacked_grid=True) as srv, \
            BatchingServer(members, off) as plain:
        srv.warmup(samples[0])
        got = [srv.submit(s).result(timeout=60) for s in samples]
        want = [plain.predict(s) for s in samples]
    assert len(stacked_calls) > n
    for g, w in zip(got, want):
        _close(g[0], w[0])
        _close(g[1], w[1])


def test_paragraph_stream_stacked_matches_unstacked(stacked_calls):
    exp = _exp("mosei_realformer")
    members = _members(exp, n=3)
    samples, _ = _batch(exp, n=1)
    clips = [{k: samples[0][k][t] for k in
              ParagraphStreamingPredictor._CLIP_KEYS}
             for t in range(exp.model.p_len)]
    ref = ParagraphStreamingPredictor(members, RF_OFFSETS)
    sp = ParagraphStreamingPredictor(members, RF_OFFSETS, stacked_grid=True)
    for c in clips:
        for got, want in zip(sp.push(c), ref.push(c)):
            _close(got, want)
    assert stacked_calls


def test_cli_predict_stacked_grid(tmp_path, stacked_calls):
    base = ["predict", "robot_demo", "--device", "cpu", "--init-random",
            "--n-test", "6", "--quiet", *_sets("robot_demo")]
    ref = cli.main(base + ["-o", str(tmp_path / "a.npz")])
    assert not stacked_calls
    got = cli.main(base + ["-o", str(tmp_path / "b.jsonl"), "--stacked-grid"])
    assert stacked_calls and got["rows"] == ref["rows"] == 6
    _close(got["logits"], ref["logits"])


@pytest.mark.parametrize("argv", [
    ["robot_demo"], ["robot_demo", "--concurrent", "3"],
    ["mosei_realformer", "--thresholds=" + ",".join(map(str, RF_OFFSETS))]])
def test_cli_serve_stacked_grid(argv, capsys, stacked_calls):
    out = cli.main(["serve", *argv, "--device", "cpu", "--stacked-grid",
                    *_sets(argv[0])])
    assert stacked_calls and out
    assert "happ" in capsys.readouterr().out    # an emotion's probability


def test_cli_train_a_new_combination(capsys):
    result = cli.main(["train", "mosei_trans", "--device", "cpu", "--epochs",
                       "1", "--n-train", "16", "--n-test", "8",
                       *_sets("mosei_trans", **NEW),
                       "--set=train.n_folds=2", "--set=train.batch_size=4"])
    assert result.report
    assert all(np.isfinite(h[-1].train_loss) for h in result.fold_histories)


def test_apply_tuned_fills_stacked_grid(tmp_path):
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"config": "mosei_realformer",
                                "winners": {"stacked": True}}))
    for argv in (["serve", "mosei_realformer"],
                 ["predict", "mosei_realformer", "-o", "x.npz"]):
        args = cli.build_parser().parse_args([*argv, "--tuned", str(path)])
        assert not args.stacked_grid
        assert autotune.apply_tuned(args, str(path)) == {"stacked": True}
        assert args.stacked_grid is True
    args = cli.build_parser().parse_args(["train", "mosei_realformer",
                                          "--tuned", str(path)])
    assert autotune.apply_tuned(args, str(path)) == {}   # train has no flag


def test_trainer_remat_and_bf16_on_a_new_combination():
    exp = _exp("mosei_trans", **NEW)
    [model] = _members(exp, n=1)
    _, batch = _batch(exp)

    def grads(remat):
        for g in (model.intensity, model.stimulation):
            g.remat = remat
        model.zero_grad(set_to_none=True)
        engine.batch_loss(model, exp.train, batch, impl="xla").backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    plain, remat = grads(False), grads(True)
    assert plain.keys() == remat.keys()
    for n in plain:
        assert torch.equal(plain[n], remat[n]), n
    bf16 = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, compute_dtype="bfloat16", batch_size=4))
    samples = synthetic_dataset(exp.name, exp.model, 8, seed=1)

    def loader():
        return iter(Batcher(samples, 4, shuffle=False)())

    _, hist = engine.Trainer(bf16, bf16.train, device="cpu").fit(
        loader, loader, epochs=1)
    assert np.isfinite(hist[0].train_loss) and np.isfinite(hist[0].valid_loss)


def test_export_a_new_combination():
    exp = _exp("mosei_trans", **NEW)
    members = _members(exp)
    samples, batch = _batch(exp, n=2)
    off = exp.thresholds
    fn = load_predictor(export_predictor(members, off, samples[0],
                                         batch_size=2, device="cpu"))
    got = fn({k: v for k, v in batch.items() if k != "label"})
    want = ensemble_serve_fn(members, off).fn(
        {k: v for k, v in batch.items() if k != "label"})
    for g, w in zip(got, want):
        _close(g, w, tol=1e-6)


def test_summary_of_a_new_combination_equals_jax():
    sets = [f"--set=model.{k}={json.dumps(v)}" for k, v in NEW.items()]
    out = cli.main(["summary", "mosei_trans", "--device", "cpu", *sets])
    jexp = jconfigs.get("mosei_trans")
    jexp = dataclasses.replace(jexp, model=dataclasses.replace(jexp.model,
                                                               **NEW))
    shapes = jax.eval_shape(jbuild(jexp).init, jax.random.PRNGKey(0))
    assert out["total"] == jcount(shapes)["Total"]
    assert out["flops_per_sample"]["forward"] == \
        jflops.forward_flops_per_sample(jexp.model)


def test_two_ranks_tp2_new_combination_and_dp2_stacked_predict(tmp_path):
    """tp=2 of the pair head over RealFormer blocks (column-parallel Q/K/V
    and FFN, row-parallel proj and classifier) against one process, f64;
    run_predict(dp=2, stacked=True) of two gate-set robot members from a
    store against one process's unstacked run_predict."""
    exp = _exp("mosei_trans", **NEW)
    [model] = _members(exp, n=1)
    samples = synthetic_dataset(exp.name, exp.model, 8, seed=4)
    batch = next(iter(Batcher(samples, 8, shuffle=False)()))
    tp_case = {"name": "mosei_trans", "model": {**TINY["mosei_trans"], **NEW},
               "batch": batch, "mesh": (1, 2), "dtype": torch.float64,
               "state_dict": {k: v.clone() for k, v in
                              model.state_dict().items()}}
    rexp = _exp("robot_demo")
    store = CheckpointStore(str(tmp_path / "store"))
    for i, m in enumerate(_members(rexp, seed=7)):
        store.save_params(f"robot_demo_{i + 1}", m, valid_loss=0.5 + i)
    predict = {"name": "robot_demo", "checkpoint_dir": str(tmp_path / "store"),
               "n_test": 10, "overrides": {"model": TINY["robot_demo"],
                                           "train": {"batch_size": 4}}}
    outs = gpd.spawn(2, tmp_path, {"tp_case": tp_case, "predict": predict})
    single = outs[0]["tp"]["single"]
    for out in outs:
        loss, grads, norm = out["tp"]["mesh"]
        np.testing.assert_allclose(loss, single[0], rtol=1e-10)
        np.testing.assert_allclose(norm, single[2], rtol=1e-8)
        assert set(grads) == set(single[1])
        for k, g in single[1].items():
            np.testing.assert_allclose(grads[k].numpy(), g.numpy(),
                                       rtol=1e-8, atol=1e-8, err_msg=k)
        _close(out["predict"], outs[0]["predict_single"])
