"""PyTorch port, the lockstep k-fold drivers (train/vmap_kfold.py) on a
('data', 'model') mesh of gloo ranks spawned on the CPU (two spawns,
helpers in tests/torch_lockstep_mesh_dist.py):

- dp=2 in float64 against the single-process port driver of the same
  kind, to 1e-8: the host-fed lockstep at `ren_mme` (dropout 0.1, R-Drop,
  members stopping at different epochs), the device-resident lockstep and
  `run_kfold_fully_compiled`: histories, best and final parameters, and
  the same learning rates and stops on both ranks; a device-resident run
  cut and resumed on the mesh, bit-equal to the uninterrupted one;
- dp=2 x tp=2 on 4 ranks: device-resident and one-dispatch at
  `mosei_realformer` (gates non-zero) and `mosei_trans`; in the same
  spawn the merged minus grid and the stacked RealFormer grid at tp=2
  against the unrolled tp=2 path's step-1 gradients, to 1e-8;
- against JAX: the dp=2 device-resident run against JAX's
  `run_kfold_vmapped(device_resident=True, mesh=make_mesh(n_data=2))`,
  and the dp=2 x tp=2 one-dispatch run against JAX's
  `run_kfold_fully_compiled(mesh=make_mesh(n_data=2, n_model=2), tp=True)`,
  on JAX's permutations from the same weights (epoch losses 1e-3, best
  parameters 2e-4, tests/test_torch_vmap_kfold.py's bounds);
- `cli train --dp 2 [--tp 2]` with --device-resident and --one-dispatch
  on the ranks, logging JAX's mesh line, and `eval` and `predict` reading
  the store in one process.

JAX's references are computed while the ranks run."""

import json
import re

import pytest

torch = pytest.importorskip("torch")

import torch_lockstep_mesh_dist as lmd  # noqa: E402
from multimodal_emotion_processing_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from multimodal_emotion_processing_tpu.train import vmap_kfold as jvk  # noqa: E402
from multimodal_emotion_processing_tpu_torch import cli  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.kfold import contiguous_folds  # noqa: E402
from torch_driver_common import (EPOCH_TOL, assert_params_close, exps,  # noqa: E402,F401
                                 jax_init_params, jax_model,
                                 jax_permutation, one_intra_op_thread,
                                 port_params, rel)

F64_TOL = 1e-8      # tests/test_parallel.py:107
REN_TRAIN = dict(batch_size=4, n_folds=2, early_stop=1, epochs=4)
SMALL_TRAIN = dict(batch_size=4, n_folds=2, early_stop=1, epochs=3)
CLI_SETS = ["--set", "model.dim=16", "--set", "model.l_len=4", "--set",
            "model.v_len=6", "--set", "model.a_len=8", "--set",
            "train.n_folds=2", "--set", "train.batch_size=4"]
CLI_FLAGS = {"resident": ["--device-resident"], "one": ["--one-dispatch"]}
FALLBACK = re.compile(r"disabling|falling back|no-op|subsumes|disabled by|"
                      r"unequal contiguous")


def _jax_start(name, model, kind, *, n, seed, spread, kw, **train):
    """A run from JAX's init of every member on JAX's shuffles (f32): the
    ranks' inputs (the spec, the port's state dicts of JAX's init by seed,
    JAX's permutation of each epoch), and the configs, JAX's model and the
    samples for JAX's driver."""
    exp, jexp = exps(name, model=model, **train)
    jmodel = jax_model(jexp, spread=spread)
    samples = synthetic_dataset(name, exp.model, n, seed=seed)
    m = exp.train.n_folds * kw.get("seeds_per_fold", 1)
    va, _ = contiguous_folds(n, exp.train.n_folds, exp.train.fold_size)[0]
    n_tr = n - (va.stop - va.start)
    epochs = kw["epochs"]
    inputs = {
        "spec": lmd.spec(name, kind, model=model, n=n, seed=seed, f64=False,
                         kw=kw, **train),
        "weights": {exp.train.seed + i: port_params(
            jax_init_params(jmodel, exp.train.seed + i), exp)
            for i in range(m)},
        "perms": [jax_permutation(20903, e, n_tr, "cpu", members=m)
                  for e in range(epochs)]}
    return inputs, exp, jexp, jmodel, samples


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """dp=2: the f64 driver runs, the resume, the JAX-started run, the
    CLI; JAX's meshed device-resident driver computed meanwhile."""
    root = tmp_path_factory.mktemp("lockstep_dp2")
    ren = dict(model=lmd.REN, n=24, impl="pallas_fused", **REN_TRAIN)
    resume = lmd.spec("ren_mme", "resident", **ren)
    resume["cut"] = 2
    js, exp, jexp, jmodel, samples = _jax_start(
        "rencecps", {"dim": 16}, "resident", n=44, seed=4, spread=False,
        kw={"seeds_per_fold": 2, "epochs": 5}, batch_size=8, n_folds=2,
        early_stop=1)
    inputs = {
        "n_model": 1,
        "runs": {"host": lmd.spec("ren_mme", "host",
                                  kw={"seeds_per_fold": 2}, **ren),
                 "resident": dict(lmd.spec("ren_mme", "resident", **ren),
                                  store=True),
                 "one": dict(lmd.spec("ren_mme", "one", **ren), store=True)},
        "resume": resume, "jax_start": js, "guards": True,
        "cli": {key: _cli_argv(root / f"cli_{key}", ["--dp", "2"] + flags)
                for key, flags in CLI_FLAGS.items()}}
    ctx = lmd.start(2, root, inputs)
    ref = jvk.run_kfold_vmapped(samples, None, jmodel, jexp.train, epochs=5,
                                device_resident=True, seeds_per_fold=2,
                                mesh=jmake_mesh(n_data=2))
    outs = lmd.finish(ctx, 2, root)
    return {"outs": outs, "jax": ref, "exp": exp, "root": root}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """dp=2 x tp=2: the f64 driver runs, the fast grid paths, the
    JAX-started one-dispatch run, the CLI; JAX's meshed one-dispatch
    driver computed meanwhile."""
    root = tmp_path_factory.mktemp("lockstep_dp2tp2")
    rf = dict(model=lmd.RF, n=16, impl="pallas", **SMALL_TRAIN)
    mt = dict(model=lmd.TINY, n=16, impl="pallas_fused", **SMALL_TRAIN)
    js, exp, jexp, jmodel, samples = _jax_start(
        "mosei_trans", lmd.TINY, "one", n=16, seed=5, spread=True,
        kw={"epochs": 2}, batch_size=4, n_folds=2, early_stop=1)
    inputs = {
        "n_model": 2,
        "runs": {"rf_resident": lmd.spec("mosei_realformer", "resident", **rf),
                 "rf_one": lmd.spec("mosei_realformer", "one", **rf),
                 "mt_resident": lmd.spec("mosei_trans", "resident", **mt),
                 "mt_one": lmd.spec("mosei_trans", "one", **mt)},
        "grids": {"merged": {"name": "mosei_trans", "model": lmd.TINY,
                             "path": "merged"},
                  "stacked": {"name": "mosei_realformer", "model": lmd.RF,
                              "path": "stacked"}},
        "jax_start": js,
        "cli": {key: _cli_argv(root / f"cli_{key}",
                               ["--dp", "2", "--tp", "2"] + flags)
                for key, flags in CLI_FLAGS.items()}}
    ctx = lmd.start(4, root, inputs)
    ref = jvk.run_kfold_fully_compiled(
        samples, jmodel, jexp.train, epochs=2,
        mesh=jmake_mesh(n_data=2, n_model=2), tp=True)
    outs = lmd.finish(ctx, 4, root)
    return {"outs": outs, "jax": ref, "exp": exp, "root": root}


def _cli_argv(store, flags):
    return (["train", "ren_mme", "--device", "cpu", "--epochs", "2",
             "--n-train", "24", "--n-test", "8", "--checkpoint-dir",
             str(store)] + CLI_SETS + flags)


def _close(a, b, tol=F64_TOL):
    return abs(a - b) <= tol * max(1.0, abs(b))


def _dicts_close(got, ref, tol=F64_TOL):
    assert list(got) == list(ref)
    for k, v in ref.items():
        scale = max(1.0, float(v.abs().max()))
        assert float((got[k] - v).abs().max()) <= tol * scale, k


def _same_run(got, ref, tol=F64_TOL):
    """Histories, losses, learning rates, best and final parameters of
    two runs within `tol`, with the same steps, samples and stops."""
    assert [len(h) for h in got["hist"]] == [len(h) for h in ref["hist"]]
    for h, hr in zip(got["hist"], ref["hist"]):
        for (tr, va, steps, n), (tr0, va0, steps0, n0) in zip(h, hr):
            assert (steps, n) == (steps0, n0)
            assert _close(tr, tr0, tol) and _close(va, va0, tol)
    assert len(got["lrs"]) == len(ref["lrs"])
    assert all(_close(a, b, tol) for a, b in zip(got["lrs"], ref["lrs"]))
    assert got["last_lrs"] == ref["last_lrs"]
    assert all(_close(a, b, tol) for a, b in zip(got["losses"],
                                                  ref["losses"]))
    for key in ("best", "final"):
        for a, b in zip(got[key], ref[key]):
            _dicts_close(a, b, tol)


def _ranks_agree(outs, key):
    """Every rank's controllers: the same stops and learning rates, bit
    for bit, and the same losses."""
    r0 = outs[0]["runs"][key]
    for out in outs[1:]:
        r = out["runs"][key]
        assert r["hist"] == r0["hist"] and r["lrs"] == r0["lrs"]
        assert r["last_lrs"] == r0["last_lrs"] and r["losses"] == r0["losses"]


@pytest.mark.parametrize("key", ["host", "resident", "one"])
def test_dp2_drivers_equal_one_process(two_ranks, key):
    outs = two_ranks["outs"]
    single = outs[0]["single"][key]
    if key == "host":
        assert len({len(h) for h in single["hist"]}) > 1, \
            "no member stopped early"
    for out in outs:
        _same_run(out["runs"][key], single)
    _ranks_agree(outs, key)


def test_dp2_resume_is_bit_equal(two_ranks):
    """Cut at the start of epoch 3 (every rank), resumed on the mesh from
    the store rank 0 wrote: the uninterrupted run's bits."""
    for out in two_ranks["outs"]:
        assert out["cut_epochs"][0] == 1
        got, ref = out["resumed"], out["runs"]["resident"]
        assert got["hist"] == ref["hist"] and got["losses"] == ref["losses"]
        for a, b in zip(got["best"], ref["best"]):
            assert all(torch.equal(a[k], b[k]) for k in b)
        assert "manifest.json" in out["store_files"]


def test_dp2_refuses_to_split_rdrop_pairs(two_ranks):
    """Batch 3 of R-Drop pairs on dp=2 would end a rank's rows inside a
    pair (JAX's GSPMD computes the global batch's KL, a rank here its own
    rows'): run_experiment and the lockstep raise on every rank."""
    for out in two_ranks["outs"]:
        assert "duplicate pairs must stay whole" in \
            out["guards"]["run_experiment"]
        assert "batch_size (3) must divide the data axis (2)" in \
            out["guards"]["lockstep"]


@pytest.mark.parametrize("key", ["rf_resident", "rf_one", "mt_resident",
                                 "mt_one"])
def test_dp2_tp2_drivers_equal_one_process(four_ranks, key):
    outs = four_ranks["outs"]
    single = outs[0]["single"][key]
    for out in outs:
        _same_run(out["runs"][key], single)
    _ranks_agree(outs, key)


@pytest.mark.parametrize("path", ["merged", "stacked"])
def test_fast_grid_paths_under_tensor_parallelism_match_unrolled(four_ranks,
                                                                 path):
    """The merged minus grid (mosei_trans) and the stacked RealFormer grid
    (mosei_realformer, gates set) at tp=2 on the dp=2 x tp=2 mesh: each
    rank took the fast path, and its step-1 loss, whole gradients and
    clip norm equal the unrolled tp=2 path's to 1e-8 (f64)."""
    for out in four_ranks["outs"]:
        rec = out["grids"][path]
        assert rec["fast_calls"] > 0
        (loss, grads, norm), (loss0, grads0, norm0) = rec["fast"], \
            rec["unrolled"]
        assert _close(loss, loss0) and _close(norm, norm0)
        _dicts_close(grads, grads0)


def _against_jax(port, jax_result, exp):
    _, jhists, jbest, jlosses = jax_result
    assert len(port["hist"]) == len(jhists)
    for h, jh in zip(port["hist"], jhists):
        assert 1 <= len(h) <= len(jh)
        for (tr, va, _, _), e in zip(h, jh):
            assert rel(tr, e.train_loss) <= EPOCH_TOL
            assert rel(va, e.valid_loss) <= EPOCH_TOL
    for i, (b, jb) in enumerate(zip(port["best"], jbest)):
        assert rel(port["losses"][i], jlosses[i]) <= EPOCH_TOL
        assert_params_close(b, jb, exp)


def test_dp2_device_resident_matches_jax(two_ranks):
    """rencecps, 2 folds x 2 seeds, early stop 1 over 5 epochs, on JAX's
    shuffles from JAX's weights: each rank's members as JAX's meshed
    device-resident driver gives them."""
    for out in two_ranks["outs"]:
        _against_jax(out["jax_start"], two_ranks["jax"], two_ranks["exp"])


def test_dp2_tp2_one_dispatch_matches_jax(four_ranks):
    """mosei_trans (LayerNorm biases spread), 2 folds, early stop 1 over 2
    epochs, on JAX's shuffles from JAX's weights: each rank's members as
    JAX's dp=2 x tp=2 one-dispatch driver gives them."""
    for out in four_ranks["outs"]:
        _against_jax(out["jax_start"], four_ranks["jax"], four_ranks["exp"])


@pytest.mark.parametrize("ranks, key", [
    ("two_ranks", "resident"), ("two_ranks", "one"),
    ("four_ranks", "resident"), ("four_ranks", "one")])
def test_cli_train_on_a_mesh_writes_a_store_eval_and_predict_read(
        ranks, key, request, tmp_path, capsys):
    """`cli train ren_mme --dp 2 [--tp 2]` with --device-resident or
    --one-dispatch on the ranks: rank 0 logs JAX's mesh line and no
    fallback, reports, and records the lockstep in run_meta.json; the
    store it wrote is read by `eval` and `predict` in one process."""
    got = request.getfixturevalue(ranks)
    world = len(got["outs"])
    tp = world // 2
    rank0 = got["outs"][0]["cli"][key]
    err = rank0["err"].splitlines()
    # JAX pipelines.py's f-string
    assert f"[ren_mme] mesh: dp=2 tp={tp} over {world} devices" in err
    assert not [ln for ln in err if FALLBACK.search(ln)]
    assert "report" in rank0["out"]
    for out in got["outs"][1:]:
        assert out["cli"][key]["out"] == ""
    store = got["root"] / f"cli_{key}"
    meta = json.load(open(store / "run_meta.json"))
    assert meta["drivers"]["vmap_folds"] and meta["drivers"]["device_resident"]
    assert meta["drivers"]["one_dispatch"] == (key == "one")
    assert (meta["drivers"]["dp"], meta["drivers"]["tp"]) == (2, tp)
    capsys.readouterr()
    cli.main(["eval", "ren_mme", "--device", "cpu", "--n-train", "24",
              "--n-test", "8", "--quiet", "--checkpoint-dir", str(store)]
             + CLI_SETS)
    report = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert any("report" in r for r in report)
    pred = tmp_path / "p.jsonl"
    cli.main(["predict", "ren_mme", "--device", "cpu", "--n-test", "8",
              "--quiet", "--checkpoint-dir", str(store), "-o", str(pred)]
             + CLI_SETS)
    rows = [json.loads(ln) for ln in open(pred)]
    assert len(rows) == 8

