"""PyTorch port, the learning-rate sweep (train/sweep.py) on the CPU at tiny
widths: its member at lr == tcfg.lr equals `fit_fully_compiled` bit for
bit; members of the same (lr, seed) are identical; JAX's (lr x seed)
layout, the ranking and the wd axis; the sweep against the JAX package's
`run_lr_sweep` on JAX's permutations (injected into `epoch_permutation`)
from the same weights (best losses 1e-3, the same best and stop epochs,
best parameters 2e-4); `run_lr_sweep_experiment` saving the winner, which
`predict` then serves from a sweep-only store; and the CLI's `sweep`."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu.train import sweep as jsweep  # noqa: E402
from multimodal_emotion_processing_tpu_torch import pipelines  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import build_parser, main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.device_epochs import fit_fully_compiled  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.sweep import run_lr_sweep  # noqa: E402
from torch_driver_common import (EPOCH_TOL, assert_params_close,  # noqa: E402,F401
                                 assert_state_dicts_equal, exps, jax_model,
                                 jax_shuffle, one_intra_op_thread, rel,
                                 same_start)

OVERRIDES = {"model": {"dim": 16}, "train": {"batch_size": 8, "n_folds": 2}}


def _split(exp, n=64, seed=0):
    samples = synthetic_dataset("rencecps", exp.model, n=n, seed=seed)
    return samples[16:], samples[:16]  # train, valid


def _curve(hist):
    return [(e.train_loss, e.valid_loss) for e in hist]


def test_sweep_member_is_the_single_run():
    """A seeds_per_lr=1 member at lr == tcfg.lr replays fit_fully_compiled's
    init, shuffle keys and steps: the same history, best epoch, loss and
    parameters, bit for bit; two members of the same (lr, seed) are the
    same computation."""
    exp, _ = exps("rencecps", batch_size=8, early_stop=2)
    train, valid = _split(exp)
    _, hist, best, best_epoch, best_loss = fit_fully_compiled(
        exp, exp.train, train, valid, epochs=4, device="cpu")
    res = run_lr_sweep(train, valid, exp, exp.train,
                       lrs=[exp.train.lr, exp.train.lr], epochs=4,
                       device="cpu")
    a, b = res.members
    assert res.winner == 0
    assert (a.lr, a.seed) == (exp.train.lr, exp.train.seed)
    assert _curve(a.history) == _curve(hist) == _curve(b.history)
    assert (a.best_epoch, a.best_valid_loss) == (best_epoch, best_loss)
    assert_state_dicts_equal(a.best_params, best)
    assert_state_dicts_equal(b.best_params, best)


def test_sweep_layout_ranking_and_wd_axis():
    """lrs x wds x seeds: member i = (candidate i // S, seed + i % S);
    the table is best-first; a member at the config's wd is the single
    run, one at wd 0.9 diverges from it."""
    exp, _ = exps("rencecps", batch_size=8)
    train, valid = _split(exp, seed=2)
    res = run_lr_sweep(train, valid, exp, exp.train, lrs=[1e-3, 1e-5],
                       seeds_per_lr=2, epochs=2, device="cpu")
    assert [m.lr for m in res.members] == [1e-3, 1e-3, 1e-5, 1e-5]
    assert [m.seed for m in res.members] == [exp.train.seed,
                                             exp.train.seed + 1] * 2
    assert _curve(res.members[0].history) != _curve(res.members[2].history)
    table = res.table()
    losses = [row["best_valid_loss"] for row in table]
    assert losses == sorted(losses)
    assert res.members[res.winner].best_valid_loss == losses[0]
    _, hist, _, _, _ = fit_fully_compiled(exp, exp.train, train, valid,
                                          epochs=2, device="cpu")
    wd = run_lr_sweep(train, valid, exp, exp.train, lrs=[exp.train.lr],
                      wds=[exp.train.weight_decay, 0.9], epochs=2,
                      device="cpu")
    assert [m.wd for m in wd.members] == [exp.train.weight_decay, 0.9]
    assert _curve(wd.members[0].history) == _curve(hist)
    assert _curve(wd.members[1].history) != _curve(hist)
    assert all("wd" in row for row in wd.table())


def test_sweep_matches_jax(jax_shuffle, same_start):
    """Two lrs x two seeds with early stop 1 on JAX's shuffles from the same
    weights: each member's epochs, best and stop epochs, best loss and
    parameters as JAX's run_lr_sweep gives them."""
    exp, jexp = exps("rencecps", batch_size=8, early_stop=1)
    train, valid = _split(exp, seed=3)
    jmodel = jax_model(jexp, spread=False)
    same_start(jmodel)
    kw = dict(lrs=[1e-3, 3e-4], seeds_per_lr=2, epochs=4)
    res = run_lr_sweep(train, valid, exp, exp.train, device="cpu", **kw)
    jres = jsweep.run_lr_sweep(train, valid, jmodel, jexp.train, **kw)
    assert res.winner == jres.winner
    for m, jm in zip(res.members, jres.members):
        assert (m.lr, m.wd, m.seed, m.best_epoch, m.stop_epoch) == (
            jm.lr, jm.wd, jm.seed, jm.best_epoch, jm.stop_epoch)
        assert len(m.history) == len(jm.history)
        for a, b in zip(m.history, jm.history):
            assert rel(a.train_loss, b.train_loss) <= EPOCH_TOL
            assert rel(a.valid_loss, b.valid_loss) <= EPOCH_TOL
        assert rel(m.best_valid_loss, jm.best_valid_loss) <= EPOCH_TOL
        assert_params_close(m.best_params, jm.best_params, exp)


def test_sweep_experiment_cli_and_sweep_only_store(tmp_path, capsys):
    """run_lr_sweep_experiment carves fold 0's split and saves the winner
    as '<config>_sweep_winner'; `predict` serves it from that sweep-only
    store; the CLI's `sweep` parses and prints the same document."""
    ck = str(tmp_path / "ck")
    out = pipelines.run_lr_sweep_experiment(
        "rencecps", lrs=[1e-3, 1e-4], n_train=48, epochs=2, quiet=True,
        overrides=OVERRIDES, checkpoint_dir=ck, device="cpu")
    assert len(out["table"]) == 2
    assert out["winner"]["lr"] in (1e-3, 1e-4)
    assert out["table"][0]["best_valid_loss"] == \
        out["winner"]["best_valid_loss"]
    assert "rencecps_sweep_winner" in CheckpointStore(ck).manifest
    table = pipelines.run_predict("rencecps", checkpoint_dir=ck, n_test=8,
                                  overrides=OVERRIDES, quiet=True,
                                  device="cpu")
    assert table["members"] == 1 and table["rows"] == 8
    args = build_parser().parse_args(
        ["sweep", "rencecps", "--lrs", "1e-3,3e-4", "--seeds-per-lr", "2",
         "--wds", "0.0,0.01"])
    assert args.cmd == "sweep" and args.lrs == "1e-3,3e-4"
    assert args.seeds_per_lr == 2 and args.wds == "0.0,0.01"
    capsys.readouterr()
    got = main(["sweep", "rencecps", "--lrs", "1e-3,1e-4", "--epochs", "2",
                "--n-train", "48", "--device", "cpu", "--quiet",
                "--set", "model.dim=16", "--set", "train.batch_size=8",
                "--set", "train.n_folds=2"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["table"] == got["table"] == out["table"]
    with pytest.raises(SystemExit, match="comma-separated floats"):
        main(["sweep", "rencecps", "--lrs", "fast", "--device", "cpu"])
