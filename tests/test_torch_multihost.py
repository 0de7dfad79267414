"""The port's multi-process seams (parallel/mesh.py), as the JAX
package's tests/test_multihost.py exercises them: two gloo ranks spawned
on the CPU, each assembling the same seeded global batches and feeding
its rows through the Trainer's mesh, give the one-process trajectory
(JAX's `test_two_process_dp_matches_single_process`, a Tier-1 test
here); `run_experiment(dp=)` and `run_experiment(tp=)` on those ranks
against one process, through the checkpoint store rank 0 writes; and the
CLI's --dp, --tp and --impl cp at world size 1, with the refusal of a
world that does not match."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_common as tdc  # noqa: E402
from multimodal_emotion_processing_tpu_torch import cli  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_dataset)
from multimodal_emotion_processing_tpu_torch.parallel import (  # noqa: E402
    process_batch_slice)
from multimodal_emotion_processing_tpu_torch.pipelines import run_experiment  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402

# tests/test_multihost.py:44-48
FIT = {"name": "rencecps", "model": {"dim": 16}, "train": {"batch_size": 8},
       "epochs": 2}
TINY = {"l_len": 4, "v_len": 6, "a_len": 8, "dim": 12, "n_heads": 2,
        "l_dim": 5, "v_dim": 4, "a_dim": 3}


def _exp_kw(name, model, folds=2, batch=8):
    sets = {"model": dict(model), "train": {"n_folds": folds,
                                            "batch_size": batch}}
    return dict(name=name, n_train=32, n_test=8, epochs=2, overrides=sets)


EXPERIMENTS = {
    "rencecps_dp2": {**_exp_kw("rencecps", {"dim": 16}), "dp": 2},
    "mosei_trans_tp2": {**_exp_kw("mosei_trans", TINY), "dp": 1, "tp": 2},
    # no mesh: every rank trains on the same rows, the attention sharded
    # over both (psum CP); rank 0 alone writes the store
    "mosei_trans_cp": {**_exp_kw("mosei_trans", TINY), "impl": "cp"},
}
# dp sums whole-row gradients: one process's numbers to f32 rounding.  tp
# sums partial products in another order, and Adam's first steps scale
# every gradient entry to about ±lr whatever its size, so entries near 0
# that round apart move apart by up to lr; the f64 step test of
# test_torch_parallel.py (1e-8 after three steps) pins the math itself
RTOL = {"rencecps_dp2": 1e-5, "mosei_trans_tp2": 1e-3, "mosei_trans_cp": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    runs = {k: {**v, "checkpoint_dir": str(root / k)}
            for k, v in EXPERIMENTS.items()}
    exp = tdc.exp_of(FIT["name"], FIT["model"], FIT["train"])
    inputs = {**FIT, "samples": synthetic_dataset("rencecps", exp.model, 16, 0),
              "experiments": runs}
    return inputs, tdc.spawn("fit", 2, root, inputs)


def test_two_process_dp_matches_single_process(ranks):
    """Both ranks see the same global trajectory, and it is one
    process's (rtol 1e-5, atol 1e-6, as JAX's test holds it)."""
    inputs, outs = ranks
    assert outs[0]["history"] == outs[1]["history"]
    exp = tdc.exp_of(FIT["name"], FIT["model"], FIT["train"])

    def loader():
        return iter(Batcher(inputs["samples"], 8, shuffle=True, seed=1)())

    _, hist = engine.Trainer(exp, exp.train, device="cpu").fit(
        loader, loader, epochs=FIT["epochs"])
    ours = [[e.train_loss, e.valid_loss] for e in hist]
    np.testing.assert_allclose(outs[0]["history"], ours, rtol=1e-5,
                               atol=1e-6)
    # the real samples of the global batches, counted once
    assert outs[0]["samples"] == [e.samples for e in hist] == [16, 16]


def test_rank0_alone_checkpoints(ranks):
    _, outs = ranks
    assert outs[0]["saves"] and outs[1]["saves"] == []


def test_process_batch_slice_partitions_global_batch(ranks):
    """Each rank's rows of the data axis tile the global batch once; one
    process owns it whole; a batch that does not divide raises."""
    _, outs = ranks
    assert [o["slice"] for o in outs] == [slice(0, 4), slice(4, 8)]
    assert [o["world_slice"] for o in outs] == [slice(0, 4), slice(4, 8)]
    assert process_batch_slice(64) == slice(0, 64)


@pytest.mark.parametrize("key", sorted(EXPERIMENTS))
def test_run_experiment_on_two_ranks_matches_one_process(ranks, key,
                                                         tmp_path):
    """run_experiment with dp=2, tp=2 or impl="cp" on two ranks: every
    rank's fold histories and ensemble logits (members restored from the
    store rank 0 wrote, gathered whole under tp) are one process's at
    impl="xla"."""
    _, outs = ranks
    kw = {k: v for k, v in EXPERIMENTS[key].items()
          if k not in ("dp", "tp", "impl")}
    name = kw.pop("name")
    ref = run_experiment(name, device="cpu", quiet=True,
                         checkpoint_dir=str(tmp_path), **kw)
    want = [[[e.train_loss, e.valid_loss] for e in h]
            for h in ref.fold_histories]
    for out in outs:
        got = out["experiments"][key]
        np.testing.assert_allclose(got["histories"], want, rtol=RTOL[key],
                                   atol=1e-6)
        np.testing.assert_allclose(got["logits"], ref.logits, rtol=RTOL[key],
                                   atol=RTOL[key])
        assert got["manifest"] == sorted(ref.store.manifest)


def _cli(argv, capsys):
    cli.main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


TRAIN = ["train", "mosei_trans", "--device", "cpu", "--epochs", "1",
         "--n-train", "16", "--n-test", "8", "--quiet", "--set",
         "train.n_folds=2", "--set", "train.batch_size=8"] + [
    a for k, v in TINY.items() for a in ("--set", f"model.{k}={v}")]


def test_cli_dp_tp_at_world_size_one(capsys):
    """--dp 1 --tp 1 at world size 1: a mesh of one rank (its collectives
    over that rank) gives the plain run's numbers bit for bit."""
    plain = _cli(TRAIN, capsys)
    meshed = _cli(TRAIN + ["--dp", "1", "--tp", "1"], capsys)
    drop = ("seconds", "samples_per_sec")
    assert ([{k: v for k, v in r.items() if k not in drop} for r in plain]
            == [{k: v for k, v in r.items() if k not in drop} for r in meshed])


def test_cli_impl_cp_at_world_size_one(capsys):
    """--impl cp at world size 1 (JAX's degenerate one-device CP) trains
    as the plain attention does, to f32 rounding."""
    plain = _cli(TRAIN, capsys)
    cp = _cli(TRAIN + ["--impl", "cp"], capsys)
    for a, b in zip(plain, cp):
        if "train_loss" in a:
            np.testing.assert_allclose(b["train_loss"], a["train_loss"],
                                       rtol=1e-5)
            np.testing.assert_allclose(b["valid_loss"], a["valid_loss"],
                                       rtol=1e-5)


def test_cli_predict_dp_one_equals_plain(tmp_path):
    base = ["predict", "mosei_trans", "--device", "cpu", "--init-random",
            "--n-test", "8", "--quiet", "--set", "train.batch_size=4"] + [
        a for k, v in TINY.items() for a in ("--set", f"model.{k}={v}")]
    cli.main(base + ["-o", str(tmp_path / "a.jsonl")])
    cli.main(base + ["-o", str(tmp_path / "b.jsonl"), "--dp", "1"])
    assert ((tmp_path / "a.jsonl").read_text()
            == (tmp_path / "b.jsonl").read_text())


@pytest.mark.parametrize("flags,ranks_needed", [(["--dp", "2"], 2),
                                                (["--dp", "2", "--tp", "2"], 4),
                                                (["--tp", "3"], 3)])
def test_cli_refuses_a_world_that_does_not_match(flags, ranks_needed,
                                                 monkeypatch):
    """A --dp x --tp that is not the world's rank count fails before any
    work, naming the torchrun line to launch it with."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as e:
        cli.main(TRAIN + flags)
    assert (f"torchrun --nproc-per-node {ranks_needed} -m "
            "multimodal_emotion_processing_tpu_torch train" in str(e.value))
    assert not torch.distributed.is_initialized()
