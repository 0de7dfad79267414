"""PyTorch port, the k-fold members in lockstep (train/vmap_kfold.py) on
the CPU at tiny widths: host-fed, bit-equal to the port's sequential
`run_kfold` (members stopping at different epochs with dropout on, their
whole final state included) and with `scan_steps`; device-resident against
the JAX package's `run_kfold_vmapped(device_resident=True)` on JAX's
permutations (injected into `epoch_permutation`) from the same weights,
with per-fold early stop and `seeds_per_fold` (epoch losses 1e-3, best
parameters 2e-4; a stopped member's history ends at its stop, where JAX's
fold rides on); `run_kfold_fully_compiled` bit-equal to the device-resident
driver; a bit-equal resume; the guards (tp without a mesh raises, as in
JAX); and `run_experiment`'s driver fallbacks logging JAX's lines.  The
drivers on a mesh: tests/test_torch_lockstep_mesh.py."""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu import pipelines as jpipelines  # noqa: E402
from multimodal_emotion_processing_tpu.train import vmap_kfold as jvk  # noqa: E402
from multimodal_emotion_processing_tpu_torch import pipelines  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import kfold  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import vmap_kfold as vk  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402
from torch_driver_common import (EPOCH_TOL, TINY, assert_params_close,  # noqa: E402,F401
                                 assert_state_dicts_equal, exps,
                                 jax_model, jax_shuffle, one_intra_op_thread,
                                 rel, same_start)


def _loaders(bs, shuffle=True):
    def make(train, valid):
        return (Batcher(train, bs, seed=1, shuffle=shuffle),
                Batcher(valid, bs, shuffle=False))
    return make


def _epochs(hist):
    """A history without its wall times."""
    return [(e.train_loss, e.valid_loss, e.steps, e.samples, e.step_losses)
            for e in hist]


def _same_states(a, b):
    assert_state_dicts_equal(a.model.state_dict(), b.model.state_dict())
    for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                    b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    assert (a.optimizer.count, a.optimizer.lr, a.step) == (
        b.optimizer.count, b.optimizer.lr, b.step)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _ren_mme(**train):
    return exps("ren_mme", model={**TINY, "dim": 16, "dropout": 0.1},
                batch_size=4, n_folds=2, **train)[0]


def test_lockstep_host_fed_is_the_sequential_driver(tmp_path):
    """ren_mme at pallas_fused (dropout 0.1, R-Drop rows), 2 folds x 2
    seeds, early stop 1 over 4 epochs: every member's history, best
    checkpoint and whole final state (parameters, moments, count, LR, step,
    dropout generator) equal the sequential driver's bit for bit, the
    stopped members' included; scan_steps=3 equals scan_steps=1."""
    exp = _ren_mme(early_stop=1, epochs=4)
    samples = synthetic_dataset("ren_mme", exp.model, 24, seed=0)
    make = _loaders(exp.train.batch_size)
    s_store = CheckpointStore(str(tmp_path / "seq"))
    seq = kfold.run_kfold(samples, make, exp, exp.train, impl="pallas_fused",
                          device="cpu", seeds_per_fold=2, store=s_store,
                          name_prefix="m")
    l_store = CheckpointStore(str(tmp_path / "lock"))
    states, hists, best, losses = vk.run_kfold_vmapped(
        samples, make, exp, exp.train, impl="pallas_fused", device="cpu",
        seeds_per_fold=2, store=l_store, name_prefix="m")
    assert len({len(h) for h in hists}) > 1, "no member stopped early"
    for i, ((st, h), st2, h2) in enumerate(zip(seq, states, hists)):
        assert _epochs(h) == _epochs(h2), i
        _same_states(st, st2)
        name = f"m_{i + 1}"
        assert s_store.manifest[name]["epoch"] == l_store.manifest[name]["epoch"]
        assert_state_dicts_equal(best[i], s_store.restore_params(name))
        assert losses[i] == s_store.manifest[name]["valid_loss"]
        assert l_store.is_done(name)
    _, h3, b3, l3 = vk.run_kfold_vmapped(
        samples, make, exp, exp.train, impl="pallas_fused", device="cpu",
        seeds_per_fold=2, scan_steps=3)
    assert [_epochs(h) for h in h3] == [_epochs(h) for h in hists]
    assert l3 == losses
    for a, b in zip(b3, best):
        assert_state_dicts_equal(a, b)


def test_device_resident_matches_jax(jax_shuffle, same_start, tmp_path):
    """rencecps, 2 folds x 2 seeds, early stop 1 over 5 epochs, on JAX's
    shuffles from the same weights: each member's epochs up to its stop,
    its stop epoch, best loss and best parameters as JAX's driver gives
    them; the one-dispatch driver equals the device-resident one bit for
    bit, and with a store saves the guard-passed members params-only."""
    exp, jexp = exps("rencecps", batch_size=8, n_folds=2, early_stop=1)
    samples = synthetic_dataset("rencecps", exp.model, 44, seed=4)
    jmodel = jax_model(jexp, spread=False)
    same_start(jmodel)
    states, hists, best, losses = vk.run_kfold_vmapped(
        samples, None, exp, exp.train, epochs=5, device="cpu",
        device_resident=True, seeds_per_fold=2)
    _, jhists, jbest, jlosses = jvk.run_kfold_vmapped(
        samples, None, jmodel, jexp.train, epochs=5, device_resident=True,
        seeds_per_fold=2)
    assert len(hists) == 4 and hists[0][0].steps == 2
    for h, jh in zip(hists, jhists):
        assert 1 <= len(h) <= len(jh)
        for a, b in zip(h, jh):
            assert rel(a.train_loss, b.train_loss) <= EPOCH_TOL
            assert rel(a.valid_loss, b.valid_loss) <= EPOCH_TOL
    for i in range(4):
        assert rel(losses[i], jlosses[i]) <= EPOCH_TOL
        assert_params_close(best[i], jbest[i], exp)
    store = CheckpointStore(str(tmp_path))
    info = {}
    fstates, fhists, fbest, flosses = vk.run_kfold_fully_compiled(
        samples, exp, exp.train, epochs=5, device="cpu", seeds_per_fold=2,
        store=store, name_prefix="f", info=info)
    assert [[(e.train_loss, e.valid_loss) for e in h] for h in fhists] == [
        [(e.train_loss, e.valid_loss) for e in h] for h in hists]
    assert flosses == losses
    for a, b in zip(fbest, best):
        assert_state_dicts_equal(a, b)
    for a, b in zip(fstates, states):
        _same_states(a, b)
    assert store.best_members("f") == ["f_1", "f_2", "f_3", "f_4"]
    assert "full" not in store.manifest["f_1"]
    assert info["masked_epochs"] == 0
    assert info["staged_bytes"] > 0


class _Cut(Exception):
    pass


def _cut_at(epoch):
    def log_cb(name, e, stats):
        if e == epoch:
            raise _Cut
    return log_cb


def test_device_resident_resume_is_bit_equal(tmp_path):
    """Cut during epoch 3 of 4 (its members' resume points are epoch 2's)
    and resumed: the histories, best losses and parameters equal the
    uninterrupted run bit for bit; a finished run trains nothing on
    resume; a store of another member count raises."""
    exp = _ren_mme()
    samples = synthetic_dataset("ren_mme", exp.model, 24, seed=9)
    kw = dict(device="cpu", device_resident=True, impl="pallas_fused",
              duplicate=True, name_prefix="r")
    a = CheckpointStore(str(tmp_path / "a"))
    _, hA, bA, lA = vk.run_kfold_vmapped(samples, None, exp, exp.train,
                                         epochs=4, store=a, **kw)
    b = CheckpointStore(str(tmp_path / "b"))
    with pytest.raises(_Cut):
        vk.run_kfold_vmapped(samples, None, exp, exp.train, epochs=4,
                             store=b, log_cb=_cut_at(2), **kw)
    assert not b.is_done("r_1") and b.last_epochs("r_1")[0] == 1
    sB, hB, bB, lB = vk.run_kfold_vmapped(
        samples, None, exp, exp.train, epochs=4,
        store=CheckpointStore(str(tmp_path / "b")), resume=True, **kw)
    assert [[(e.train_loss, e.valid_loss) for e in h] for h in hB] == [
        [(e.train_loss, e.valid_loss) for e in h] for h in hA]
    assert lB == lA
    for x, y in zip(bA, bB):
        assert_state_dicts_equal(x, y)
    _, done, _, lD = vk.run_kfold_vmapped(
        samples, None, exp, exp.train, epochs=4,
        store=CheckpointStore(str(tmp_path / "b")), resume=True, **kw)
    assert done == [[], []] and lD == lA
    c = CheckpointStore(str(tmp_path / "c"))
    with pytest.raises(_Cut):
        vk.run_kfold_vmapped(samples, None, exp, exp.train, epochs=4,
                             store=c, log_cb=_cut_at(1), **kw)
    with pytest.raises(ValueError, match="members"):
        vk.run_kfold_vmapped(samples, None, exp, exp.train, epochs=4,
                             store=c, resume=True, seeds_per_fold=2, **kw)


def test_guards():
    exp, _ = exps("rencecps", batch_size=64, n_folds=2)
    samples = synthetic_dataset("rencecps", exp.model, 44, seed=4)
    with pytest.raises(ValueError, match="train samples per fold"):
        vk.run_kfold_vmapped(samples, None, exp, exp.train, epochs=1,
                             device="cpu", device_resident=True)
    with pytest.raises(ValueError, match="int8 wire composes"):
        vk.run_kfold_vmapped(samples, _loaders(64), exp, exp.train, epochs=1,
                             device="cpu", transfer_dtype="int8")
    # JAX's guard (train/vmap_kfold.py:238-239, 583-584): tp needs a mesh
    with pytest.raises(ValueError, match="tp=True requires a mesh"):
        vk.run_kfold_vmapped(samples, _loaders(64), exp, exp.train, epochs=1,
                             device="cpu", tp=True)
    with pytest.raises(ValueError, match="tp=True requires a mesh"):
        vk.run_kfold_fully_compiled(samples, exp, exp.train, epochs=1,
                                    device="cpu", tp=True)
    with pytest.raises(ValueError, match="misaligned"):
        vk.run_kfold_vmapped(samples[:43], _loaders(64), exp, exp.train,
                             epochs=1, device="cpu")


FALLBACK = re.compile(r"disabling|falling back|no-op|subsumes|disabled by|"
                      r"unequal contiguous")


def _fallback_lines(err):
    return [ln for ln in err.splitlines() if FALLBACK.search(ln)]


@pytest.mark.parametrize("case", [
    dict(n_train=25, device_resident=True),
    dict(n_train=12, one_dispatch=True),
    dict(n_train=32, one_dispatch=True, resume=True, transfer_dtype="int8"),
    dict(n_train=32, device_resident=True, scan_steps=2),
])
def test_run_experiment_fallbacks_log_jax_lines(case, tmp_path, capsys):
    """The same knobs (the lockstep asked for, JAX's default) log the same
    fallback lines in both frameworks (unequal folds, too few samples per
    fold, one_dispatch with resume, a host-fed int8 wire, scan_steps under
    device_resident), and run_meta records the drivers that ran."""
    kw = dict(n_test=8, epochs=1, vmap_folds=True, overrides={
        "model": {"dim": 16}, "train": {"batch_size": 8, "n_folds": 2}},
        **case)
    jpipelines.run_experiment("rencecps", checkpoint_dir=str(tmp_path / "j"),
                              **kw)
    jlines = _fallback_lines(capsys.readouterr().err)
    pipelines.run_experiment("rencecps", checkpoint_dir=str(tmp_path / "p"),
                             device="cpu", **kw)
    lines = _fallback_lines(capsys.readouterr().err)
    assert lines and lines == jlines
    meta = json.load(open(tmp_path / "p" / "run_meta.json"))
    assert set(meta["drivers"]) >= {"vmap_folds", "scan_steps",
                                    "device_resident", "one_dispatch",
                                    "accum_steps"}


@pytest.mark.parametrize("flags, drivers", [
    ([], {"vmap_folds": False, "device_resident": False,
          "one_dispatch": False}),
    (["--device-resident"], {"vmap_folds": True, "device_resident": True,
                             "one_dispatch": False}),
    (["--one-dispatch"], {"vmap_folds": True, "device_resident": True,
                          "one_dispatch": True}),
])
def test_cli_train_takes_the_lockstep_where_a_flag_needs_it(flags, drivers,
                                                            tmp_path):
    """`cli train` runs run_experiment's default, the sequential driver,
    and the members' lockstep under --device-resident and --one-dispatch
    (as JAX's CLI, whose default is the lockstep), as run_meta records."""
    from multimodal_emotion_processing_tpu_torch.cli import main

    main(["train", "rencecps", "--device", "cpu", "--epochs", "1",
          "--n-train", "32", "--n-test", "8", "--quiet", "--set",
          "model.dim=16", "--set", "train.batch_size=8", "--set",
          "train.n_folds=2", "--checkpoint-dir", str(tmp_path)] + flags)
    meta = json.load(open(tmp_path / "run_meta.json"))
    assert {k: meta["drivers"][k] for k in drivers} == drivers
