"""PyTorch port, k-fold bagging: `contiguous_folds` equal to the JAX
package's; `run_kfold` giving member i the same train and valid samples and
init seed as JAX's `run_kfold` (one shuffle, then carving; fold i % k, seed
tcfg.seed + i); the first k members of a `seeds_per_fold` run those of a
plain run; a resumed run bit-equal to an uninterrupted one
(tests/test_train_eval.py:244-264); and `RunLogger`'s CSV as JAX's writes
it."""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu.train import kfold as jkfold  # noqa: E402
from multimodal_emotion_processing_tpu.utils import logging as jlogging  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine, kfold  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402
from multimodal_emotion_processing_tpu_torch.utils.logging import RunLogger  # noqa: E402


def tiny_exp(**train):
    exp = configs.get("rencecps")
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, dim=16),
        train=dataclasses.replace(exp.train, batch_size=8, **train))


@pytest.mark.parametrize("n,k,fold_size", [
    (100, 4, None), (101, 4, None), (7, 3, None), (12, 5, None),
    (20000, 4, 4096), (512, 4, 4096), (100, 2, 40), (3000, 4, 744),
    (10, 10, None), (5, 1, None)])
def test_contiguous_folds_equal_jax(n, k, fold_size):
    got = kfold.contiguous_folds(n, k, fold_size)
    want = jkfold.contiguous_folds(n, k, fold_size)
    assert got == want
    # the fractional carving validates every sample exactly once
    if fold_size is None or fold_size * k > n:
        assert sorted(j for sl, _ in got for j in range(sl.start, sl.stop)) \
            == list(range(n))


def test_run_kfold_carves_and_seeds_as_jax(monkeypatch):
    """With epochs=0 nothing trains: both drivers hand each member's train
    and valid samples to make_loaders and build its state from its seed;
    the samples (by index) and seeds must be the same."""
    exp = tiny_exp(n_folds=3, seed=5)
    samples = [{"idx": np.asarray(i)} for i in range(23)]
    seen, jseen = [], []

    def loaders(log):
        def make(train, valid):
            log.append(([int(s["idx"]) for s in train],
                        [int(s["idx"]) for s in valid]))
            return (lambda: iter(()), lambda: iter(()))
        return make

    seeds, jseeds = [], []
    init = engine.init_state
    monkeypatch.setattr(engine, "init_state", lambda cfg, tcfg, seed, **kw: (
        seeds.append(seed), init(cfg, tcfg, seed, **kw))[1])
    jinit = jeng.init_state
    monkeypatch.setattr(jeng, "init_state", lambda model, tx, seed, **kw: (
        jseeds.append(seed), jinit(model, tx, seed, **kw))[1])
    jexp = dataclasses.replace(
        jconfigs.get("rencecps"),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))
    kfold.run_kfold(samples, loaders(seen), exp, exp.train, epochs=0,
                    seeds_per_fold=2, shuffle_seed=3, device="cpu")
    jkfold.run_kfold(samples, loaders(jseen), jbuild(jexp), jexp.train,
                     epochs=0, seeds_per_fold=2, shuffle_seed=3)
    assert seen == jseen and len(seen) == 6
    assert seeds == jseeds == [5, 6, 7, 8, 9, 10]
    assert seen[0] == seen[3] and seen[0] != seen[1]   # member i on fold i % k
    with pytest.raises(ValueError, match="seeds_per_fold"):
        kfold.run_kfold(samples, loaders([]), exp, exp.train, epochs=0,
                        seeds_per_fold=0, device="cpu")


class Preempted(Exception):
    """Cuts a run as a preemption would."""


def _run(tmp_path, sub, *, epochs, resume=False, crash_at=None,
         seeds_per_fold=1):
    """crash_at=(member, epoch): log_cb raises there, as a preemption
    during that epoch would: its resume point is not yet saved."""
    exp = tiny_exp(n_folds=2, epochs=99)
    samples = synthetic_dataset("rencecps", exp.model, 32, seed=0)
    store = CheckpointStore(str(tmp_path / sub))
    losses = {}

    def log_cb(name, epoch, stats):
        if crash_at is not None and (name, epoch) == crash_at:
            raise Preempted(f"{name} epoch {epoch}")
        losses.setdefault(name, []).append((stats.train_loss, stats.valid_loss))

    def make_loaders(train, valid):
        return (Batcher(train, exp.train.batch_size, shuffle=False),
                Batcher(valid, exp.train.batch_size, shuffle=False))

    results = kfold.run_kfold(samples, make_loaders, exp, exp.train,
                              store=store, name_prefix="m", epochs=epochs,
                              resume=resume, log_cb=log_cb, device="cpu",
                              seeds_per_fold=seeds_per_fold)
    return results, store, losses


def _assert_models_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


def test_kfold_resume_matches_uninterrupted(tmp_path):
    """A run cut during member 1's epoch 2 and resumed equals the
    uninterrupted run bit for bit: member 1 runs epochs 2-3 only, member 2
    all four, with the same losses and final parameters (parameters,
    optimizer, dropout generator, LR and counters restored; shuffling off,
    so the data order aligns)."""
    full, _, full_losses = _run(tmp_path, "full", epochs=4)
    with pytest.raises(Preempted):
        _run(tmp_path, "cut", epochs=4, crash_at=("m_1", 2))
    resumed, store, res_losses = _run(tmp_path, "cut", epochs=4, resume=True)
    assert len(res_losses["m_1"]) == 2 and len(res_losses["m_2"]) == 4
    assert res_losses["m_1"] == full_losses["m_1"][2:]
    assert res_losses["m_2"] == full_losses["m_2"]
    for (s_full, _), (s_res, _) in zip(full, resumed):
        _assert_models_equal(s_full.model, s_res.model)
        assert s_full.step == s_res.step
    assert store.is_done("m_1") and store.is_done("m_2")


def test_seeds_per_fold_extends_the_ensemble(tmp_path):
    """Members 1-2 of a seeds_per_fold=2 run are those of a plain run;
    members 3-4 train the same folds from seeds 2 and 3."""
    plain, _, plain_losses = _run(tmp_path, "a", epochs=1)
    wide, store, wide_losses = _run(tmp_path, "b", epochs=1, seeds_per_fold=2)
    assert store.best_members("m") == ["m_1", "m_2", "m_3", "m_4"]
    for (a, _), (b, _) in zip(plain, wide[:2]):
        _assert_models_equal(a.model, b.model)
    assert [wide_losses[f"m_{i}"] for i in (1, 2)] == [
        plain_losses[f"m_{i}"] for i in (1, 2)]
    assert wide_losses["m_3"] != wide_losses["m_1"]


def test_run_logger_csv_equal_jax(tmp_path, monkeypatch):
    """The same CSV as JAX's RunLogger; without an importable TensorBoard
    writer the CSV is the whole log."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    stats = [engine.EpochStats(train_loss=1.25, valid_loss=0.5, steps=3,
                               samples=24, seconds=0.5),
             engine.EpochStats(train_loss=1.0, valid_loss=0.25, steps=3,
                               samples=24, seconds=0.25)]
    log = RunLogger(str(tmp_path / "a"), "m_1")
    jlog = jlogging.RunLogger(str(tmp_path / "b"), "m_1", tensorboard=False)
    for e, s in enumerate(stats):
        log.log_epoch(e, s)
        jlog.log_epoch(e, s)
    log.close()
    jlog.close()
    assert log._tb is None
    text = (tmp_path / "a" / "m_1.csv").read_text()
    assert text == (tmp_path / "b" / "m_1.csv").read_text()
    assert text.splitlines() == ["epoch,train_loss,valid_loss,samples_per_sec",
                                 "1,1.250000,0.500000,48.00",
                                 "2,1.000000,0.250000,96.00"]
