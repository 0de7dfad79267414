"""PyTorch port, checkpoints: `train.checkpoint.CheckpointStore` with the
JAX store's behaviours (tests/test_train_eval.py): the full-state
roundtrip and a restored state that steps identically, the crash-window
fallback of the alternating resume slots and the surviving slot kept after
it, a structural mismatch raising, eval-only runs not marking members done,
done members skipped, `best_members`' numeric order and exact suffix, the
manifest's keys, and `Trainer.fit`'s resume arguments.  Tiny `rencecps`
(dim 16, dropout 0.1, so the dropout generator's state is part of what
must survive a restore) on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine, schedule  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.kfold import run_kfold  # noqa: E402


def tiny_exp(name="rencecps", **train):
    exp = configs.get(name)
    m = exp.model
    if name == "rencecps":
        m = dataclasses.replace(m, dim=16)
    else:
        m = dataclasses.replace(m, l_len=4, v_len=6, a_len=8, dim=12, n_heads=2,
                                l_dim=5, v_dim=4, a_dim=3, p_len=3)
    return dataclasses.replace(exp, model=m, train=dataclasses.replace(
        exp.train, batch_size=8, **train))


def _state(exp, seed):
    return engine.init_state(exp, exp.train, seed=seed, device="cpu")


def _batch(exp, seed=0):
    samples = synthetic_dataset("rencecps", exp.model, 8, seed=seed)
    return to_device(next(iter(Batcher(samples, 8)())), "cpu")


def _assert_same_state(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    for key in ("mu", "nu"):
        for x, y in zip(getattr(a.optimizer, key), getattr(b.optimizer, key)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (a.optimizer.count, a.optimizer.lr, a.step) == (
        b.optimizer.count, b.optimizer.lr, b.step)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_checkpoint_full_state_roundtrip(tmp_path):
    """save_best writes the parameters and the full state; restore_state
    brings back every bit, and the restored state steps (dropout masks
    included) exactly as the original does."""
    exp = tiny_exp()
    state = _state(exp, 3)
    batch = _batch(exp)
    engine.train_step(state, exp.train, batch)
    engine.set_learning_rate(state, 3e-4)
    store = CheckpointStore(str(tmp_path))
    store.save_best("m", state, epoch=0, valid_loss=1.23)

    restored = store.restore_state("m", _state(exp, 99))
    _assert_same_state(state, restored)
    assert restored.step == 1 and restored.optimizer.lr == 3e-4
    l1 = engine.train_step(state, exp.train, batch)
    l2 = engine.train_step(restored, exp.train, batch)
    assert float(l1) == float(l2)
    _assert_same_state(state, restored)

    # params.pt is a plain state dict under the model's own key names
    sd = torch.load(store.manifest["m"]["params"], weights_only=True)
    model = build_model(exp, device="cpu", seed=5)
    model.load_state_dict(sd)
    assert store.restore_params("m")["trans"].shape == sd["trans"].shape
    fresh = store.restore_params("m", build_model(exp, device="cpu", seed=6))
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    entry = json.load(open(tmp_path / "manifest.json"))["m"]
    assert set(entry) == {"params", "full", "valid_loss", "epoch"}
    assert entry["valid_loss"] == 1.23 and entry["epoch"] == 0


def test_save_last_crash_window_falls_back(tmp_path):
    """A cut that loses the newest resume slot falls back to the previous
    epoch's: save_last alternates last_a/last_b and keeps the prior
    manifest entry."""
    exp = tiny_exp()
    store = CheckpointStore(str(tmp_path / "ck"))
    s0, s1 = _state(exp, 0), _state(exp, 1)
    store.save_last("m_1", s0, 0, {"tag": 0})
    store.save_last("m_1", s1, 1, {"tag": 1})
    a = store.manifest["m_1"]["last_prev"]["path"]
    b = store.manifest["m_1"]["last"]["path"]
    assert a != b and a.endswith("last_a.pt") and b.endswith("last_b.pt")
    state, entry = store.restore_last("m_1", _state(exp, 7))
    assert entry["epoch"] == 1
    _assert_same_state(state, s1)
    os.remove(b)                     # the newest save lost mid-write
    state, entry = CheckpointStore(str(tmp_path / "ck")).restore_last(
        "m_1", _state(exp, 7))
    assert entry["epoch"] == 0 and entry["schedule"] == {"tag": 0}
    _assert_same_state(state, s0)


def test_save_last_after_fallback_preserves_surviving_slot(tmp_path):
    """After a fallback, the next save_last overwrites the broken slot, not
    the surviving one, so a second cut still leaves a resume point."""
    exp = tiny_exp()
    store = CheckpointStore(str(tmp_path / "ck"))
    states = [_state(exp, i) for i in range(3)]
    store.save_last("m_1", states[0], 0)
    store.save_last("m_1", states[1], 1)
    surviving = store.manifest["m_1"]["last_prev"]["path"]   # epoch 0
    os.remove(store.manifest["m_1"]["last"]["path"])
    store.save_last("m_1", states[2], 2)
    assert store.manifest["m_1"]["last"]["epoch"] == 2
    assert store.manifest["m_1"]["last_prev"]["path"] == surviving
    assert store.manifest["m_1"]["last_prev"]["epoch"] == 0
    assert os.path.isfile(surviving)
    os.remove(store.manifest["m_1"]["last"]["path"])
    state, entry = store.restore_last("m_1", _state(exp, 9))
    assert entry["epoch"] == 0
    _assert_same_state(state, states[0])
    # no leftover temporary files: every save was moved into place
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs
                if f.endswith(".tmp")]


def test_restore_last_surfaces_structural_mismatch(tmp_path):
    """A complete resume point that does not fit the state (another model
    family, or another width) raises instead of silently retraining."""
    store = CheckpointStore(str(tmp_path / "ck"))
    exp = tiny_exp()
    store.save_last("m_1", _state(exp, 0), 0)
    with pytest.raises(RuntimeError):
        store.restore_last("m_1", _state(tiny_exp("ren_mme"), 0))
    wider = dataclasses.replace(exp, model=dataclasses.replace(exp.model, dim=24))
    with pytest.raises(RuntimeError):
        store.restore_last("m_1", _state(wider, 0))
    assert store.restore_last("m_2", _state(exp, 0)) is None
    opt = _state(exp, 0).optimizer
    with pytest.raises(ValueError, match="tensors"):
        opt.load_state_dict({**opt.state_dict(), "mu": opt.mu[:-1]})


def test_best_members_exact_name_matching(tmp_path):
    """best_members lists `<prefix>_<int>` in numeric order and nothing
    else: not a sweep winner, not a scale preset's members, not an entry
    without parameters; save_params drops an earlier member's train-state
    keys."""
    exp = tiny_exp()
    store = CheckpointStore(str(tmp_path))
    model = build_model(exp, device="cpu")
    for name in ("mosei_trans_10", "mosei_trans_2", "mosei_trans_1",
                 "mosei_trans_sweep_winner", "mosei_trans_s256_1",
                 "mosei_trans_3x"):
        store.save_params(name, model)
    store.mark_done("mosei_trans_4")            # no params: not a member
    assert store.best_members("mosei_trans") == [
        "mosei_trans_1", "mosei_trans_2", "mosei_trans_10"]
    assert store.best_members("mosei_trans_s256") == ["mosei_trans_s256_1"]
    assert store.best_members() == sorted(
        n for n in store.manifest if n != "mosei_trans_4")
    state = _state(exp, 0)
    store.save_best("r_1", state, 2, 0.5)
    store.save_last("r_1", state, 2)
    store.mark_done("r_1")
    store.save_params("r_1", state.model.state_dict(), valid_loss=0.4,
                      epoch=3, imported=False)
    assert set(store.manifest["r_1"]) == {"params", "valid_loss", "epoch"}
    assert store.manifest["mosei_trans_1"]["imported"] is True


def _kfold_run(tmp_path, sub, *, epochs, resume=False, n=32):
    exp = tiny_exp(n_folds=2, epochs=99)
    samples = synthetic_dataset("rencecps", exp.model, n, seed=0)
    store = CheckpointStore(str(tmp_path / sub))
    losses = {}

    def log_cb(name, epoch, stats):
        losses.setdefault(name, []).append((stats.train_loss, stats.valid_loss))

    def make_loaders(train, valid):
        return (Batcher(train, exp.train.batch_size, shuffle=False),
                Batcher(valid, exp.train.batch_size, shuffle=False))

    results = run_kfold(samples, make_loaders, exp, exp.train, store=store,
                        name_prefix="m", epochs=epochs, resume=resume,
                        log_cb=log_cb, device="cpu")
    return results, store, losses


def test_kfold_resume_skips_done_folds(tmp_path):
    _, store, _ = _kfold_run(tmp_path, "ck", epochs=2)
    assert store.is_done("m_1") and store.is_done("m_2")
    resumed, store2, losses = _kfold_run(tmp_path, "ck", epochs=2, resume=True)
    assert all(state is None and hist == [] for state, hist in resumed)
    assert losses == {}
    assert store2.best_members("m") == ["m_1", "m_2"]


def test_eval_only_does_not_mark_done(tmp_path):
    """epochs=0 (the eval command) must not mark members trained: a later
    resume would skip their training."""
    _, store, losses = _kfold_run(tmp_path, "ck0", epochs=0)
    assert not store.is_done("m_1") and not store.is_done("m_2")
    assert losses == {}


def test_resume_does_not_train_past_fired_stop():
    """A restored stopper that already fired makes fit a no-op; a fresh one
    with patience 0 still trains."""
    exp = tiny_exp()
    trainer = engine.Trainer(exp, exp.train, device="cpu")
    samples = synthetic_dataset("rencecps", exp.model, 16, seed=0)
    loader = Batcher(samples, 8, shuffle=False)
    fired = schedule.EarlyStop(patience=2, bad=2, best=0.5)
    state, hist = trainer.fit(loader, loader, epochs=5, start_epoch=3,
                              stopper=fired)
    assert hist == [] and state.step == 0
    zero = engine.Trainer(exp, dataclasses.replace(exp.train, early_stop=0),
                          device="cpu")
    _, hist = zero.fit(loader, loader, epochs=5)
    assert len(hist) >= 1


def test_fit_resumes_from_start_epoch_with_its_schedule():
    """fit(start_epoch=s) runs epochs s..E-1 only, steps the injected
    plateau and stopper, and calls last_cb after each epoch with them."""
    exp = tiny_exp()
    trainer = engine.Trainer(exp, exp.train, device="cpu")
    samples = synthetic_dataset("rencecps", exp.model, 16, seed=0)
    loader = Batcher(samples, 8, shuffle=False)
    plateau = schedule.PlateauState(lr=1e-3, factor=0.5, patience=0,
                                    best=-1.0)
    stopper = schedule.EarlyStop(patience=9, best=-1.0)
    calls = []
    state, hist = trainer.fit(
        loader, loader, epochs=4, start_epoch=2, plateau=plateau,
        stopper=stopper,
        last_cb=lambda s, e, p, st: calls.append((e, p.lr, st.bad)))
    assert len(hist) == 2 and state.step == 4
    # every epoch is worse than best=-1: the LR halves each time
    assert calls == [(2, 5e-4, 1), (3, 2.5e-4, 2)]
    assert state.optimizer.lr == 2.5e-4
    assert np.isfinite([h.train_loss for h in hist]).all()
