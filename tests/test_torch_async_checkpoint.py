"""PyTorch port, asynchronous checkpoints (`CheckpointStore(use_async=True)`,
`run_experiment(async_checkpoint=True)`, `cli train --async-checkpoint`):
an asynchronous store restores every bit of what it saved, also when the
model steps on while the write is in flight (on the CPU `state_dict()`
shares the live tensors); with the worker's write held back, a restart's
`restore_last` returns the previous complete resume point and its
restores of a best member the previous best, and after the write lands
the newest; a failed write raises at `wait()`; the k-fold
experiment gives the same members and report as the synchronous run and
records the option in its run meta.  Tiny `rencecps` and `mosei_trans` on
the CPU."""

import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch import configs, pipelines  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny models run op by op: with several test processes on one
    host, PyTorch's default of one intra-op thread per core oversubscribes
    it and the tests slow tenfold.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp():
    exp = configs.get("rencecps")
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, dim=16),
        train=dataclasses.replace(exp.train, batch_size=8))


def _state(exp, seed):
    return engine.init_state(exp, exp.train, seed=seed, device="cpu")


def _batch(exp):
    samples = synthetic_dataset("rencecps", exp.model, 8, seed=0)
    return to_device(next(iter(Batcher(samples, 8)())), "cpu")


def _snapshot(state):
    sd = state.state_dict()
    return {"model": {k: v.clone() for k, v in sd["model"].items()},
            "mu": [t.clone() for t in sd["optimizer"]["mu"]],
            "step": sd["step"], "generator": sd["generator"].clone()}


def _assert_state_is(state, snap):
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snap["model"][k]), k
    for a, b in zip(state.optimizer.mu, snap["mu"]):
        assert torch.equal(a, b)
    assert state.step == snap["step"]
    assert torch.equal(state.generator.get_state(), snap["generator"])


class _HeldWrites:
    """Holds the store's file writes until `release()`."""

    def __init__(self, monkeypatch):
        self.gate = threading.Event()
        save = CheckpointStore._save

        def held(path, obj):
            self.gate.wait(timeout=60)
            save(path, obj)

        monkeypatch.setattr(CheckpointStore, "_save", staticmethod(held))

    def release(self):
        self.gate.set()


def test_async_store_restores_bit_equal_while_the_model_steps_on(
        tmp_path, monkeypatch):
    exp = _exp()
    batch = _batch(exp)
    state = _state(exp, 3)
    engine.train_step(state, exp.train, batch)
    snap = _snapshot(state)
    held = _HeldWrites(monkeypatch)
    store = CheckpointStore(str(tmp_path), use_async=True)
    store.save_best("m", state, epoch=0, valid_loss=1.5)
    for _ in range(2):   # the live tensors change under the write in flight
        engine.train_step(state, exp.train, batch)
    held.release()
    _assert_state_is(store.restore_state("m", _state(exp, 9)), snap)
    params = store.restore_params("m")
    for k, v in params.items():
        assert torch.equal(v, snap["model"][k]), k
    snap2 = _snapshot(state)
    store.save_last("m", state, 1, {"tag": 1})
    restored, entry = store.restore_last("m", _state(exp, 9))
    assert entry["epoch"] == 1 and entry["schedule"] == {"tag": 1}
    _assert_state_is(restored, snap2)
    assert json.load(open(tmp_path / "manifest.json"))["m"]["epoch"] == 0


def test_held_write_falls_back_to_the_previous_point(tmp_path, monkeypatch):
    """A restart while the newest save is still in flight (a crash before
    its file landed) resumes from the previous complete slot."""
    exp = _exp()
    root = str(tmp_path / "ck")
    store = CheckpointStore(root, use_async=True)
    s0, s1 = _state(exp, 0), _state(exp, 1)
    snap0, snap1 = _snapshot(s0), _snapshot(s1)
    store.save_last("m_1", s0, 0, {"tag": 0})
    store.wait()
    held = _HeldWrites(monkeypatch)
    store.save_last("m_1", s1, 1, {"tag": 1})
    state, entry = CheckpointStore(root).restore_last("m_1", _state(exp, 7))
    assert entry["epoch"] == 0 and entry["schedule"] == {"tag": 0}
    _assert_state_is(state, snap0)
    held.release()
    store.wait()
    state, entry = CheckpointStore(root).restore_last("m_1", _state(exp, 7))
    assert entry["epoch"] == 1
    _assert_state_is(state, snap1)


def test_held_best_leaves_the_previous_best(tmp_path, monkeypatch):
    """A restart while a new best is still in flight (a cut between the
    save's return and its write) restores the previous complete best, and
    the manifest names its epoch; once the write lands, the new one."""
    exp = _exp()
    root = str(tmp_path / "ck")
    store = CheckpointStore(root, use_async=True)
    s0, s1 = _state(exp, 0), _state(exp, 1)
    snap0, snap1 = _snapshot(s0), _snapshot(s1)
    store.save_best("m_1", s0, epoch=0, valid_loss=2.0)
    store.wait()
    held = _HeldWrites(monkeypatch)
    store.save_best("m_1", s1, epoch=3, valid_loss=1.0)
    restart = CheckpointStore(root)
    assert restart.manifest["m_1"]["epoch"] == 0
    assert restart.manifest["m_1"]["valid_loss"] == 2.0
    _assert_state_is(restart.restore_state("m_1", _state(exp, 7)), snap0)
    for k, v in restart.restore_params("m_1").items():
        assert torch.equal(v, snap0["model"][k]), k
    held.release()
    store.wait()
    restart = CheckpointStore(root)
    assert restart.manifest["m_1"]["epoch"] == 3
    _assert_state_is(restart.restore_state("m_1", _state(exp, 7)), snap1)


def test_a_resume_point_does_not_wait_for_a_best_in_flight(
        tmp_path, monkeypatch):
    """save_last joins only the resume point in flight: with a best's write
    held, it returns, and both land in order once the writes run."""
    exp = _exp()
    store = CheckpointStore(str(tmp_path), use_async=True)
    state = _state(exp, 2)
    snap = _snapshot(state)
    held = _HeldWrites(monkeypatch)
    store.save_best("m", state, epoch=0, valid_loss=1.0)
    store.save_last("m", state, 0)          # returns with the best held
    assert set(store._pending) == {"best", "last"}
    held.release()
    _assert_state_is(store.restore_last("m", _state(exp, 9))[0], snap)
    _assert_state_is(store.restore_state("m", _state(exp, 9)), snap)


def test_failed_write_raises_at_wait(tmp_path, monkeypatch):
    exp = _exp()
    store = CheckpointStore(str(tmp_path), use_async=True)

    def broken(path, obj):
        raise OSError("disk full")

    monkeypatch.setattr(CheckpointStore, "_save", staticmethod(broken))
    store.save_last("m", _state(exp, 0), 0)
    with pytest.raises(OSError, match="disk full"):
        store.wait()
    store.wait()   # reported once


TINY = {"model": dict(l_len=4, v_len=6, a_len=8, dim=12, n_heads=2, l_dim=5,
                      v_dim=4, a_dim=3),
        "train": dict(n_folds=2, batch_size=8)}


def test_run_experiment_async_equals_sync(tmp_path):
    runs = {}
    for mode in (False, True):
        runs[mode] = pipelines.run_experiment(
            "mosei_trans", n_train=32, n_test=8, epochs=1, quiet=True,
            overrides=TINY, checkpoint_dir=str(tmp_path / str(mode)),
            async_checkpoint=mode, device="cpu")
    sync, asyn = runs[False], runs[True]
    np.testing.assert_array_equal(asyn.logits, sync.logits)
    assert asyn.report == sync.report
    for name in sync.store.best_members("mosei_trans"):
        a = asyn.store.restore_params(name)
        for k, v in sync.store.restore_params(name).items():
            assert torch.equal(a[k], v), (name, k)
        assert (asyn.store.manifest[name]["epoch"]
                == sync.store.manifest[name]["epoch"])
    meta = json.load(open(tmp_path / "True" / "run_meta.json"))
    assert meta["drivers"]["async_checkpoint"] is True
    assert meta["drivers"]["transfer_dtype"] is None


def test_cli_train_async_checkpoint_and_resume(tmp_path, capsys):
    """`cli train --async-checkpoint --transfer-dtype float16` runs, and a
    resume from its store skips the finished members."""
    ck = str(tmp_path / "ck")
    args = ["train", "mosei_trans", "--device", "cpu", "--epochs", "1",
            "--n-train", "32", "--n-test", "8", "--checkpoint-dir", ck,
            "--async-checkpoint", "--transfer-dtype", "float16", "--quiet",
            "--set", "train.n_folds=2", "--set", "train.batch_size=8"] + [
            f"--set=model.{k}={v}" for k, v in TINY["model"].items()]
    first = main(args)
    meta = json.load(open(tmp_path / "ck" / "run_meta.json"))
    assert meta["drivers"]["transfer_dtype"] == "float16"
    again = main(args + ["--resume"])
    assert again.fold_histories == [[], []]
    np.testing.assert_array_equal(again.logits, first.logits)
    assert capsys.readouterr().out.count('"report"') == 2
