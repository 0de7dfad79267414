"""PyTorch port, training: the port's train step against the JAX package's
`make_train_step` from the same weights (carried over by `from_jax_params`)
and the same numpy batches, losses and parameters after the steps at 2e-4
in f32 (tests/test_interop.py:20) and 5e-2 for a bf16 step
(tests/test_flash.py:90); the Trainer, the Batcher and the schedule against
their JAX counterparts; and `cli train` on the CPU."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.data import loader as jloader  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu.train import schedule as jschedule  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine, schedule  # noqa: E402

F32_TOL = 2e-4
BF16_TOL = 5e-2
TINY = dict(l_len=4, v_len=9, a_len=20, dim=12, n_heads=2, l_dim=7, v_dim=3,
            a_dim=5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny models run op by op: with several test processes on one
    host, PyTorch's default of one intra-op thread per core oversubscribes
    it and the tests slow tenfold.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(**train):
    exp = configs.get("mosei_trans")
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **TINY),
        train=dataclasses.replace(exp.train, **train))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))


def _batch(m, b=4, seed=0, no_name=True, n_real=None):
    """A numpy batch with ragged masks (every row's first key valid), a
    no_name (all-zero) previous slot in row 0 when asked for, and, with
    n_real, zero padding rows past it and a sample_weight."""
    rng = np.random.default_rng(seed)
    batch = {}
    for kind, length, dim in (("l", m.l_len, m.l_dim), ("v", m.v_len, m.v_dim),
                              ("a", m.a_len, m.a_dim)):
        batch[kind] = rng.standard_normal((b, 2, length, dim)).astype(np.float32)
        mask = (rng.random((b, 2, length)) > 0.3).astype(np.float32)
        mask[..., 0] = 1.0
        if no_name:
            mask[0, 0] = 0.0
            batch[kind][0, 0] = 0.0
        batch[kind + "_mask"] = mask
    batch["label"] = (rng.random((b, m.n_emotions)) > 0.6).astype(np.int32)
    if n_real is not None:
        for k in batch:
            batch[k][n_real:] = 0
        batch["sample_weight"] = (np.arange(b) < n_real).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


def _spread_ln_biases(params, seed):
    """LayerNorm biases at distinct random values.  In a no_name slot every
    block's output is its LN bias (its input is all zero), so the pooled
    max compares biases of different blocks; at their init of 0, and at the
    ±lr that the first Adam step moves them to, these tie exactly, and which
    block wins a tie then rests on the last ulp of each framework's
    optimizer arithmetic.  Spread apart, every tie left is within one block,
    where both sides route to the first row (tested in
    test_torch_attention.py)."""
    rng = np.random.default_rng(seed)

    def spread(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        if "norm" in names and names[-1] == "bias":
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(spread, params)


def _pair(exp, impl, seed=0):
    """The JAX step and state, and the port's state with the same weights."""
    jexp = _jexp(exp)
    jmodel = jbuild(jexp)
    tx, jstep = jeng.make_train_step(jmodel, jexp.train, impl=impl,
                                     donate=False)
    jstate = jeng.init_state(jmodel, tx, seed)
    jstate = dataclasses.replace(
        jstate, params=_spread_ln_biases(jstate.params, seed))
    state = engine.init_state(exp, exp.train, seed=99, device="cpu")
    state.model.load_state_dict(from_jax_params(jax.device_get(jstate.params),
                                                exp.model))
    return jstep, jstate, state


def _assert_params_close(state, jstate, exp, tol):
    ref = from_jax_params(jax.device_get(jstate.params), exp.model)
    got = state.model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], tol, k)


@pytest.mark.parametrize("impl,no_name", [("xla", True), ("flash", False)])
def test_three_steps_match_jax(impl, no_name):
    """Flash batches carry no no_name rows: the JAX wrapper pads kv, and its
    fully masked rows then differ (ROADMAP §3); those are held against JAX
    `xla` in the next test."""
    exp = _exp()
    jstep, jstate, state = _pair(exp, impl)
    for i in range(3):
        batch = _batch(exp.model, seed=10 + i, no_name=no_name)
        jstate, jloss = jstep(jstate, batch)
        loss = engine.train_step(state, exp.train, _tensors(batch), impl=impl)
        _close(loss, jloss, F32_TOL, f"loss {i}")
    assert state.step == 3
    _assert_params_close(state, jstate, exp, F32_TOL)


def test_flash_steps_with_no_name_rows_match_jax_xla():
    exp = _exp()
    before = [k.launches for k in tfa.KERNELS]
    jstep, jstate, state = _pair(exp, "xla", seed=1)
    for i in range(3):
        batch = _batch(exp.model, seed=20 + i, no_name=True)
        jstate, jloss = jstep(jstate, batch)
        loss = engine.train_step(state, exp.train, _tensors(batch), impl="flash")
        _close(loss, jloss, F32_TOL, f"loss {i}")
    _assert_params_close(state, jstate, exp, F32_TOL)
    assert [k.launches for k in tfa.KERNELS] == before    # CPU: plain versions


def test_padded_final_batch_matches_jax():
    exp = _exp()
    jstep, jstate, state = _pair(exp, "xla", seed=2)
    batch = _batch(exp.model, b=6, seed=30, n_real=4)
    jstate, jloss = jstep(jstate, batch)
    loss = engine.train_step(state, exp.train, _tensors(batch))
    _close(loss, jloss, F32_TOL, "loss")
    _assert_params_close(state, jstate, exp, F32_TOL)
    # the padding rows change nothing: the same step on the 4 real rows
    _, _, twin = _pair(exp, "xla", seed=2)
    real = {k: v[:4] for k, v in batch.items() if k != "sample_weight"}
    twin_loss = engine.train_step(twin, exp.train, _tensors(real))
    _close(twin_loss, loss, 1e-6, "padded vs unpadded loss")


def test_bf16_step_matches_jax():
    exp = _exp(compute_dtype="bfloat16")
    jstep, jstate, state = _pair(exp, "xla", seed=3)
    batch = _batch(exp.model, seed=40)
    jstate, jloss = jstep(jstate, batch)
    loss = engine.train_step(state, exp.train, _tensors(batch), impl="flash")
    assert loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    _close(loss, jloss, BF16_TOL, "loss")
    _assert_params_close(state, jstate, exp, BF16_TOL)


@pytest.mark.parametrize("optimizer", ["adamw", "adam"])
def test_optimizer_matches_optax_on_a_large_gradient(optimizer):
    """Global-norm clip (‖g‖ far above 1) then Adam(W), two updates, against
    the JAX package's make_optimizer on the same leaves."""
    import optax

    tcfg = _exp(optimizer=optimizer, lr=0.01).train
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[50 * rng.standard_normal(x.shape).astype(np.float32)
              for x in leaves] for _ in range(2)]
    tx = jeng.make_optimizer(_jexp(_exp(optimizer=optimizer, lr=0.01)).train)
    jp = [jax.numpy.asarray(x) for x in leaves]
    jstate = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves]
    opt = engine.make_optimizer(tcfg, params)
    for g in grads:
        upd, jstate = tx.update([jax.numpy.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        assert all(p.grad is None for p in params)
    for p, ref in zip(params, jp):
        _close(p.detach(), ref, 1e-6)


def test_trainer_fit_matches_jax_trainer():
    """Two epochs of Trainer.fit on synthetic data, the same Batchers on
    both sides: per-epoch losses, the real-sample count and the weights."""
    exp = _exp(batch_size=8)
    jexp = _jexp(exp)
    train = synthetic_dataset(exp.name, exp.model, 20, seed=0)
    valid = synthetic_dataset(exp.name, exp.model, 12, seed=1)
    jtr = jeng.Trainer(jbuild(jexp), jexp.train, prefetch=0)
    jstate0 = jeng.init_state(jbuild(jexp), jtr.tx, 0, fused=jtr.fused)
    jstate0 = dataclasses.replace(
        jstate0, params=_spread_ln_biases(jstate0.params, 0))
    tr = engine.Trainer(exp, exp.train, device="cpu")
    state = engine.init_state(exp, exp.train, seed=99, device="cpu")
    # before the JAX fit, which donates its state's buffers
    state.model.load_state_dict(from_jax_params(jax.device_get(jstate0.params),
                                                exp.model))
    jstate, jhist = jtr.fit(jloader.Batcher(train, 8, seed=1),
                            jloader.Batcher(valid, 8, shuffle=False),
                            state=jstate0, epochs=2)
    state, hist = tr.fit(loader.Batcher(train, 8, seed=1),
                         loader.Batcher(valid, 8, shuffle=False),
                         state=state, epochs=2)
    assert len(hist) == len(jhist) == 2
    for h, jh in zip(hist, jhist):
        assert (h.steps, h.samples) == (jh.steps, jh.samples) == (3, 20)
        assert len(h.step_losses) == 3
        _close(h.train_loss, jh.train_loss, F32_TOL, "train loss")
        _close(h.valid_loss, jh.valid_loss, F32_TOL, "valid loss")
    _assert_params_close(state, jstate, exp, F32_TOL)


def test_batcher_matches_jax():
    exp = _exp()
    samples = synthetic_dataset(exp.name, exp.model, 11, seed=4)
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False)):
        ours, theirs = loader.Batcher(samples, 4, **kw), jloader.Batcher(samples, 4, **kw)
        assert ours.steps_per_epoch() == theirs.steps_per_epoch() == 3
        for _ in range(2):                              # two epochs
            got, ref = list(ours()), list(theirs())
            assert len(got) == len(ref) == 3
            for a, b in zip(got, ref):
                assert list(a) == list(b)
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    last = list(loader.Batcher(samples, 4, shuffle=False)())[-1]
    np.testing.assert_array_equal(last["sample_weight"], [1, 1, 1, 0])
    assert not last["l"][3].any()


def test_schedule_matches_jax():
    rng = np.random.default_rng(5)
    losses = list(3.0 - np.cumsum(rng.random(40) * 0.05 - 0.02)) + [0.005, 0.004]
    ours = (schedule.PlateauState(lr=1e-3, patience=2),
            schedule.EarlyStop(patience=6, save_guard=0.009))
    theirs = (jschedule.PlateauState(lr=1e-3, patience=2),
              jschedule.EarlyStop(patience=6, save_guard=0.009))
    for x in losses:
        assert ours[0].step(x) == theirs[0].step(x)
        assert ours[1].step(x) == theirs[1].step(x)
    assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
    assert dataclasses.asdict(ours[1]) == dataclasses.asdict(theirs[1])


def test_training_with_dropout_raises(monkeypatch):
    """A train-mode forward with dropout > 0 and no generator raises; with
    the state's generator the step runs and draws a mask at each of the 36
    sites (two per minus block); eval draws nothing."""
    from multimodal_emotion_processing_tpu_torch.models import layers

    exp = _exp()
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                             dropout=0.1))
    state = engine.init_state(exp, exp.train, seed=0, device="cpu")
    batch = _tensors(_batch(exp.model))
    with pytest.raises(ValueError, match="dropout"):
        engine.batch_loss(state.model.train(), exp.train, batch)
    draws = []
    real = layers.keep_mask
    monkeypatch.setattr(layers, "keep_mask",
                        lambda *a: draws.append(a[0]) or real(*a))
    loss = engine.train_step(state, exp.train, batch)
    assert np.isfinite(float(loss)) and len(draws) == 2 * 18
    del draws[:]
    engine.eval_step(state.model, exp.train, batch)
    assert draws == []


def test_cli_train_on_cpu(capsys):
    from multimodal_emotion_processing_tpu_torch import cli

    # the k-fold experiment: two members, each trained on 10 of 20 samples
    res = cli.main(["train", "mosei_trans", "--device", "cpu",
                    "--epochs", "2", "--n-train", "20", "--n-test", "6",
                    "--impl", "flash", "--set", "model.dim=12",
                    "--set", "model.n_heads=2",
                    "--set", "train.batch_size=4", "--set", "train.n_folds=2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    epochs = [x for x in lines if "epoch" in x]
    assert [(x["member"], x["epoch"]) for x in epochs] == [
        ("mosei_trans_1", 0), ("mosei_trans_1", 1),
        ("mosei_trans_2", 0), ("mosei_trans_2", 1)]
    assert all(x["steps"] == 3 and x["samples"] == 10 for x in epochs)
    assert all(np.isfinite(x["train_loss"]) and np.isfinite(x["valid_loss"])
               for x in epochs)
    hist = res.fold_histories[1]
    assert epochs[3]["train_loss"] == pytest.approx(hist[1].train_loss)
    assert [sum(h.steps for h in h_) for h_ in res.fold_histories] == [6, 6]
    assert lines[-1] == {"report": res.report}
