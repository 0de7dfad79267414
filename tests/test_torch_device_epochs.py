"""PyTorch port, device-resident epochs (train/device_epochs.py) against the
JAX package's on the CPU at tiny widths: staging and padding (the int8
wire's per-sample scales included), the eval epoch against JAX's per-batch
losses and the port's own host eval steps, the train epoch (R-Drop's
duplicate rows included) against JAX's epoch on JAX's permutation
(injected into `epoch_permutation`), `controller_step` against JAX's on
valid-loss sequences that hit the save guard, the plateau and the stop,
`fit_fully_compiled` bit-equal to `fit_device_resident` and both against
JAX's, and `Ensemble.predict_all_staged` bit-equal to `predict_all`.
Step losses within 2e-4 (tests/test_interop.py:20), epoch losses 1e-3."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.train import device_epochs as jdev  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import device_epochs as dev  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from torch_driver_common import (EPOCH_TOL, F32_TOL, TINY, assert_params_close,  # noqa: E402,F401
                                 assert_state_dicts_equal, exps, jax_init_params,
                                 jax_model, jax_shuffle, one_intra_op_thread,
                                 port_params, rel, same_start)


def test_stage_dataset_padding_and_wires():
    samples = [{"x": np.full((3,), i, np.float32)} for i in range(10)]
    data, n = dev.stage_dataset(samples, pad_to_multiple=4, device="cpu")
    jdata, jn = jdev.stage_dataset(samples, pad_to_multiple=4)
    assert n == jn == 10
    assert tuple(data["x"].shape) == (12, 3)
    np.testing.assert_array_equal(data["sample_weight"].numpy(),
                                  [1] * 10 + [0] * 2)
    np.testing.assert_array_equal(data["x"].numpy(), np.asarray(jdata["x"]))
    # int8: per-sample scales staged beside the quantized features, as JAX's
    rng = np.random.default_rng(0)
    feats = [{"v": rng.standard_normal((2, 5)).astype(np.float32),
              "v_mask": np.ones(2, np.float32)} for _ in range(6)]
    q, _ = dev.stage_dataset(feats, transfer_dtype="int8", device="cpu")
    jq, _ = jdev.stage_dataset(feats, transfer_dtype="int8")
    assert sorted(q) == sorted(jq)
    for k in q:
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
    # the gathered int8 rows restore to f32 through upcast_wire
    got = engine.upcast_wire(dev.gather_rows(q, torch.tensor([4, 1])))
    want = np.stack([feats[4]["v"], feats[1]["v"]])
    assert np.abs(got["v"].numpy() - want).max() <= (
        np.abs(want).max(axis=(1, 2)).max() / 127)
    ev_idx, ev_w = dev.padded_eval_indices(np.arange(6).reshape(2, 3), 2)
    jidx, jw = jdev.padded_eval_indices(np.arange(6).reshape(2, 3), 2)
    np.testing.assert_array_equal(ev_idx, jidx)
    np.testing.assert_array_equal(ev_w, jw)


def test_eval_epoch_matches_jax_and_host_steps():
    """Per-batch losses of the staged eval epoch equal the port's host
    Batcher + eval_step path bit for bit, and JAX's staged epoch within
    2e-4 (the padded final batch included)."""
    exp, jexp = exps("rencecps", batch_size=8)
    samples = synthetic_dataset("rencecps", exp.model, 21, seed=0)
    jmodel = jax_model(jexp, spread=False)
    jparams = jax_init_params(jmodel, 3)
    model = build_model(exp, device="cpu")
    model.load_state_dict(port_params(jparams, exp))
    data, _ = dev.stage_dataset(samples, pad_to_multiple=8, device="cpu")
    n_pad = int(data["sample_weight"].shape[0])
    staged = dev.make_eval_epoch(exp, exp.train, n_pad)(model, data)
    host = [engine.eval_step(model, exp.train, to_device(b, "cpu"))
            for b in Batcher(samples, 8, shuffle=False)()]
    assert torch.equal(staged, torch.stack(host))
    jdata, _ = jdev.stage_dataset(samples, pad_to_multiple=8)
    jlosses = np.asarray(jdev.make_eval_epoch(jmodel, jexp.train, n_pad)(
        jparams, jdata))
    np.testing.assert_allclose(staged.numpy(), jlosses, rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", ["rencecps", "ren_mme"])
def test_train_epoch_matches_jax(name, jax_shuffle, same_start):
    """One train epoch on JAX's permutation: each step's loss and the
    final parameters within 2e-4 of JAX's epoch from the same start;
    ren_mme (dropout 0, at pallas_fused) draws each sample into two
    adjacent rows (R-Drop), its KL term included."""
    if name == "rencecps":
        exp, jexp = exps(name, batch_size=8)
        n, impl, dup = 32, "xla", False
    else:
        exp, jexp = exps(name, model={**TINY, "dim": 16, "dropout": 0.0},
                         batch_size=4)
        n, impl, dup = 16, "pallas_fused", True
    samples = synthetic_dataset(name, exp.model, n, seed=1)
    jmodel = jax_model(jexp, spread=name != "rencecps")
    same_start(jmodel)
    state = engine.init_state(exp, exp.train, 0, device="cpu")
    data, _ = dev.stage_dataset(samples, device="cpu")
    losses = dev.make_train_epoch(exp, exp.train, n, impl=impl,
                                  duplicate=dup)(state, data, 7, 0)
    assert tuple(losses.shape) == (n // exp.train.batch_size,)
    tx, jepoch = jdev.make_train_epoch(jmodel, jexp.train, n, duplicate=dup)
    jstate = jeng.init_state(jmodel, tx, 0)
    jstate, jlosses = jepoch(jstate, jdev.stage_dataset(samples)[0],
                             jax.random.fold_in(jax.random.PRNGKey(7), 0))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=F32_TOL, atol=F32_TOL)
    assert_params_close(state.model.state_dict(), jstate.params, exp)
    assert state.optimizer.count == n // exp.train.batch_size


def _ctrl(lr):
    m = 3
    return (torch.full((m,), lr), torch.full((m,), np.inf),
            torch.zeros(m, dtype=torch.int32), torch.full((m,), np.inf),
            torch.zeros(m, dtype=torch.int32))


def test_controller_step_matches_jax():
    """Valid-loss sequences that pass and fail the save guard, plateau
    (the LR cut) and stop, one member frozen half way: every output of the
    port's controller_step equals JAX's."""
    exp, jexp = exps("rencecps", early_stop=3, plateau_patience=1,
                     save_guard=0.5)
    seqs = np.array([[0.9, 0.8, 0.8, 0.85, 0.7, 0.7, 0.4, 0.3, 0.9, 0.9],
                     [0.9, 0.6, 0.45, 0.44, 0.46, 0.47, 0.48, 0.5, 0.5, 0.5],
                     [1.0, 0.99995, 0.9999, 0.95, 0.95, 0.95, 0.95, 0.9, 0.8,
                      0.7]], np.float32).T
    ctrl = _ctrl(1e-3)
    jctrl = tuple(jnp.asarray(x.numpy()) for x in ctrl)
    active = torch.ones(3, dtype=torch.bool)
    seen = set()
    for e, va in enumerate(seqs):
        if e == 5:
            active[1] = False
        ctrl, save, stop = dev.controller_step(torch.from_numpy(va), ctrl,
                                               exp.train, active=active)
        jctrl, jsave, jstop = jdev.controller_step(
            jnp.asarray(va), jctrl, jexp.train,
            active=jnp.asarray(active.numpy()))
        for a, b in zip(ctrl, jctrl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(save.numpy(), np.asarray(jsave))
        np.testing.assert_array_equal(stop.numpy(), np.asarray(jstop))
        seen |= {("save", bool(x)) for x in save} | {
            ("stop", bool(x)) for x in stop}
        seen |= {("cut", bool(c)) for c in ctrl[0] < 1e-3}
    assert seen >= {("save", True), ("save", False), ("stop", True),
                    ("cut", True)}


def test_fit_drivers_match_each_other_and_jax(jax_shuffle, same_start):
    """fit_fully_compiled (controllers on the device) equals
    fit_device_resident (on the host) bit for bit: history, best epoch and
    parameters, final state; both against JAX's fit_fully_compiled from
    the same start on JAX's shuffles: epoch losses 1e-3, the same best
    epoch and stop, best parameters 2e-4."""
    exp, jexp = exps("rencecps", batch_size=8, epochs=10, early_stop=3,
                     plateau_patience=1, save_guard=0.009)
    train = synthetic_dataset("rencecps", exp.model, 40, seed=1)
    valid = synthetic_dataset("rencecps", exp.model, 13, seed=2)
    jmodel = jax_model(jexp, spread=False)
    same_start(jmodel)
    saves = []
    ref, ref_hist = dev.fit_device_resident(
        exp, exp.train, train, valid, device="cpu",
        checkpoint_cb=lambda st, e, vl: saves.append(
            (e, vl, {k: v.clone() for k, v in st.model.state_dict().items()})))
    info = {}
    state, hist, best, best_epoch, best_loss = dev.fit_fully_compiled(
        exp, exp.train, train, valid, device="cpu", info=info)
    assert [(h.train_loss, h.valid_loss) for h in hist] == [
        (h.train_loss, h.valid_loss) for h in ref_hist]
    assert saves and (best_epoch, best_loss) == saves[-1][:2]
    assert_state_dicts_equal(best, saves[-1][2])
    assert_state_dicts_equal(state.model.state_dict(), ref.model.state_dict())
    assert (state.optimizer.lr, state.optimizer.count, state.step) == (
        ref.optimizer.lr, ref.optimizer.count, ref.step)
    assert info["masked_epochs"] == 0
    assert info["epochs_launched"] == len(hist)
    assert info["staged_bytes"] > 0
    _, jhist, jbest, jbest_epoch, jbest_loss = jdev.fit_fully_compiled(
        jmodel, jexp.train, train, valid)
    assert len(hist) == len(jhist) < 10
    for a, b in zip(hist, jhist):
        assert rel(a.train_loss, b.train_loss) <= EPOCH_TOL
        assert rel(a.valid_loss, b.valid_loss) <= EPOCH_TOL
    assert best_epoch == jbest_epoch
    assert rel(best_loss, jbest_loss) <= EPOCH_TOL
    assert_params_close(best, jbest, exp)


def test_predict_all_staged_equals_predict_all():
    """Staged scoring (one program per batch over data staged once) gives
    predict_all's logits bit for bit, padding rows dropped, f32 and at the
    float16 wire."""
    exp, _ = exps("mosei_trans", batch_size=8)
    samples = [s for u in synthetic_dataset("mosei_trans", exp.model, 11,
                                            seed=3)
               for s in (u if isinstance(u, list) else [u])]
    members = [build_model(exp, device="cpu", seed=s) for s in (0, 1)]
    ens = Ensemble(members, impl="pallas_fused")
    for wire in (None, "float16"):
        staged = ens.predict_all_staged(samples, 8, transfer_dtype=wire)
        loop = ens.predict_all(Batcher(samples, 8, shuffle=False),
                               transfer_dtype=wire)
        assert staged.shape == (len(samples), exp.model.n_emotions)
        np.testing.assert_array_equal(staged, loop)
