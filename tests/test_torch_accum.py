"""PyTorch port, gradient accumulation (engine.accum_value_and_grad,
`train_step(accum_steps=)`, `Trainer(accum_steps=)`) against the JAX
package's `_accum_value_and_grad` on the CPU at tiny widths: the exact
full-batch recombination with zero-weight padding rows and with the R-Drop
KL (even micro-batches), JAX's errors word for word, one dropout stream in
micro-batch order, the Trainer's guards, and `run_experiment(accum_steps=)`
taking the sequential driver with JAX's log line.  Losses and parameters
within 2e-4 of JAX (tests/test_interop.py:20); against the unaccumulated
port step within 1e-5 (f32 reduction order)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from torch_driver_common import (F32_TOL, TINY, assert_params_close, exps,  # noqa: E402,F401
                                 jax_model, one_intra_op_thread, same_start)

EXACT = 1e-5


def _batch(samples, pad_zero_weight=0):
    """Samples stacked struct-of-arrays, with zero-weight padding rows
    appended as data/loader.Batcher pads its final batch."""
    soa = {k: np.stack([np.asarray(s[k]) for s in samples])
           for k in samples[0]}
    n = len(samples)
    if pad_zero_weight:
        soa = {k: np.concatenate(
            [v, np.zeros((pad_zero_weight,) + v.shape[1:], v.dtype)])
            for k, v in soa.items()}
        w = np.zeros(n + pad_zero_weight, np.float32)
        w[:n] = 1.0
        soa["sample_weight"] = w
    return soa


def _port_steps(exp, batches, accum_steps, impl="xla"):
    state = engine.init_state(exp, exp.train, exp.train.seed, device="cpu")
    losses = [float(engine.train_step(
        state, exp.train, {k: torch.from_numpy(v) for k, v in b.items()},
        impl=impl, accum_steps=accum_steps)) for b in batches]
    return state, losses


def _jax_steps(jmodel, jexp, batches, accum_steps):
    tx, step = jeng.make_train_step(jmodel, jexp.train,
                                    accum_steps=accum_steps, donate=False)
    state = jeng.init_state(jmodel, tx, jexp.train.seed)
    losses = []
    for b in batches:
        state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return state, losses


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["rencecps", "ren_mme"])
def test_accum_matches_full_batch_and_jax(name, same_start):
    """rencecps: accum_steps 4 on a batch and on a padded one (its tail
    rows zero-weight); ren_mme (R-Drop's KL, dropout 0, pallas_fused):
    accum_steps 2 over 4 duplicate pairs.  Both equal the unaccumulated
    step and JAX's accumulated step."""
    if name == "rencecps":
        exp, jexp = exps(name, batch_size=8)
        samples = synthetic_dataset(name, exp.model, 14, seed=0)
        batches = [_batch(samples[:8]), _batch(samples[8:], pad_zero_weight=2)]
        accum, impl = 4, "xla"
    else:
        exp, jexp = exps(name, model={**TINY, "dim": 16, "dropout": 0.0},
                         batch_size=4)
        samples = synthetic_dataset(name, exp.model, 4, seed=1)
        batches = [_batch([s for s in samples for _ in range(2)])]
        accum, impl = 2, "pallas_fused"
    jmodel = jax_model(jexp, spread=name != "rencecps")
    same_start(jmodel)
    s1, l1 = _port_steps(exp, batches, 1, impl)
    sa, la = _port_steps(exp, batches, accum, impl)
    _close(la, l1, EXACT)
    for (k, a), b in zip(sa.model.state_dict().items(),
                         s1.model.state_dict().values()):
        _close(a.numpy(), b.numpy(), EXACT)
    js, jl = _jax_steps(jmodel, jexp, batches, accum)
    _close(la, jl, F32_TOL)
    assert_params_close(sa.model.state_dict(), js.params, exp)


def test_accum_errors_match_jax():
    """A step count that does not divide the rows, and odd micro-batches
    under R-Drop, raise JAX's errors."""
    exp, _ = exps("rencecps", batch_size=8)
    samples = synthetic_dataset("rencecps", exp.model, 8, seed=2)
    with pytest.raises(ValueError, match="must divide the batch rows"):
        _port_steps(exp, [_batch(samples)], 3)
    rexp, _ = exps("ren_mme", model={**TINY, "dim": 16}, batch_size=3)
    rs = synthetic_dataset("ren_mme", rexp.model, 3, seed=3)
    dup = _batch([s for s in rs for _ in range(2)])   # 6 rows = 3 pairs
    with pytest.raises(ValueError, match=r"R-Drop needs even micro-batches "
                                         r"\(adjacent duplicate pairs\); "
                                         r"rows/accum_steps = 3"):
        _port_steps(rexp, [dup], 2)


def test_accum_dropout_draws_one_stream_in_micro_batch_order():
    """With dropout on, an accumulated step is the d_i-weighted sum of the
    micro-batches' losses and gradients, each drawing its masks from the
    state's one generator in turn."""
    exp, _ = exps("ren_mme", model={**TINY, "dim": 16, "dropout": 0.2},
                  batch_size=4)
    samples = synthetic_dataset("ren_mme", exp.model, 4, seed=4)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch([s for s in samples for _ in range(2)]).items()}
    state = engine.init_state(exp, exp.train, 5, device="cpu")
    gen = engine.dropout_generator(5, "cpu")
    model = state.model
    model.train()
    params = list(model.parameters())
    gsum, lsum = None, 0.0
    for half in (slice(0, 4), slice(4, 8)):
        mb = {k: v[half] for k, v in batch.items()}
        loss = engine.batch_loss(model, exp.train, mb, generator=gen)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x * 4.0
             for x, p in zip(g, params)]
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        lsum += 4.0 * float(loss.detach())
    loss, grads = engine.accum_value_and_grad(
        model, exp.train, batch, accum_steps=2, generator=state.generator)
    assert float(loss) == pytest.approx(lsum / 8.0, rel=EXACT)
    for a, b in zip(grads, gsum):
        _close((torch.zeros_like(b) if a is None else a).numpy(),
               (b / 8.0).numpy(), EXACT)
    assert torch.equal(state.generator.get_state(), gen.get_state())


def test_trainer_accum_guards_and_pipeline(capsys):
    """accum_steps does not compose with scan_steps (JAX's error);
    run_experiment(accum_steps=2, vmap_folds=True) takes the sequential
    driver with JAX's log line and equals the accum_steps=1 run within
    1e-5."""
    from multimodal_emotion_processing_tpu_torch import pipelines

    exp, _ = exps("rencecps")
    with pytest.raises(ValueError, match="does not compose"):
        engine.Trainer(exp, exp.train, device="cpu", scan_steps=2,
                       accum_steps=2)
    kw = dict(n_train=32, n_test=8, epochs=2, device="cpu",
              overrides={"model": {"dim": 16},
                         "train": {"batch_size": 8, "n_folds": 2}})
    r1 = pipelines.run_experiment("rencecps", quiet=True, **kw)
    r2 = pipelines.run_experiment("rencecps", accum_steps=2, vmap_folds=True,
                                  **kw)
    assert ("[rencecps] accum_steps > 1 uses the sequential k-fold driver; "
            "disabling vmap_folds") in capsys.readouterr().err
    for h1, h2 in zip(r1.fold_histories, r2.fold_histories):
        assert len(h1) == len(h2)
        for a, b in zip(h1, h2):
            assert a.steps == b.steps
            _close(b.train_loss, a.train_loss, EXACT)
            _close(b.valid_loss, a.valid_loss, EXACT)
