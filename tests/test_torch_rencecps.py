"""PyTorch port, the `rencecps` family: the `concat_linear` head (two
bias-free Linears over the (previous, current) BERT features, the bilinear
transition, LayerNorm `norm`, `out`; no grid, no kernel, no dropout site)
against the JAX package's on the same weights (carried over by
`from_jax_params`) and the same numpy batch: logits, the training loss and
its step-1 gradients at 2e-4 in f32 (tests/test_interop.py:20), and two
AdamW steps; its config, sampler, `summary_masking_bert` and state dict
against their JAX counterparts; `cli train rencecps` on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.data import masking as jmasking  # noqa: E402
from multimodal_emotion_processing_tpu.data import synthetic as jsynthetic  # noqa: E402
from multimodal_emotion_processing_tpu.interop import to_reference_state_dict  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader, masking, synthetic  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models.registry import check_combination  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402

F32_TOL = 2e-4
DIM = 24


def _exp():
    exp = configs.get("rencecps")
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, dim=DIM, l_dim=DIM))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))


def _close(got, ref, tol=F32_TOL, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    """JAX params with the LayerNorm moved off its init, the port's model
    with the same weights, and a padded batch (5 samples, batch 8) with a
    no_name pair."""
    exp = _exp()
    jmodel = jbuild(_jexp(exp))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(3))))
    rng = np.random.default_rng(1)
    params["norm"]["scale"] = params["norm"]["scale"] + 0.1 * rng.standard_normal(
        9).astype(np.float32)
    params["norm"]["bias"] = 0.1 * rng.standard_normal(9).astype(np.float32)
    samples = synthetic.synthetic_dataset(exp.name, exp.model, 5, seed=2)
    samples[0]["feat"][0] = 0.0
    batch = next(iter(loader.Batcher(samples, 8, shuffle=False)()))
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    return exp, jmodel, params, model, batch


def test_rencecps_config_and_registry():
    exp = configs.get("rencecps")
    assert dataclasses.asdict(exp) == dataclasses.asdict(jconfigs.get("rencecps"))
    m = exp.model
    assert (m.dim, m.n_emotions, m.head, m.dropout) == (2304, 9,
                                                        "concat_linear", 0.1)
    check_combination(m)       # concat_linear: any block, unify, positions


def test_rencecps_samples_equal_jax():
    m = configs.get("rencecps").model
    ours = synthetic.synthetic_dataset("rencecps", m, 30, seed=5)
    theirs = jsynthetic.synthetic_dataset("rencecps", m, 30, seed=5)
    assert any(not s["feat"][0].any() for s in ours)             # no_name
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["feat"].shape == (2, 2304) and a["label"].sum() >= 1


@pytest.mark.parametrize("n", [3, 6, 7, 8, 20])
def test_summary_masking_bert_equals_jax(n):
    """Short (padded), at the m_len - 5 edge and long (two crops) inputs."""
    raw = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    ours, theirs = (masking.summary_masking_bert(raw, 11),
                    jmasking.summary_masking_bert(raw, 11))
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) == (2 if n > 6 else 1)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_state_dict_equals_reference_export(pair):
    exp, _, params, model, _ = pair
    ref = to_reference_state_dict(params, _jexp(exp).model)
    carried = from_jax_params(params, exp.model)
    assert list(carried) == list(ref) == [
        "intensity.weight", "stimulation.weight", "trans", "norm.weight",
        "norm.bias", "out.weight", "out.bias"]
    fresh = build_model(exp, device="cpu")
    fresh.load_state_dict(carried, strict=True)
    for k, v in ref.items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v,
                                      err_msg=k)


def test_build_model_rencecps_full_width():
    exp = configs.get("rencecps")
    jparams = jbuild(exp.model).init(jax.random.PRNGKey(0))
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(jparams))
    model = build_model(exp, device="cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == n_jax == 42_390
    assert model.intensity.weight.abs().max() <= 1 / np.sqrt(2304)


def test_logits_match_jax(pair):
    exp, jmodel, params, model, batch = pair
    ref = jmodel.apply(params, batch)
    with torch.no_grad():
        got = model(_tensors(batch))
    assert got.shape == (8, 9)
    _close(got, ref)


def test_loss_gradients_and_two_steps_match_jax(pair):
    """Training mode: the head has no dropout site, so a step draws no mask
    and needs none.  The loss and step-1 gradients against JAX's
    value_and_grad of `batch_loss`, then two AdamW steps against JAX's
    per-leaf optimizer."""
    import optax

    exp, jmodel, params, model, batch = pair
    jtrain = _jexp(exp).train
    tx = jeng.make_optimizer(jtrain)

    def step(p, opt_state, b):
        loss, g = jax.value_and_grad(lambda p_: jeng.batch_loss(
            jmodel, jtrain, p_, b, jax.random.PRNGKey(0), True, "xla"))(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, g

    state = engine.init_state(exp, exp.train, seed=7, device="cpu")
    state.model.load_state_dict(model.state_dict())
    state.model.train()
    loss = engine.batch_loss(state.model, exp.train, _tensors(batch),
                             generator=state.generator)
    loss.backward()
    p, opt_state = params, tx.init(params)
    p, opt_state, ref_loss, g = step(p, opt_state, batch)
    _close(loss.detach(), ref_loss, what="loss")
    ref_grads = from_jax_params(jax.device_get(g), exp.model)
    for n, prm in state.model.named_parameters():
        _close(prm.grad, ref_grads[n], what=n)
    state.model.zero_grad(set_to_none=True)

    batch2 = next(iter(loader.Batcher(synthetic.synthetic_dataset(
        exp.name, exp.model, 8, seed=9), 8, shuffle=False)()))
    p, opt_state, ref_loss2, _ = step(p, opt_state, batch2)
    got = [engine.train_step(state, exp.train, _tensors(b))
           for b in (batch, batch2)]
    _close(got[0], ref_loss, what="loss 0")
    _close(got[1], ref_loss2, what="loss 1")
    for k, v in from_jax_params(jax.device_get(p), exp.model).items():
        _close(state.model.state_dict()[k], v, what=k)


def test_cli_train_rencecps_on_cpu(capsys):
    import json

    # the k-fold experiment: two members, each trained on 10 of 20 samples
    res = main(["train", "rencecps", "--device", "cpu", "--epochs", "2",
                "--n-train", "20", "--n-test", "4",
                f"--set=model.dim={DIM}", "--set", "train.batch_size=4",
                "--set", "train.n_folds=2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    lines = [x for x in lines if "epoch" in x]
    assert [x["epoch"] for x in lines] == [0, 1, 0, 1]
    assert all(x["steps"] == 3 and x["samples"] == 10 for x in lines)
    assert all(np.isfinite([h.train_loss, h.valid_loss]).all()
               for hist in res.fold_histories for h in hist)
