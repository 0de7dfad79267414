"""PyTorch port, the `robot_demo` slice: the `grid_only` model (RealFormer
blocks whose scores chain from layer 0 to layer 1, the multi-resolution conv
unify, position embeddings) against the JAX package's `apply` with the same
weights (carried over by `from_jax_params`) and the same numpy batch, at
2e-4 in f32 (tests/test_interop.py:20); the state dict against
`to_reference_state_dict`; the config, synthetic samples and
`pad_or_subsample` against their JAX counterparts; serving and the CLI on
the CPU.

The realformer gates a, b and c start at 0, and with them at 0 a grid
drops both the attention output and the chained scores, so every model here
has its gates set to non-zero values first."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.data import masking as jmasking  # noqa: E402
from multimodal_emotion_processing_tpu.data import synthetic as jsynthetic  # noqa: E402
from multimodal_emotion_processing_tpu.interop import to_reference_state_dict  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.models.grid import STREAMS  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import masking, synthetic  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import (  # noqa: E402
    BatchingServer, StreamingPredictor, ensemble_serve_fn)

F32_TOL = 2e-4
TINY = dict(l_len=4, v_len=9, a_len=9, dim=12, n_heads=2, l_dim=7, a_dim=5,
            v_dims_multires=(3, 4, 5))
TINY_SET = [f"--set=model.{k}={json.dumps(v)}" for k, v in TINY.items()]


def _exp(**model):
    exp = configs.get("robot_demo")
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **{**TINY, **model}))


def _jexp(exp):
    return dataclasses.replace(jconfigs.get(exp.name), model=jconfigs.ModelConfig(
        **dataclasses.asdict(exp.model)))


def _set_gates(params, cfg, seed):
    """a, b ~ U(0.5, 1.5) and c ~ U(0.25, 1.0) in every block (c > 0: a
    gate at or below -1 would cancel the next block's mask penalty)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    for name, _, _ in STREAMS:
        for i in range(cfg.n_layers):
            blk = params["blocks"][name][i]
            blk["a"] = rng.uniform(0.5, 1.5, (1,)).astype(np.float32)
            blk["b"] = rng.uniform(0.5, 1.5, (1,)).astype(np.float32)
            blk["c"] = rng.uniform(0.25, 1.0, (1,)).astype(np.float32)
    return params


def _pair(exp, seed=0):
    """JAX params with non-zero gates and the port's model with the same
    weights."""
    jmodel = jbuild(_jexp(exp))
    params = _set_gates(jmodel.init(jax.random.PRNGKey(seed)), exp.model, seed)
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    return jmodel, params, model


def _batch(exp, n=3, seed=0):
    """Stacked synthetic samples; row 0's audio is empty (all-zero mask), so
    the chained blocks see a fully masked row whose S_prev holds -1e8."""
    samples = synthetic.synthetic_dataset(exp.name, exp.model, n, seed=seed)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]
             if k != "label"}
    batch["a"][0] = 0.0
    batch["a_mask"][0] = 0.0
    return batch


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def robot():
    """The tiny robot model pair, a batch, and the JAX logits, each JAX
    impl computed once: its `pallas` forward runs the Pallas kernel in
    interpret mode, which takes seconds on the CPU."""
    exp = _exp()
    jmodel, params, model = _pair(exp)
    batch = _batch(exp)
    refs = {}

    def ref(impl):
        if impl not in refs:
            refs[impl] = np.asarray(jmodel.apply(params, batch, impl=impl))
        return refs[impl]

    return exp, jmodel, params, model, batch, ref


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_grid_only_logits_match_jax(robot, impl, jax_impl):
    exp, _, _, model, batch, ref = robot
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    impl=impl)
    assert got.shape == (3, exp.model.n_emotions)
    _close(got, ref(jax_impl), F32_TOL)


def test_gates_reach_the_logits(robot):
    """The check above is sensitive to the attention: with the gates at 0
    the same weights give other logits."""
    exp, _, params, model, batch, ref = robot
    zero = build_model(exp, device="cpu")
    sd = from_jax_params(params, exp.model)
    zero.load_state_dict({k: torch.zeros_like(v) if k.rsplit(".", 1)[-1]
                          in ("a", "b", "c") else v for k, v in sd.items()})
    with torch.no_grad():
        got = zero({k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.abs(got.numpy() - ref("xla")).max() > 100 * F32_TOL


def test_state_dict_equals_reference_export(robot):
    exp, _, params, model, _, _ = robot
    ref = to_reference_state_dict(params, _jexp(exp).model)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert sd["unify_dimension.visual_512.weight"].shape == (4, 4, 1)
    carried = from_jax_params(params, exp.model)
    assert list(carried) == list(ref)


def test_build_model_robot_demo_full_width_and_init():
    """Full width: the parameter count of the JAX model's eval_shape; the
    reference's init distributions; gates at 0."""
    exp = configs.get("robot_demo")
    jshapes = jax.eval_shape(jbuild(_jexp(exp)).init, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jshapes))
    sd = build_model(exp, device="cpu", seed=1).state_dict()
    assert sum(v.numel() for v in sd.values()) == n_jax == 5_662_397
    pos = sd["visual_position.position_embeddings.weight"]
    assert pos.shape == (100, 192) and 0.9 < pos.std().item() < 1.1
    w = sd["unify_dimension.linguistic.weight"]               # fan_in 768
    assert w.shape == (192, 768, 1) and w.abs().max() <= 1 / np.sqrt(768)
    assert sd["unify_dimension.linguistic.bias"].abs().max() <= 1 / np.sqrt(768)
    assert sd["classifier.bias"].shape == (7,)
    for g in ("a", "b", "c"):
        assert torch.equal(sd[f"multimodal_blocks.5.{g}"], torch.zeros(1))


def test_robot_config_equals_jax():
    assert dataclasses.asdict(configs.get("robot_demo")) == dataclasses.asdict(
        jconfigs.get("robot_demo"))
    over = {"model": {"dim": 12, "v_dims_multires": [3, 4, 5]}}
    assert dataclasses.asdict(configs.with_overrides(
        configs.get("robot_demo"), over)) == dataclasses.asdict(
            jconfigs.with_overrides(jconfigs.get("robot_demo"), over))


def test_robot_samples_equal_jax():
    m = _exp().model
    ours = synthetic.synthetic_dataset("robot_demo", m, 12, seed=3)
    theirs = jsynthetic.synthetic_dataset("robot_demo", m, 12, seed=3)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n", [0, 3, 9, 10, 30, 31])
def test_pad_or_subsample_equals_jax(n):
    raw = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    for a, b in zip(masking.pad_or_subsample(raw, 9),
                    jmasking.pad_or_subsample(raw, 9)):
        np.testing.assert_array_equal(a, b)


def test_serving_robot_requests(robot):
    """Robot requests (v256/v512/v1024 keys) flow through the batch-1 and
    the batching server unchanged: both give the ensemble mean of the
    model's logits, at either impl."""
    exp, _, _, model, _, _ = robot
    samples = synthetic.synthetic_dataset(exp.name, exp.model, 5, seed=4)
    ref_fn = ensemble_serve_fn([model], exp.thresholds)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
             for k in samples[0] if k != "label"}
    ref_pred, ref_probs = (t.numpy() for t in ref_fn(batch))
    assert ref_probs.shape == (5, len(exp.thresholds))
    sp = StreamingPredictor([model], exp.thresholds, impl="pallas")
    for i, s in enumerate(samples[:2]):
        pred, probs = sp.predict(s)
        _close(pred, ref_pred[i], 1e-5)
        _close(probs, ref_probs[i], 1e-5)
    with BatchingServer([model], exp.thresholds, impl="pallas",
                        max_delay_ms=50.0) as srv:
        got = [f.result(timeout=120) for f in [srv.submit(s) for s in samples]]
    for i, (pred, probs) in enumerate(got):
        _close(pred, ref_pred[i], 1e-5)
        _close(probs, ref_probs[i], 1e-5)


@pytest.mark.parametrize("extra", [["robot_demo", "--impl", "pallas",
                                    "--concurrent", "3"],
                                   ["--impl", "pallas"]])
def test_cli_serve_robot_demo_on_cpu(capsys, extra):
    """`serve robot_demo`, and `serve` with no config, which serves it."""
    out = main(["serve", "--device", "cpu", *TINY_SET, *extra])
    text = capsys.readouterr().out
    assert "The emotion(s) is(are)" in text and "fear" in text
    if "--concurrent" in extra:
        assert len(out) == 3 and all(np.isfinite(p).all() for p, _ in out)
    else:
        assert set(out) == set(configs.get("robot_demo").emotion_names)
