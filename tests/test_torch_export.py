"""PyTorch port, the serving export (`serve.export`): an artifact from
`export_predictor`, reloaded by `load_predictor`, matches the eager
`ensemble_serve_fn(impl="xla")` on the same members at batch 1 (outputs
(E,), (E')) and at batch 4 (outputs (B, E), (B, E')), and is within 2e-4
(tests/test_interop.py:20) of the JAX package's `load_predictor(
export_predictor(..., platforms=("cpu",)))` on the same weights (carried
over by `from_jax_params`); `cli export` writes one.  Tiny `mosei_trans`
on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.serve import export as jexport  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import (  # noqa: E402
    ensemble_serve_fn, export_predictor, load_predictor)

F32_TOL = 2e-4
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


@pytest.fixture(scope="module")
def ensemble():
    exp = configs.get("mosei_trans")
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, **TINY))
    jexp = dataclasses.replace(
        jconfigs.get("mosei_trans"),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)))
    jmodel = jbuild(jexp)
    params = [jmodel.init(jax.random.PRNGKey(i)) for i in range(2)]
    members = []
    for p in params:
        m = build_model(exp, device="cpu", seed=0)
        m.load_state_dict(from_jax_params(jax.device_get(p), exp.model))
        members.append(m)
    samples = synthetic_dataset(exp.name, exp.model, 4, seed=13)
    return exp, jmodel, params, members, samples


def _batch(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]
            if k != "label"}


@pytest.mark.parametrize("batch_size", [1, 4])
def test_export_matches_eager_and_jax(ensemble, batch_size):
    exp, jmodel, params, members, samples = ensemble
    blob = export_predictor(members, exp.thresholds, samples[0],
                            batch_size=batch_size, device="cpu")
    fn = load_predictor(blob)
    batch = _batch(samples[:batch_size])
    pred, probs = fn(batch)
    e, e2 = exp.model.n_emotions, len(exp.thresholds)
    want = (e,) if batch_size == 1 else (batch_size, e)
    assert tuple(pred.shape) == want
    assert tuple(probs.shape) == want[:-1] + (e2,)
    ref_pred, ref_probs = ensemble_serve_fn(members, exp.thresholds).fn(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    if batch_size == 1:
        ref_pred, ref_probs = ref_pred[0], ref_probs[0]
    torch.testing.assert_close(pred, ref_pred, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(probs, ref_probs, rtol=1e-6, atol=1e-7)
    jfn = jexport.load_predictor(jexport.export_predictor(
        jmodel, params, exp.thresholds, samples[0], platforms=("cpu",),
        batch_size=batch_size))
    jpred, jprobs = jfn(batch)
    scale = max(1.0, float(np.abs(np.asarray(jpred)).max()))
    assert np.abs(pred.numpy() - np.asarray(jpred)).max() <= F32_TOL * scale
    assert np.abs(probs.numpy() - np.asarray(jprobs)).max() <= F32_TOL


def test_export_refuses_bad_arguments(ensemble):
    exp, _, _, members, samples = ensemble
    with pytest.raises(ValueError, match="batch_size"):
        export_predictor(members, exp.thresholds, samples[0], batch_size=0,
                         device="cpu")
    with pytest.raises(ValueError, match="offsets"):
        export_predictor(members, (), samples[0], device="cpu")


def test_cli_export(tmp_path, capsys, ensemble):
    """`cli export` writes an artifact of the four seeded members that
    loads and answers a batch of its size."""
    exp, _, _, _, samples = ensemble
    out = tmp_path / "p.pt2"
    main(["export", "mosei_trans", "--device", "cpu", "--batch", "2",
          "--out", str(out)] + [f"--set=model.{k}={v}" for k, v in TINY.items()])
    assert "4-member ensemble" in capsys.readouterr().out
    pred, probs = load_predictor(out.read_bytes())(_batch(samples[:2]))
    assert tuple(pred.shape) == (2, exp.model.n_emotions)
    assert bool(torch.isfinite(pred).all()) and bool(torch.isfinite(probs).all())
