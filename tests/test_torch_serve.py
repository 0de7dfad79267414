"""PyTorch port, serving: StreamingPredictor and BatchingServer (pred,
probs) against the JAX package's, with the same members (carried over by
`from_jax_params`) and the same synthetic requests; the port's CLI on the
CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.serve import (  # noqa: E402
    BatchingServer as JBatchingServer, StreamingPredictor as JStreamingPredictor)
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import (  # noqa: E402
    BatchingServer, StreamingPredictor, ensemble_serve_fn)

F32_TOL = 2e-4
BF16_TOL = 5e-2
TINY = dict(l_len=4, v_len=9, a_len=20, dim=12, n_heads=2, l_dim=7, v_dim=3,
            a_dim=5)
TINY_SET = [f"--set=model.{k}={v}" for k, v in TINY.items()]


@pytest.fixture(scope="module")
def ensemble():
    exp = configs.get("mosei_trans")
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, **TINY))
    jexp = dataclasses.replace(jconfigs.get("mosei_trans"),
                               model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)))
    jmodel = jbuild(jexp)
    params = [jmodel.init(jax.random.PRNGKey(i)) for i in range(3)]
    members = []
    for p in params:
        m = build_model(exp, device="cpu", seed=0)
        m.load_state_dict(from_jax_params(jax.device_get(p), exp.model))
        members.append(m)
    samples = synthetic_dataset(exp.name, exp.model, 6, seed=11)
    return exp, jmodel, params, members, samples


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_streaming_predictor_matches_jax(ensemble, impl):
    exp, jmodel, params, members, samples = ensemble
    jsp = JStreamingPredictor(jmodel, params, offsets=exp.thresholds)
    sp = StreamingPredictor(members, exp.thresholds, impl=impl)
    sp.warmup(samples[0])
    for s in samples[:3]:
        jpred, jprobs = jsp.predict(s)
        pred, probs = sp.predict(s)
        _close(pred, jpred, F32_TOL)
        _close(probs, jprobs, F32_TOL)
        upred, uprobs = sp.predict_unpacked(s)
        _close(upred, pred, 1e-6)
        _close(uprobs, probs, 1e-6)


def test_streaming_predictor_bf16_matches_jax(ensemble):
    exp, jmodel, params, members, samples = ensemble
    jsp = JStreamingPredictor(jmodel, params, offsets=exp.thresholds,
                              dtype="bfloat16")
    sp = StreamingPredictor(members, exp.thresholds, impl="flash",
                            dtype="bfloat16")
    jpred, jprobs = jsp.predict(samples[1])
    pred, probs = sp.predict(samples[1])
    _close(pred, jpred, BF16_TOL)
    _close(probs, jprobs, BF16_TOL)
    # the caller's members stay f32
    assert next(members[0].parameters()).dtype == torch.float32


def test_packed_predict_rejects_shape_drift(ensemble):
    exp, _, _, members, samples = ensemble
    sp = StreamingPredictor(members, exp.thresholds)
    sp.predict(samples[0])
    bad = dict(samples[0], l=samples[0]["l"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        sp.predict(bad)


def test_batching_server_matches_jax(ensemble):
    exp, jmodel, params, members, samples = ensemble
    with JBatchingServer(jmodel, params, offsets=exp.thresholds) as jsrv:
        want = [f.result(timeout=120) for f in [jsrv.submit(s) for s in samples]]
    with BatchingServer(members, exp.thresholds, impl="flash",
                        max_delay_ms=50.0) as srv:
        srv.warmup(samples[0])
        got = [f.result(timeout=120) for f in [srv.submit(s) for s in samples]]
        stats = srv.stats()
    assert stats["requests"] == len(samples)
    assert sum(stats["by_bucket"].values()) == stats["batches"]
    assert stats["padded_rows"] == sum(
        b * n for b, n in stats["by_bucket"].items()) - len(samples)
    for (pred, probs), (jpred, jprobs) in zip(got, want):
        _close(pred, jpred, F32_TOL)
        _close(probs, jprobs, F32_TOL)


def test_batching_server_closes_cleanly(ensemble):
    exp, _, _, members, samples = ensemble
    srv = BatchingServer(members, exp.thresholds)
    assert srv.predict(samples[0])[0].shape == (exp.model.n_emotions,)
    srv.close()
    assert not srv._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(samples[0])


def test_serving_needs_offsets_and_members(ensemble):
    _, _, _, members, _ = ensemble
    with pytest.raises(ValueError, match="offsets"):
        ensemble_serve_fn(members, ())
    with pytest.raises(ValueError, match="member"):
        ensemble_serve_fn([], (0.1,))


@pytest.mark.parametrize("extra", [["--concurrent", "3"], []])
def test_cli_serve_on_cpu(capsys, extra):
    out = main(["serve", "mosei_trans_s256", "--device", "cpu", *TINY_SET,
                *extra])
    text = capsys.readouterr().out
    assert "The emotion(s) is(are)" in text and "happ" in text
    if extra:
        assert len(out) == 3 and all(np.isfinite(p).all() for p, _ in out)
    else:
        assert set(out) == set(configs.get("mosei_trans").emotion_names)
