"""PyTorch port, the wire formats of the copies to the device
(`data.loader.cast_for_transfer`, `train.engine.upcast_wire` /
`wire_to_bf16`, `Trainer(transfer_dtype=)`, `Ensemble.predict_all(
transfer_dtype=)`): the casts bit-equal
to the JAX package's for every wire (bfloat16 compared as uint16 bits,
int8 with its scales), the upcast exact, a fit and an ensemble pass on
features on the float16 grid the same at float16 as at f32 (rtol 1e-6,
tests/test_transfer.py:142-160), the fit's losses within 5 % of f32 at
bfloat16 and int8 and the ensemble's logits at bfloat16 (as
‖got − f32‖₂ / ‖f32‖₂), the int8 wire within its documented bound of half
a step (s/2) per element, and the port at each wire within 2e-4 of JAX at
the same wire (tests/test_interop.py:20).  At int8 the tiny model's
ensemble logits move 5.1 % (‖·‖₂) from f32, JAX's as the port's: its
three-to-seven-wide features do not average the rounding out.  Tiny
`mosei_trans` on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.data import loader as jloader  # noqa: E402
from multimodal_emotion_processing_tpu.eval.ensemble import Ensemble as JEnsemble  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402

WIRES = ("float16", "bfloat16", "int8")
F32_TOL = 2e-4
LOSSY = 5e-2       # bfloat16 and int8 against f32
F16_GRID_RTOL = 1e-6
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
        train=dataclasses.replace(exp.train, batch_size=4, **train))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))


def _round_f16(samples):
    """Features snapped onto the float16 grid, so that the float16 wire
    round-trips them exactly."""
    return [{k: (v.astype(np.float16).astype(np.float32)
                 if v.dtype == np.float32 else v) for k, v in s.items()}
            for s in samples]


@pytest.fixture(scope="module")
def members():
    exp = _exp()
    jmodel = jbuild(_jexp(exp))
    params = [jmodel.init(jax.random.PRNGKey(i)) for i in range(2)]
    out = []
    for p in params:
        m = build_model(exp, device="cpu", seed=0)
        m.load_state_dict(from_jax_params(jax.device_get(p), exp.model))
        out.append(m)
    return exp, jmodel, params, out


def _raw_batch(seed=0):
    """Features across magnitudes (one past float16's range), 0/1 masks,
    labels, weights and an int key."""
    rng = np.random.default_rng(seed)
    feat = (rng.standard_normal((4, 6, 5))
            * np.exp(rng.uniform(-6, 6, (4, 6, 5)))).astype(np.float32)
    feat[0, 0, 0] = 7e4
    return {"l": feat,
            "l_mask": (rng.random((4, 6)) > 0.3).astype(np.float32),
            "label": (rng.random((4, 7)) > 0.6).astype(np.float32),
            "sample_weight": np.array([1, 1, 1, 0], np.float32),
            "group": np.arange(4, dtype=np.int32)}


def _bits(v):
    """A leaf's bits as numpy: bfloat16 (a torch tensor in the port, an
    ml_dtypes array in JAX) as uint16."""
    if torch.is_tensor(v):
        assert v.dtype == torch.bfloat16
        return v.view(torch.int16).numpy().view(np.uint16)
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":
        return v.view(np.uint16)
    return v


@pytest.mark.parametrize("wire", WIRES)
def test_cast_for_transfer_bit_equal_jax(wire):
    batch = _raw_batch()
    got = loader.cast_for_transfer(batch, loader.resolve_transfer_dtype(wire))
    ref = jloader.cast_for_transfer(batch, jloader.resolve_transfer_dtype(wire))
    assert list(got) == list(ref)
    for k in ref:
        g, r = _bits(got[k]), _bits(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)
    if wire == "int8":
        assert got["l"].dtype == np.int8
        assert got["l_mask"].dtype == np.float16
        assert got["l" + loader.WIRE_SCALE_SUFFIX].shape == (4,)
    with pytest.raises(ValueError, match="transfer_dtype"):
        loader.resolve_transfer_dtype("int4")


@pytest.mark.parametrize("wire", WIRES)
def test_upcast_wire_exact(wire):
    """The port's upcast of its wire batch equals JAX's upcast of JAX's, to
    the bit; `wire_to_bf16` equals the upcast cast to bf16."""
    batch = _raw_batch(seed=1)
    cast = loader.cast_for_transfer(batch, loader.resolve_transfer_dtype(wire))
    jcast = jloader.cast_for_transfer(batch, jloader.resolve_transfer_dtype(wire))
    got = engine.upcast_wire({k: loader._host_tensor(v) for k, v in cast.items()})
    ref = jax.device_get(jeng.upcast_wire(jcast))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("l_mask", "label", "sample_weight"):   # 0/1 vectors: exact
        np.testing.assert_array_equal(got[k].numpy(), batch[k])
    if wire == "int8":      # at most half a step s = row max / 127 off
        step = np.abs(batch["l"]).reshape(4, -1).max(1) / 127
        err = np.abs(got["l"].numpy() - batch["l"]).reshape(4, -1).max(1)
        assert np.all(err <= step / 2 * (1 + 1e-6)), (err, step)
    bf = engine.wire_to_bf16({k: loader._host_tensor(v) for k, v in cast.items()})
    for k, v in got.items():
        want = (v if k in engine._KEEP_F32 or not v.is_floating_point()
                else v.to(torch.bfloat16))
        assert bf[k].dtype == want.dtype and torch.equal(bf[k], want), k


def _loss_batch(exp, seed=3):
    samples = synthetic_dataset(exp.name, exp.model, 4, seed=seed)
    return next(iter(loader.Batcher(samples, 4, shuffle=False)()))


@pytest.mark.parametrize("wire", WIRES)
def test_batch_loss_at_each_wire_matches_jax(members, wire):
    """The eval loss of one wire batch: the port's `batch_loss` against
    JAX's on the same weights and the same wire batch."""
    exp, jmodel, params, ms = members
    batch = _loss_batch(exp)
    cast = loader.cast_for_transfer(batch, loader.resolve_transfer_dtype(wire))
    jcast = jloader.cast_for_transfer(batch, jloader.resolve_transfer_dtype(wire))
    with torch.no_grad():
        got = engine.batch_loss(ms[0], exp.train, {
            k: loader._host_tensor(v) for k, v in cast.items()})
    ref = jeng.batch_loss(jmodel, _jexp(exp).train, params[0], jcast, None,
                          train=False, impl="xla")
    np.testing.assert_allclose(float(got), float(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def _fit(exp, samples, wire):
    train, valid = samples[:12], samples[12:]
    tr = engine.Trainer(exp, exp.train, device="cpu", transfer_dtype=wire)
    _, hist = tr.fit(loader.Batcher(train, 4, seed=2),
                     loader.Batcher(valid, 4, shuffle=False), epochs=2,
                     seed=0)
    return [x for h in hist for x in (*h.step_losses, h.valid_loss)]


def test_trainer_wire_on_the_f16_grid():
    """A fit is unchanged by the float16 wire on f16-grid features (rtol
    1e-6) and within 5 % at bfloat16 and int8."""
    exp = _exp()
    samples = _round_f16(synthetic_dataset(exp.name, exp.model, 16, seed=1))
    ref = np.asarray(_fit(exp, samples, None))
    np.testing.assert_allclose(_fit(exp, samples, "float16"), ref,
                               rtol=F16_GRID_RTOL, atol=1e-7)
    for wire in ("bfloat16", "int8"):
        got = np.asarray(_fit(exp, samples, wire))
        assert np.all(np.abs(got - ref) <= LOSSY * np.abs(ref)), (wire, got, ref)


def _normalised(got, ref):
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_predict_all_wire_matches_f32_and_jax(members):
    """`Ensemble.predict_all` on f16-grid features: float16 as f32 (rtol
    1e-6), bfloat16 within 5 %; each wire within 2e-4 of JAX's
    `Ensemble.predict_all` at the same wire."""
    exp, jmodel, params, ms = members
    test = _round_f16(synthetic_dataset(exp.name, exp.model, 7, seed=5))
    ens = Ensemble(ms)
    jens = JEnsemble(jmodel, params)
    ref = ens.predict_all(loader.Batcher(test, 4, shuffle=False))
    assert ref.shape == (7, exp.model.n_emotions)
    for wire in (None,) + WIRES:
        got = ens.predict_all(loader.Batcher(test, 4, shuffle=False),
                              transfer_dtype=wire)
        jgot = jens.predict_all(jloader.Batcher(test, 4, shuffle=False),
                                transfer_dtype=wire)
        assert _normalised(got, jgot) <= F32_TOL, wire
        if wire == "float16":
            np.testing.assert_allclose(got, ref, rtol=F16_GRID_RTOL, atol=1e-7)
        elif wire == "bfloat16":
            assert _rel_l2(got, ref) <= LOSSY


def test_cli_predict_transfer_dtype(tmp_path, capsys):
    """`cli predict --transfer-dtype` runs the wire end to end."""
    out = tmp_path / "p.npz"
    main(["predict", "mosei_trans", "--device", "cpu", "--init-random",
          "-o", str(out), "--n-test", "5", "--transfer-dtype", "int8",
          "--quiet"] + [f"--set=model.{k}={v}" for k, v in TINY.items()])
    assert '"rows": 5' in capsys.readouterr().out
    assert out.exists()
