"""PyTorch port, model: ConcatTrans logits against the JAX package's
`build_model(...).apply` with the same weights (carried over by
`from_jax_params`) and the same numpy batch, at 2e-4 in f32
(tests/test_interop.py:20) and 5e-2 in bf16 (tests/test_flash.py:90); the
port's state dict against `to_reference_state_dict`; configs, synthetic data
and masking against their JAX counterparts."""

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
from multimodal_emotion_processing_tpu.train.engine import (  # noqa: E402
    infer_cast as j_infer_cast, infer_upcast as j_infer_upcast)
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import masking, synthetic  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train.engine import (  # noqa: E402
    infer_cast, infer_upcast)

F32_TOL = 2e-4
BF16_TOL = 5e-2
TINY = dict(l_len=4, v_len=9, a_len=20, dim=12, n_heads=2, l_dim=7, v_dim=3,
            a_dim=5)


def _exp(name="mosei_trans", **model):
    exp = configs.get(name)
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **{**TINY, **model}))


def _jexp(exp):
    jexp = jconfigs.get(exp.name)
    return dataclasses.replace(jexp, model=jconfigs.ModelConfig(
        **dataclasses.asdict(exp.model)))


def _pair(exp, seed=0, n_members=1):
    """JAX params and the port's model with the same weights."""
    jmodel = jbuild(_jexp(exp))
    out = []
    for i in range(n_members):
        params = jmodel.init(jax.random.PRNGKey(seed + i))
        model = build_model(exp, device="cpu", seed=99)
        model.load_state_dict(from_jax_params(jax.device_get(params), exp.model))
        out.append((params, model))
    return jmodel, out


def _batch(m, b=3, seed=0):
    """A numpy batch with ragged masks, a no_name (all-zero) previous slot
    in row 0, and every other row's masks non-empty."""
    rng = np.random.default_rng(seed)
    batch = {}
    for kind, length, dim in (("l", m.l_len, m.l_dim), ("v", m.v_len, m.v_dim),
                              ("a", m.a_len, m.a_dim)):
        batch[kind] = rng.standard_normal((b, 2, length, dim)).astype(np.float32)
        mask = (rng.random((b, 2, length)) > 0.3).astype(np.float32)
        mask[..., 0] = 1.0
        mask[0, 0] = 0.0
        batch[kind][0, 0] = 0.0
        batch[kind + "_mask"] = mask
    return batch


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("model_kw", [
    {},                                             # reference-like lens
    {"n_layers": 2},                                # chained (non-terminal) blocks
    {"dim": 256, "n_heads": 2, "l_len": 8, "v_len": 12, "a_len": 16},  # dh 128
])
def test_concat_trans_logits_match_jax(impl, model_kw):
    exp = _exp(**model_kw)
    jmodel, [(params, model)] = _pair(exp)
    batch = _batch(exp.model)
    ref = jmodel.apply(params, batch, impl="xla")
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()}, impl=impl)
    _close(got, ref, F32_TOL)


def test_concat_trans_bf16_matches_jax():
    exp = _exp(dim=16, n_heads=2)
    jmodel, [(params, model)] = _pair(exp, seed=3)
    batch = _batch(exp.model, seed=3)
    jp, jb = j_infer_cast(params, batch, "bfloat16")
    ref = j_infer_upcast(jmodel.apply(jp, jb, impl="xla"))
    model16, b16 = infer_cast(model, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, "bfloat16")
    with torch.no_grad():
        got = infer_upcast(model16(b16, impl="flash"))
    assert got.dtype == torch.float32
    _close(got, ref, BF16_TOL)


def test_state_dict_equals_reference_export():
    exp = _exp()
    _, [(params, model)] = _pair(exp, seed=5)
    ref = to_reference_state_dict(params, _jexp(exp).model)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    carried = from_jax_params(params, exp.model)
    assert list(carried) == list(ref)


def test_build_model_is_seeded_and_torch_default_distributed():
    exp = _exp()
    a = build_model(exp, device="cpu", seed=1).state_dict()
    b = build_model(exp, device="cpu", seed=1).state_dict()
    c = build_model(exp, device="cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trans"], c["trans"])
    w = a["intensity.multimodal_blocks.0.minus.weight"]     # fan_in 2 * dim
    assert w.abs().max() <= 1.0 / np.sqrt(2 * exp.model.dim)
    assert 0.0 <= a["trans"].min() and a["trans"].max() < 1.0
    assert torch.equal(a["norm1.weight"], torch.ones(exp.model.n_emotions))
    assert torch.equal(a["intensity.multimodal_blocks.3.c"], torch.zeros(1))


def test_build_model_refuses_unported_families_and_missing_gpu():
    """concat_trans over the multi-resolution conv unify, a combination
    the JAX package fails on, raises ValueError; so does an unknown
    head."""
    exp = _exp()
    for change in ({"unify": "conv_multires"}, {"head": "no_such_head"}):
        unported = dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, **change))
        with pytest.raises(ValueError):
            build_model(unported, device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(exp)


def test_infer_cast_copies_and_keeps_loss_vectors_f32():
    exp = _exp()
    model = build_model(exp, device="cpu")
    batch = {"l": torch.zeros(2, 3), "sample_weight": torch.ones(2),
             "label": torch.zeros(2, dtype=torch.int32)}
    m16, b16 = infer_cast(model, batch, "bfloat16")
    assert next(m16.parameters()).dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
    assert b16["l"].dtype == torch.bfloat16
    assert b16["sample_weight"].dtype == torch.float32
    assert b16["label"].dtype == torch.int32
    assert infer_cast(model, batch, "float32") == (model, batch)


@pytest.mark.parametrize("name", ["mosei_trans", "mosei_trans_s256",
                                  "mosei_trans_s512", "mosei_trans_s1024",
                                  "mosei_realformer", "ren_mme", "rencecps"])
def test_configs_equal_jax(name):
    assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(
        jconfigs.get(name))
    over = {"model": {"dim": 32, "v_dims_multires": [1, 2, 3]},
            "train": {"batch_size": 3}}
    assert dataclasses.asdict(configs.with_overrides(configs.get(name), over)) \
        == dataclasses.asdict(jconfigs.with_overrides(jconfigs.get(name), over))
    assert configs.family(name) == jconfigs.family(name)


def test_configs_reject_unknown_names_and_sections():
    with pytest.raises(KeyError, match="mosei_trans"):
        configs.get("nope")
    with pytest.raises(KeyError):
        configs.with_overrides(configs.get("mosei_trans"), {"modle": {}})


def test_synthetic_requests_equal_jax():
    m = _exp().model
    ours = synthetic.synthetic_dataset("mosei_trans_s256", m, 12, seed=3)
    theirs = jsynthetic.synthetic_dataset("mosei_trans_s256", m, 12, seed=3)
    assert any(float(s["l_mask"][0].sum()) == 0.0 for s in ours)   # no_name
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n,is_audio", [(3, False), (15, False), (40, True)])
def test_summary_masking_equals_jax(n, is_audio):
    raw = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    raw[1, 2] = np.nan
    ours = masking.summary_masking(raw, 16, is_audio=is_audio)
    theirs = jmasking.summary_masking(raw, 16, is_audio=is_audio)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
