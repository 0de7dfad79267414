"""PyTorch port, `ren_mme` serving: the Ren-MME model (the `linear_ln`
unify with its shared LayerNorm, minus blocks under Ren-MME's state-dict
names, the `concat_trans` head with its top LayerNorm `norm3`) in eval mode,
where its dropout 0.1 is inactive, against the JAX package's model on the
same weights (carried over by `from_jax_params`) and the same numpy batch,
at `impl="xla"` and through the whole-block kernel's plain version at
`impl="pallas_fused"`, 2e-4 in f32 (tests/test_interop.py:20); its config,
sampler and state dict against their JAX counterparts; one served ensemble
request and `cli serve ren_mme` on the CPU."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.data import synthetic as jsynthetic  # noqa: E402
from multimodal_emotion_processing_tpu.interop import to_reference_state_dict  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.serve import (  # noqa: E402
    StreamingPredictor as JStreamingPredictor)
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import synthetic  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import fused_block as tfb  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import StreamingPredictor  # noqa: E402

F32_TOL = 2e-4
TINY = dict(l_len=5, v_len=6, a_len=9, dim=16, n_heads=2, l_dim=7, v_dim=6,
            a_dim=5)
TINY_SET = [f"--set=model.{k}={json.dumps(v)}" for k, v in TINY.items()]


def _exp(**model):
    exp = configs.get("ren_mme")
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **{**TINY, **model}))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)))


def _perturb(params, seed):
    """Every gate c ~ U(0.25, 1.0) and every LayerNorm (the unify's shared
    one included) away from scale 1 and bias 0, so the check sees them."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        x = np.asarray(x)
        if names[-1] == "c":
            return rng.uniform(0.25, 1.0, x.shape).astype(np.float32)
        if "norm" in names or "ln" in names:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, jax.device_get(params))


def _port(exp, params):
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    return model


def _close(got, ref, tol=F32_TOL, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def members():
    """Two perturbed tiny members (JAX params and the port's) and four
    synthetic requests."""
    exp = _exp()
    jmodel = jbuild(_jexp(exp))
    ps = [_perturb(jmodel.init(jax.random.PRNGKey(i)), 10 + i) for i in range(2)]
    samples = synthetic.synthetic_dataset(exp.name, exp.model, 4, seed=3)
    return exp, jmodel, ps, [_port(exp, p) for p in ps], samples


def test_ren_mme_config_equals_jax():
    assert dataclasses.asdict(configs.get("ren_mme")) == dataclasses.asdict(
        jconfigs.get("ren_mme"))
    m = configs.get("ren_mme").model
    assert (m.dim, m.n_heads, m.l_len, m.v_len, m.a_len, m.unify, m.dropout) \
        == (128, 8, 40, 76, 275, "linear_ln", 0.1)


def test_ren_mme_samples_equal_jax():
    m = _exp().model
    ours = synthetic.synthetic_dataset("ren_mme", m, 8, seed=5)
    theirs = jsynthetic.synthetic_dataset("ren_mme", m, 8, seed=5)
    # both the pad and the truncate paths
    assert any(s["a_mask"][0].min() == 0 for s in ours)
    assert any(s["a_mask"][0].min() == 1 for s in ours)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype


def test_state_dict_equals_reference_export(members):
    exp, _, ps, models, _ = members
    ref = to_reference_state_dict(ps[0], _jexp(exp).model)
    carried = from_jax_params(ps[0], exp.model)
    assert list(carried) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(carried[k].numpy(), v, err_msg=k)
    assert {"intensity.unify_dimension.norm1.weight",
            "stimulation.multimodal_blocks.8.norm2.bias",
            "norm3.weight"} <= set(ref)
    # a strict load: every key of the port's module is in the dict and back
    fresh = build_model(exp, device="cpu")
    fresh.load_state_dict(carried, strict=True)
    assert set(fresh.state_dict()) == set(ref)
    for k, v in models[0].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_build_model_ren_mme_full_width():
    exp = configs.get("ren_mme")
    jparams = jbuild(exp.model).init(jax.random.PRNGKey(0))
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(jparams))
    model = build_model(exp, device="cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert not model.training and model.intensity.dropout == 0.1


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("impl", ["xla", "pallas_fused"])
def test_eval_logits_match_jax(members, impl, n_layers):
    """Eval mode: dropout inactive, so pallas_fused runs the whole-block
    function; n_layers 2 chains the scores under the perturbed gates."""
    exp, jmodel, ps, models, samples = members
    if n_layers == 2:
        exp = _exp(n_layers=2)
        jmodel = jbuild(_jexp(exp))
        ps = [_perturb(jmodel.init(jax.random.PRNGKey(7)), 7)]
        models = [_port(exp, ps[0])]
        samples = synthetic.synthetic_dataset(exp.name, exp.model, 4, seed=3)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]
             if k != "label"}
    ref = jmodel.apply(ps[0], batch, impl="xla")
    before = [k.launches for k in tfb.KERNELS]
    with torch.no_grad():
        got = models[0]({k: torch.from_numpy(v) for k, v in batch.items()},
                        impl=impl)
    assert [k.launches for k in tfb.KERNELS] == before      # CPU: plain
    assert got.shape == (4, exp.model.n_emotions)
    _close(got, ref)


def test_served_request_matches_jax(members):
    exp, jmodel, ps, models, samples = members
    jsp = JStreamingPredictor(jmodel, ps, offsets=exp.thresholds)
    sp = StreamingPredictor(models, exp.thresholds, impl="pallas_fused")
    sp.warmup(samples[0])
    for s in samples[:2]:
        (pred, probs), (jpred, jprobs) = sp.predict(s), jsp.predict(s)
        assert pred.shape == (9,) and probs.shape == (8,)
        _close(pred, jpred, what="logits")
        _close(probs, jprobs, what="probs")


@pytest.mark.parametrize("extra", [["--concurrent", "3"], []])
def test_cli_serve_ren_mme_on_cpu(capsys, extra):
    out = main(["serve", "ren_mme", "--device", "cpu", "--impl",
                "pallas_fused", *TINY_SET, *extra])
    text = capsys.readouterr().out
    assert "The emotion(s) is(are)" in text and "love" in text
    if extra:
        assert len(out) == 3 and all(np.isfinite(p).all() for p, _ in out)
    else:
        assert set(out) == set(configs.get("ren_mme").emotion_names)


def test_cli_train_ren_mme_raises():
    """A ren_mme forward in training mode raises without a dropout
    generator; `cli train ren_mme` trains (dropout 0.1, R-Drop, duplicated
    rows), and its train loss carries the KL term: the same step's loss
    without `rdrop_kl` is smaller by the KL of its logits."""
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.ops.loss import symmetric_sigmoid_kl
    from multimodal_emotion_processing_tpu_torch.train import engine

    exp = _exp()
    model = build_model(exp, device="cpu").train()
    samples = synthetic.synthetic_dataset(exp.name, exp.model, 3, seed=4)
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(Batcher(samples, 2, duplicate=True)())).items()}
    with pytest.raises(ValueError, match="Generator"):
        model(batch, impl="pallas_fused")
    losses, logits = {}, []
    model.register_forward_hook(lambda m, a, out: logits.append(out.detach()))
    for rdrop in (True, False):
        tcfg = dataclasses.replace(exp.train, rdrop_kl=rdrop)
        with torch.no_grad():
            losses[rdrop] = float(engine.batch_loss(
                model, tcfg, batch, impl="pallas_fused",
                generator=torch.Generator().manual_seed(5)))
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)
    kl = float(symmetric_sigmoid_kl(logits[0], batch["sample_weight"][::2]))
    assert kl > 0
    assert losses[True] == pytest.approx(losses[False] + kl, rel=1e-6)

    # the k-fold experiment: two members, each trained on 3 of 6 samples
    res = main(["train", "ren_mme", "--device", "cpu", "--epochs", "1",
                "--n-train", "6", "--n-test", "2", "--impl",
                "pallas_fused", *TINY_SET, "--set", "train.batch_size=2",
                "--set", "train.n_folds=2"])
    assert len(res.fold_histories) == 2
    hist = res.fold_histories[0]
    assert hist[0].steps == 2 and hist[0].samples == 6   # duplicated rows
    assert np.isfinite([hist[0].train_loss, hist[0].valid_loss]).all()
