"""PyTorch port, the `mosei_realformer` slice: the paragraph model
(`state_transfer` head over a grid of RealFormer blocks whose scores chain
from layer 0 to layer 1, the bias-free conv unify, position embeddings, the
feature head, the gated recurrence over the clips) against the JAX
package's with the same weights (carried over by `from_jax_params`) and the
same numpy batches, at 2e-4 in f32 (tests/test_interop.py:20): logits at
`impl="xla"` and `"pallas"`, the clip-mask loss, three Adam steps and their
step-1 gradients, and clip-by-clip streaming; the state dict against
`to_reference_state_dict`; the config, `simple_masking` and the paragraph
sampler against their JAX counterparts; `cli train` and `cli serve` on the
CPU.

The realformer gates a, b and c start at 0, where neither the attention
output nor the chained scores reach the logits, so every model here has
its gates set to non-zero values first."""

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
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader, masking, synthetic  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as tpa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.serve import (  # noqa: E402
    ParagraphStreamingPredictor)
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402

F32_TOL = 2e-4
TINY = dict(l_len=5, v_len=6, a_len=7, dim=12, n_heads=2, l_dim=7, v_dim=3,
            a_dim=5, p_len=3)
TINY_SET = [f"--set=model.{k}={json.dumps(v)}" for k, v in TINY.items()]
OFFSETS = (0.1, -0.3, -0.5, -0.6, -0.3, -0.5)   # tests/test_train_eval.py:903
CLIP_KEYS = ("l", "v", "a", "l_mask", "v_mask", "a_mask")


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
    exp = configs.get("mosei_realformer")
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **TINY),
        train=dataclasses.replace(exp.train, **{"batch_size": 3, **train}))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))


def _set_gates(params, cfg, seed):
    """a, b ~ U(0.5, 1.5) and c ~ U(0.25, 1.0) in every block (c > 0: a
    gate at or below -1 would cancel the next block's mask penalty)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    for name, _, _ in STREAMS:
        for i in range(cfg.n_layers):
            blk = params["feature"]["blocks"][name][i]
            blk["a"] = rng.uniform(0.5, 1.5, (1,)).astype(np.float32)
            blk["b"] = rng.uniform(0.5, 1.5, (1,)).astype(np.float32)
            blk["c"] = rng.uniform(0.25, 1.0, (1,)).astype(np.float32)
    return params


def _port(exp, params):
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    return model


def _batch(exp, n=3, seed=0, batch_size=None, zero_row=True):
    """The first batch of a Batcher over synthetic paragraphs (zero padding
    rows past n with their sample_weight 0 when batch_size > n).  With
    `zero_row`, row 0's first clip gets an all-zero audio mask, so the
    chained blocks see a fully masked row whose S_prev holds -1e8."""
    samples = synthetic.synthetic_dataset(exp.name, exp.model, n, seed=seed)
    if zero_row:
        samples[0]["a"][0] = 0.0
        samples[0]["a_mask"][0] = 0.0
    return next(iter(loader.Batcher(samples, batch_size or n, shuffle=False)()))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, ref, tol=F32_TOL, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """The tiny paragraph model in JAX (gates set) and the port with the
    same weights, a batch with a fully masked row, and JAX's logits on it."""
    exp = _exp()
    jmodel = jbuild(_jexp(exp))
    params = _set_gates(jmodel.init(jax.random.PRNGKey(0)), exp.model, 0)
    batch = _batch(exp)
    ref = np.asarray(jmodel.apply(params, batch, impl="xla"))
    return exp, jmodel, params, _port(exp, params), batch, ref


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_logits_match_jax(pair, impl):
    exp, _, _, model, batch, ref = pair
    with torch.no_grad():
        got = model(_tensors(batch), impl=impl)
    assert got.shape == (3, exp.model.p_len, exp.model.n_emotions)
    _close(got, ref)


def test_gates_reach_the_logits(pair):
    exp, _, params, _, batch, ref = pair
    sd = from_jax_params(params, exp.model)
    zero = build_model(exp, device="cpu")
    zero.load_state_dict({k: torch.zeros_like(v) if k.rsplit(".", 1)[-1]
                          in ("a", "b", "c") else v for k, v in sd.items()})
    with torch.no_grad():
        got = zero(_tensors(batch))
    assert np.abs(got.numpy() - ref).max() > 100 * F32_TOL


def test_state_dict_equals_reference_export(pair):
    exp, _, params, model, _, _ = pair
    ref = to_reference_state_dict(params, _jexp(exp).model)
    carried = from_jax_params(params, exp.model)
    assert list(carried) == list(ref)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert sd["feature.unify_dimension.visual.weight"].shape == (12, 3, 1)
    assert "feature.unify_dimension.visual.bias" not in sd
    assert sd["feature.fully_connected.weight"].shape == (12, 72)
    assert sd["classifier.weight"].shape == (12, 12)
    assert sd["trans"].shape == (6, 6)


def test_build_model_full_width():
    """Full width: the parameter count of the JAX model's init; gates at 0;
    the reference's init distributions."""
    exp = configs.get("mosei_realformer")
    jshapes = jax.eval_shape(jbuild(jconfigs.get(exp.name)).init,
                             jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jshapes))
    sd = build_model(exp, device="cpu", seed=1).state_dict()
    assert sum(v.numel() for v in sd.values()) == n_jax == 1_449_702
    w = sd["feature.unify_dimension.linguistic.weight"]          # fan_in 300
    assert w.shape == (96, 300, 1) and w.abs().max() <= 1 / np.sqrt(300)
    assert 0.0 <= sd["trans"].min() and sd["trans"].max() < 1.0
    assert torch.equal(sd["feature.normalization.weight"], torch.ones(96))
    for g in ("a", "b", "c"):
        assert torch.equal(sd[f"feature.multimodal_blocks.17.{g}"], torch.zeros(1))


@pytest.mark.parametrize("n", [0, 3, 7, 8, 20])
def test_simple_masking_equals_jax(n):
    raw = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    if n:
        raw[n // 2, 1] = np.inf
        raw[0, 3] = np.nan
    for a, b in zip(masking.simple_masking(raw, 7),
                    jmasking.simple_masking(raw, 7)):
        np.testing.assert_array_equal(a, b)


def test_paragraph_samples_equal_jax():
    m = _exp().model
    ours = synthetic.synthetic_dataset("mosei_realformer", m, 8, seed=3)
    theirs = jsynthetic.synthetic_dataset("mosei_realformer", m, 8, seed=3)
    for a, b in zip(ours, theirs):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any(s["clip_mask"].min() == 0 for s in ours)


@pytest.mark.parametrize("case", ["padded", "no_weight", "no_clip_mask"])
def test_clip_mask_loss_matches_jax(case):
    """The loss contract on the same (B, P, E) logits: Σ loss·clip_mask·w /
    max(Σw·P, 1) with zero padding rows (w = 0), whose denominator counts
    every clip of a real row; the plain mean without a sample_weight; and
    the loss without the clip mask, which differs."""
    import types

    exp = _exp(clip_mask_loss=case != "no_clip_mask")
    batch = _batch(exp, n=3, seed=5, batch_size=5)
    if case == "no_weight":
        del batch["sample_weight"]
    logits = np.random.default_rng(6).standard_normal(
        (5, exp.model.p_len, exp.model.n_emotions)).astype(np.float32)
    ref = jeng.batch_loss(types.SimpleNamespace(apply=lambda *a, **k: logits),
                          _jexp(exp).train, None, batch, None, False, "xla")
    got = engine.batch_loss(lambda b, impl: torch.from_numpy(logits),
                            exp.train, _tensors(batch))
    _close(got, ref, 1e-6)
    if case == "padded":
        masked = (batch["clip_mask"] * batch["sample_weight"][:, None]).sum()
        assert 0 < masked < 3 * exp.model.p_len
        unmasked = dataclasses.replace(exp.train, clip_mask_loss=False)
        assert abs(float(engine.batch_loss(
            lambda b, impl: torch.from_numpy(logits), unmasked,
            _tensors(batch))) - float(ref)) > 1e-3


@pytest.fixture(scope="module")
def jax_steps(pair):
    """The JAX side of the training check, computed once from the pair's
    gate-perturbed params: three batches, the step-1 gradients, the three
    losses and the params after them.  A step is JAX's train step in its
    per-leaf form (`_make_step_fn` with fused=False): value_and_grad of
    `batch_loss` (impl xla), then `make_optimizer`'s clip and Adam.  The
    batches have no forced fully masked row: in one, block 1's
    dc = Σ ds·S_prev adds ±1e8-sized terms that cancel, so dc is rounding
    noise in either framework, and Adam's normalised update carries that
    noise into c (tests/test_torch_scored_grad.py holds dc at the scale of
    its terms).  Every valid clip has a real key, and the invalid clips'
    loss is masked, so their gradients are exactly 0."""
    import optax

    exp, jmodel, params, _, _, _ = pair
    jtrain = _jexp(exp).train
    batches = [_batch(exp, n=3, seed=10 + i, batch_size=4, zero_row=False)
               for i in range(3)]
    tx = jeng.make_optimizer(jtrain)

    @jax.jit
    def step(p, opt_state, b):
        loss, g = jax.value_and_grad(lambda p_: jeng.batch_loss(
            jmodel, jtrain, p_, b, None, True, "xla"))(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, g

    opt_state = tx.init(params)
    init = from_jax_params(params, exp.model)
    losses, grads = [], None
    for batch in batches:
        params, opt_state, loss, g = step(params, opt_state, batch)
        grads = grads or from_jax_params(jax.device_get(g), exp.model)
        losses.append(float(loss))
    return (exp, init, batches, grads, losses,
            from_jax_params(jax.device_get(params), exp.model))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_three_adam_steps_match_jax(jax_steps, impl):
    """Step-1 gradients per parameter, then the losses of three Adam steps
    and the weights after them, against the JAX train step (impl xla)."""
    exp, init, batches, ref_grads, ref_losses, ref_params = jax_steps
    state = engine.init_state(exp, exp.train, seed=99, device="cpu")
    state.model.load_state_dict(init)
    state.model.train()
    engine.batch_loss(state.model, exp.train, _tensors(batches[0]),
                      impl=impl).backward()
    for n, p in state.model.named_parameters():
        if p.grad is None:
            # a stream's block 0 reads no S_prev, so its gate c gets no
            # gradient, as on the xla path; JAX's is zero
            assert n.endswith(".c")
            np.testing.assert_array_equal(ref_grads[n].numpy(), 0.0)
            continue
        _close(p.grad, ref_grads[n], what=n)
    state.model.zero_grad(set_to_none=True)

    for i, batch in enumerate(batches):
        loss = engine.train_step(state, exp.train, _tensors(batch), impl=impl)
        _close(loss, ref_losses[i], what=f"loss {i}")
    for k, v in state.model.state_dict().items():
        _close(v, ref_params[k], what=k)


@pytest.fixture(scope="module")
def members():
    """Two gate-perturbed tiny members (JAX params and the port's) and one
    synthetic paragraph."""
    exp = _exp()
    jmodel = jbuild(_jexp(exp))
    ps = [_set_gates(jmodel.init(jax.random.PRNGKey(i)), exp.model, 10 + i)
          for i in range(2)]
    sample = synthetic.synthetic_dataset(exp.name, exp.model, 1, seed=3)[0]
    return exp, jmodel, ps, [_port(exp, p) for p in ps], sample


def test_paragraph_streaming_matches_whole_window(members):
    """Clip t pushed equals column t of the members' whole-window logits
    under the reference's 0.6/0.4 blend (tests/test_train_eval.py:886-923);
    reset() restarts at t = 0."""
    exp, _, _, models, sample = members
    batch = {k: torch.from_numpy(sample[k][None]) for k in CLIP_KEYS}
    with torch.no_grad():
        whole = torch.stack([m(batch, impl="xla")[0] for m in models]).numpy()
    weights = (0.6, 0.4)
    blended = np.einsum("k,kpe->pe", np.asarray(weights), whole)
    sp = ParagraphStreamingPredictor(models, OFFSETS, weights=weights,
                                     impl="pallas")
    sp.warmup({k: sample[k][0] for k in CLIP_KEYS})
    for t in range(exp.model.p_len):
        pred, probs = sp.push({k: sample[k][t] for k in CLIP_KEYS})
        _close(pred, blended[t], 3e-5)
        np.testing.assert_allclose(
            probs, 1 / (1 + np.exp(-(pred - np.asarray(OFFSETS)))), rtol=1e-5)
    sp.reset()
    clip0 = {k: sample[k][0] for k in CLIP_KEYS}
    _close(sp.push(clip0)[0], blended[0], 3e-5)
    assert set(sp.emotions(clip0, exp.emotion_names)) == set(exp.emotion_names)


def test_paragraph_streaming_matches_jax_predictor(members):
    from multimodal_emotion_processing_tpu.serve import (
        ParagraphStreamingPredictor as JaxPredictor)

    exp, jmodel, ps, models, sample = members
    jsp = JaxPredictor(jmodel, ps, offsets=OFFSETS)
    sp = ParagraphStreamingPredictor(models, OFFSETS, impl="pallas")
    for t in range(exp.model.p_len):
        clip = {k: sample[k][t] for k in CLIP_KEYS}
        (pred, probs), (jpred, jprobs) = sp.push(clip), jsp.push(clip)
        _close(pred, jpred)
        _close(probs, jprobs)


def test_paragraph_predictor_refuses_other_heads_and_bad_args(members):
    exp, _, _, models, _ = members
    robot = configs.get("robot_demo")
    robot = dataclasses.replace(robot, model=dataclasses.replace(
        robot.model, dim=12, n_heads=2, l_dim=7, a_dim=5, l_len=4, v_len=9,
        a_len=9, v_dims_multires=(3, 4, 5)))
    with pytest.raises(ValueError, match="state_transfer"):
        ParagraphStreamingPredictor([build_model(robot, device="cpu")], OFFSETS)
    with pytest.raises(ValueError, match="offsets"):
        ParagraphStreamingPredictor(models, ())
    with pytest.raises(ValueError, match="weights"):
        ParagraphStreamingPredictor(models, OFFSETS, weights=(1.0,))


def test_realformer_trains_through_the_function_on_cpu():
    """impl="pallas" in training goes through ScoredAttention, whose CPU
    path takes the plain versions: no kernel launches."""
    exp = _exp()
    state = engine.init_state(exp, exp.train, seed=0, device="cpu")
    before = [k.launches for k in tpa.KERNELS]
    loss = engine.train_step(state, exp.train, _tensors(_batch(exp)),
                             impl="pallas")
    assert np.isfinite(float(loss)) and state.step == 1
    assert [k.launches for k in tpa.KERNELS] == before


def test_cli_train_mosei_realformer_on_cpu(capsys):
    # the k-fold experiment: two members, each trained on 5 of 10
    # paragraphs, then the 400-point threshold sweep (no fixed thresholds)
    res = main(["train", "mosei_realformer", "--device", "cpu",
                "--epochs", "2", "--n-train", "10", "--n-test", "3",
                "--impl", "pallas", *TINY_SET,
                "--set", "train.batch_size=3", "--set", "train.n_folds=2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    epochs = [x for x in lines if "epoch" in x]
    assert [x["epoch"] for x in epochs] == [0, 1, 0, 1]
    assert all(x["steps"] == 2 and x["samples"] == 5 for x in epochs)
    assert all(np.isfinite(x["train_loss"]) and np.isfinite(x["valid_loss"])
               for x in epochs)
    assert [sum(h.steps for h in hist) for hist in res.fold_histories] == [4, 4]
    assert set(lines[-1]["best_thresholds"]) == set(
        configs.get("mosei_realformer").emotion_names)


def test_cli_serve_mosei_realformer_on_cpu(capsys):
    per_clip = main(["serve", "mosei_realformer", "--device", "cpu",
                     "--impl", "pallas", *TINY_SET,
                     "--thresholds=" + ",".join(map(str, OFFSETS))])
    text = capsys.readouterr().out
    assert "Streaming paragraph (3 clips" in text and "clip 2:" in text
    assert len(per_clip) == 3
    assert all(set(e) == set(configs.get("mosei_realformer").emotion_names)
               for e in per_clip)
    with pytest.raises(SystemExit, match="clip-by-clip"):
        main(["serve", "mosei_realformer", "--device", "cpu", *TINY_SET,
              "--thresholds=" + ",".join(map(str, OFFSETS)), "--concurrent", "2"])
    with pytest.raises(ValueError, match="offsets"):
        main(["serve", "mosei_realformer", "--device", "cpu", *TINY_SET])
