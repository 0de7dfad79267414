"""PyTorch port, training with dropout: `ren_mme` (dropout 0.1 and R-Drop
over duplicated rows), `robot_demo` (dropout 0.1, two chained RealFormer
blocks a stream, gates set) and `mosei_realformer` with a dropout override
(one block a stream: its conv unify's and feature head's sites), against
the JAX package with the SAME keep masks on both sides: the loss and every
step-1 gradient at 2e-4 in f32 (tests/test_interop.py:20), at `impl="xla"`
and at the kernel impl on its plain CPU path, and at rate 0, where the port
draws no mask; and `cli train` for the three families on the CPU.

Torch cannot reproduce `jax.random.bernoulli`, so `MaskTape` stands in for
both sides' mask draws.  JAX's `models.layers.dropout` (which `grid.py`
reaches as `layers.dropout`) is monkeypatched: a shape-only trace records
each active site's shape, a seeded numpy generator draws the keep masks,
and one jitted JAX program per family takes them as inputs (so the rates
share its compile).  The port's one mask-drawing function,
`layers.keep_mask`, replays the same masks in order, checking that each
site asks for the recorded shape and that the counts agree.  A port that
drew its sites in another order fails the shapes or the parity."""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.models import layers as jlayers  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader, synthetic  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model, layers  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402

F32_TOL = 2e-4
# tiny widths, distinct lengths (so the sites' shapes tell streams apart)
TINY = {
    "ren_mme": dict(l_len=5, v_len=6, a_len=9, dim=16, n_heads=2, l_dim=7,
                    v_dim=6, a_dim=5),
    "robot_demo": dict(l_len=4, v_len=9, a_len=7, dim=12, n_heads=2, l_dim=7,
                       a_dim=5, v_dims_multires=(3, 4, 5)),
    "mosei_realformer": dict(l_len=5, v_len=6, a_len=7, dim=12, n_heads=2,
                             l_dim=7, v_dim=3, a_dim=5, p_len=3, n_layers=1),
}
# the impl whose kernels the family trains through on the card
KERNEL_IMPL = {"ren_mme": "pallas_fused", "robot_demo": "pallas",
               "mosei_realformer": "pallas"}
# the sites one forward draws: (unify, per block, head) x grids x blocks
SITES = {"ren_mme": 2 * 9 * 2, "robot_demo": 5 + 18 * 2,
         "mosei_realformer": 3 + 9 * 2 + 1}


class MaskTape:
    """The keep masks of one forward on both sides.  `jax_dropout` stands in
    for JAX's dropout: in a first, shape-only trace it records each active
    site's shape; under `jax.jit` it takes each site's mask and keep from
    the traced inputs, so one compiled program serves every rate.
    `replay` stands in for the port's `keep_mask` and hands out the masks
    in order."""

    def __init__(self):
        self.shapes = []
        self.traced = None          # (iterator over traced masks, keep)
        self.masks = []
        self.pos = 0

    def jax_dropout(self, rng, x, rate, train):
        if not train or rate <= 0.0 or rng is None:
            return x
        if self.traced is None:
            self.shapes.append(tuple(x.shape))
            return x
        masks, keep = self.traced
        return jnp.where(next(masks), x / keep, 0.0)

    def draw(self, rate, seed):
        """Masks for every recorded site: Bernoulli(1 - rate) from a seeded
        numpy generator, or all kept at rate 0."""
        rng = np.random.default_rng(seed)
        return [rng.random(s) < 1.0 - rate for s in self.shapes]

    def load(self, masks):
        """Replay `masks` from the first."""
        self.masks, self.pos = masks, 0

    def replay(self, shape, keep, generator, device):
        assert generator is not None
        assert self.pos < len(self.masks), "the port draws more masks than JAX"
        mask = self.masks[self.pos]
        assert mask.shape == tuple(shape), (self.pos, mask.shape, tuple(shape))
        self.pos += 1
        return torch.from_numpy(mask).to(device)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tiny models run op by op: with several test processes on one
    host, PyTorch's default of one intra-op thread per core oversubscribes
    it and the tests slow tenfold.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(name, rate):
    exp = configs.get(name)
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, **TINY[name], dropout=rate))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))


def _perturb(params, seed):
    """Gates a, b ~ U(0.5, 1.5) and c ~ U(0.25, 1.0) (at their init of 0 the
    attention would not reach the loss) and every LayerNorm moved off its
    init."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        x = np.asarray(x)
        if names[-1] in ("a", "b"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if names[-1] == "c":
            return rng.uniform(0.25, 1.0, x.shape).astype(np.float32)
        if any(n.startswith(("norm", "ln")) for n in names):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, jax.device_get(params))


def _batch(exp):
    """The first batch of the family's Batcher over 3 synthetic samples at
    batch size 4 (one zero padding row, or pair, of weight 0); ren_mme's
    duplicates every sample into adjacent rows."""
    samples = synthetic.synthetic_dataset(exp.name, exp.model, 3, seed=11)
    return next(iter(loader.Batcher(samples, 4, shuffle=False,
                                    duplicate=exp.train.rdrop_kl)()))


def _close(got, ref, tol=F32_TOL, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


_JAX = {}


def _jax_step(name):
    """(exp at dropout 0.1, perturbed params, batch, tape, step) for one
    family: `step(rate)` gives JAX's loss and step-1 gradients (as a port
    state dict) of `batch_loss` in training at impl xla under the tape's
    masks for `rate`, and those masks.  At rate 0 every mask keeps everything
    and keep is 1, so each site returns x exactly, as JAX's dropout does
    at rate 0.  Compiled once per family."""
    if name not in _JAX:
        exp = _exp(name, 0.1)
        jexp = _jexp(exp)
        jmodel = jbuild(jexp)
        params = _perturb(jmodel.init(jax.random.PRNGKey(0)), 1)
        batch = _batch(exp)
        tape = MaskTape()

        def loss_fn(p):
            return jeng.batch_loss(jmodel, jexp.train, p, batch,
                                   jax.random.PRNGKey(3), True, "xla")

        @jax.jit
        def grads(p, masks, keep):
            tape.traced = (iter(masks), keep)
            try:
                return jax.value_and_grad(loss_fn)(p)
            finally:
                tape.traced = None

        original = jlayers.dropout
        jlayers.dropout = tape.jax_dropout
        try:
            jax.eval_shape(loss_fn, params)
            grads.lower(params, [jax.ShapeDtypeStruct(s, bool)
                                 for s in tape.shapes],
                        jnp.float32(1.0))     # trace while patched
        finally:
            jlayers.dropout = original

        def step(rate):
            masks = tape.draw(rate, seed=2)
            original = jlayers.dropout
            jlayers.dropout = tape.jax_dropout
            try:
                loss, g = grads(params, masks, jnp.float32(1.0 - rate))
            finally:
                jlayers.dropout = original
            return (float(loss),
                    from_jax_params(jax.device_get(g), exp.model), masks)

        _JAX[name] = (exp, params, batch, tape, functools.lru_cache()(step))
    return _JAX[name]


CASES = [(n, 0.1, impl) for n in ("ren_mme", "robot_demo", "mosei_realformer")
         for impl in ("xla", KERNEL_IMPL[n])]
CASES += [("ren_mme", 0.0, "xla"), ("robot_demo", 0.0, "pallas")]


@pytest.mark.parametrize("name,rate,impl", CASES)
def test_train_loss_and_step1_gradients_match_jax(monkeypatch, name, rate,
                                                  impl):
    exp, params, batch, tape, step = _jax_step(name)
    assert len(tape.shapes) == SITES[name]
    ref_loss, ref_grads, masks = step(rate)
    exp = _exp(name, rate)
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    model.train()
    tape.load(masks)
    monkeypatch.setattr(layers, "keep_mask", tape.replay)
    loss = engine.batch_loss(model, exp.train,
                             {k: torch.from_numpy(v) for k, v in batch.items()},
                             impl=impl, generator=torch.Generator())
    # every site drew its recorded mask, in order; none at rate 0
    assert tape.pos == (len(masks) if rate else 0)
    _close(loss.detach(), ref_loss, what="loss")
    loss.backward()
    for n, p in model.named_parameters():
        if p.grad is None:
            # a stream's block 0 reads no S_prev, so its gate c gets no
            # gradient; JAX's is zero
            assert n.endswith(".c")
            np.testing.assert_array_equal(ref_grads[n].numpy(), 0.0)
            continue
        _close(p.grad, ref_grads[n], what=n)


def test_ren_mme_loss_carries_the_rdrop_kl(monkeypatch):
    """JAX's training loss holds the KL: it is the ZLPR mean of the port's
    logits under the same masks plus their symmetric KL over the pairs."""
    from multimodal_emotion_processing_tpu_torch.ops.loss import (
        symmetric_sigmoid_kl, zlpr_loss)

    exp, params, batch, tape, step = _jax_step("ren_mme")
    ref_loss, _, masks = step(0.1)
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    tape.load(masks)
    monkeypatch.setattr(layers, "keep_mask", tape.replay)
    with torch.no_grad():
        logits = model.train()(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            generator=torch.Generator())
    w = torch.from_numpy(batch["sample_weight"])
    zlpr = float((zlpr_loss(logits, torch.from_numpy(batch["label"])) * w)
                 .sum() / w.sum())
    kl = float(symmetric_sigmoid_kl(logits, w[::2]))
    assert kl > 1e-4
    assert ref_loss == pytest.approx(zlpr + kl, rel=2e-5)


@pytest.mark.parametrize("name", ["ren_mme", "robot_demo"])
def test_cli_train_on_cpu(capsys, name):
    tiny = [f"--set=model.{k}={json.dumps(v)}" for k, v in TINY[name].items()]
    # the k-fold experiment: two members, each trained on 5 of 10 samples
    res = main(["train", name, "--device", "cpu", "--epochs", "2",
                "--n-train", "10", "--n-test", "3",
                "--impl", KERNEL_IMPL[name], *tiny,
                "--set", "train.batch_size=2", "--set", "train.n_folds=2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    lines = [x for x in lines if "epoch" in x]
    rows = 2 if name == "ren_mme" else 1            # R-Drop's duplicates
    assert [x["epoch"] for x in lines] == [0, 1, 0, 1]
    assert all(x["steps"] == 3 and x["samples"] == 5 * rows for x in lines)
    assert all(np.isfinite([h.train_loss, h.valid_loss]).all()
               for hist in res.fold_histories for h in hist)
