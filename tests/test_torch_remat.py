"""PyTorch port, per-block rematerialisation (`ModelConfig.remat`,
models/grid.rematerialized_block) on the CPU at tiny widths, in training
with dropout 0.1 active: `robot_demo` (two chained RealFormer blocks a
stream, gates set) and `ren_mme` (minus blocks, R-Drop), at `impl="xla"`
and at the family's kernel impl on its plain CPU path.  With remat on,
the loss and every step-1 gradient equal those with remat off, bit for
bit, under the same keep masks (the masks are drawn before each
checkpointed block and read again by its recompute), each block's forward
runs twice, and both are within 2e-4 (tests/test_interop.py:20) of the
JAX package's `remat=True` (`jax.checkpoint` of each block call) from the
same weights and masks (test_torch_rdrop.MaskTape).  Under bf16 compute
the recompute sees the forward's bf16 weight copies."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.models import layers as jlayers  # noqa: E402
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model, layers  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402
from test_torch_rdrop import KERNEL_IMPL, MaskTape, TINY, _batch, _close, _jexp, _perturb  # noqa: E402
from torch_driver_common import one_intra_op_thread  # noqa: E402,F401

FAMILIES = ("robot_demo", "ren_mme")


def _exp(name, remat):
    exp = configs.get(name)
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, **TINY[name], dropout=0.1, remat=remat))


@functools.lru_cache(maxsize=None)
def _jax_remat(name):
    """(perturbed params, batch, tape, JAX's loss, step-1 gradients as a
    port state dict, masks) of `batch_loss` in training at impl xla with
    remat=True under the tape's masks."""
    jexp = _jexp(_exp(name, True))
    assert jexp.model.remat
    jmodel = jbuild(jexp)
    params = _perturb(jmodel.init(jax.random.PRNGKey(0)), 1)
    batch = _batch(_exp(name, True))
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
        masks = tape.draw(0.1, seed=2)
        loss, g = grads(params, masks, jnp.float32(0.9))
    finally:
        jlayers.dropout = original
    return (params, batch, tape, float(loss),
            from_jax_params(jax.device_get(g), jexp.model), masks)


def _port_step(name, remat, impl, monkeypatch, params, batch, tape, masks):
    """The port's loss and step-1 gradients under the tape's masks, and
    how many block forwards ran."""
    exp = _exp(name, remat)
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    model.train()
    tape.load(masks)
    monkeypatch.setattr(layers, "keep_mask", tape.replay)
    calls = {"n": 0}
    for cls in (layers.MinusBlock, layers.RealformerBlock):
        def counted(self, *args, _forward=cls.forward, **kw):
            calls["n"] += 1
            return _forward(self, *args, **kw)

        monkeypatch.setattr(cls, "forward", counted)
    blocks = [m for m in model.modules()
              if isinstance(m, (layers.MinusBlock, layers.RealformerBlock))]
    loss = engine.batch_loss(model, exp.train,
                             {k: torch.from_numpy(v) for k, v in batch.items()},
                             impl=impl, generator=torch.Generator())
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    monkeypatch.undo()
    assert tape.pos == len(masks), "every site drew its recorded mask"
    return loss.detach(), dict(zip(names, grads)), calls["n"], len(blocks)


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "kernel"])
def test_remat_changes_nothing_but_the_recompute(name, kernel, monkeypatch):
    impl = KERNEL_IMPL[name] if kernel else "xla"
    params, batch, tape, ref_loss, ref_grads, masks = _jax_remat(name)
    off = _port_step(name, False, impl, monkeypatch, params, batch, tape, masks)
    on = _port_step(name, True, impl, monkeypatch, params, batch, tape, masks)
    assert torch.equal(on[0], off[0])
    for n, g_off in off[1].items():
        g_on = on[1][n]
        if g_off is None:
            # a stream's block 0 reads no S_prev: its gate c gets no gradient
            assert g_on is None and n.endswith(".c")
            continue
        assert torch.equal(g_on, g_off), n
    assert off[2] == off[3] and on[2] == 2 * on[3]   # the recompute ran
    _close(on[0], ref_loss, what="loss")
    for n, g in on[1].items():
        if g is None:
            np.testing.assert_array_equal(ref_grads[n].numpy(), 0.0)
            continue
        _close(g, ref_grads[n], what=n)


def test_remat_under_bf16_compute():
    """The scale presets compute in bf16 from f32 masters (a functional
    call on bf16 copies): the recompute must run on the same copies, and
    the gradients land in the masters bit-equal to remat off."""
    exp = configs.get("mosei_trans_s1024")
    small = dict(l_len=4, v_len=6, a_len=8, dim=16, n_heads=2, l_dim=5,
                 v_dim=4, a_dim=3)
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset

    out = []
    for remat in (False, True):
        e = dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, **small, remat=remat))
        assert e.train.compute_dtype == "bfloat16"
        batch = next(iter(Batcher(synthetic_dataset(e.name, e.model, 4, seed=1),
                                  4, shuffle=False)()))
        model = build_model(e, device="cpu", seed=3).train()
        loss = engine.batch_loss(
            model, e.train, {k: torch.from_numpy(v) for k, v in batch.items()},
            impl="flash")
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()), allow_unused=True)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or (
            a.dtype == torch.float32 and torch.equal(a, b))
