"""PyTorch port, `impl="pallas"`: the score-chained attention of
ops/pallas_attention.py.  On the CPU its wrapper takes the plain version,
held here against the JAX package's `scored_attention_pallas` (its Pallas
kernel in interpret mode) on the same numpy inputs: the four kernel
variants (S_prev given or not, S emitted or not), no mask, a fully masked
row whose S_prev holds -1e8 under gate c = 0.7, and the 3-D mask route.
ctx at 2e-4 after scaling by max(1, |ref|) (tests/test_interop.py:20), S
elementwise at rtol 2e-4: its masked entries sit near -1e8 or -(1 + c)·1e8,
where the f32 spacing is 8 to 16.

The tests marked `cuda` hold the kernel against its plain version on the
card and skip elsewhere; they need no JAX:

    python -m pytest --noconftest tests/test_torch_scored_attention.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch.ops import attention as tattn  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as tpa  # noqa: E402

F32_TOL = 2e-4
KERNEL_F32_TOL = 1e-5    # f32, TF32 off: only the summation order differs
KERNEL_BF16_TOL = 5e-2   # bf16 operands and output (tests/test_flash.py:90)


def _inputs(b=2, lq=5, lkv=7, h=2, d=8, seed=0, mask="zero_row", c=0.7):
    """numpy q, k, v, a mask (row 0 fully masked for "zero_row"; None for
    "none"; (B, Lq, Lkv) for "3d"), an S_prev as block 0 emits it (-1e8
    where the mask is 0) and the gate c."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32)
               for n in (lq, lkv, lkv))
    m = None
    if mask == "3d":
        m = (rng.random((b, lq, lkv)) > 0.3).astype(np.float32)
    elif mask != "none":
        m = (rng.random((b, lkv)) > 0.3).astype(np.float32)
        m[:, -1] = 1.0
        m[0] = 0.0
    sprev = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    if m is not None and m.ndim == 2:
        sprev = sprev - np.float32(1e8) * (1.0 - m[:, None, None, :])
    return q, k, v, m, sprev, np.asarray([c], np.float32), h


def _t(x, dtype=torch.float32, device="cpu"):
    return None if x is None else torch.from_numpy(x).to(dtype).to(device)


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


def _jax_pallas(q, k, v, m, sprev, c, h, emit):
    import jax.numpy as jnp

    from multimodal_emotion_processing_tpu.ops.pallas_attention import (
        scored_attention_pallas)

    return scored_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m),
        None if sprev is None else jnp.asarray(sprev), jnp.asarray(c),
        n_heads=h, emit_scores=emit)


@pytest.mark.parametrize("mask", ["zero_row", "none"])
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
def test_plain_matches_jax_pallas(has_sprev, emit, mask):
    q, k, v, m, sprev, c, h = _inputs(mask=mask)
    sprev = sprev if has_sprev else None
    jctx, js = _jax_pallas(q, k, v, m, sprev, c, h, emit)
    ctx, s = tattn.scored_attention(_t(q), _t(k), _t(v), _t(m), _t(sprev),
                                    _t(c), n_heads=h, impl="pallas",
                                    emit_scores=emit)
    _close(ctx, jctx, F32_TOL)
    if not emit:
        assert s is None and js is None
        return
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=F32_TOL,
                               atol=F32_TOL)


def test_fully_masked_row_is_uniform_in_a_chained_block():
    """Row 0's keys are all masked and its S_prev is -1e8 + raw: under
    c = 0.7 every score is -(1 + 0.7)·1e8 to the f32 spacing (16), so the
    row averages v over its real keys, as the JAX kernel has it."""
    q, k, v, m, sprev, c, h = _inputs(lq=3, lkv=40, mask="zero_row")
    q = 0.1 * q
    sprev = np.where(m[:, None, None, :] == 0, np.float32(-1e8), sprev)
    ctx, s = tpa.scored_attention_pallas(_t(q), _t(k), _t(v), _t(m),
                                         _t(sprev), _t(c), n_heads=h)
    assert torch.all(s[0] < -1.69e8) and torch.all(s[0] > -1.71e8)
    _close(ctx[0], np.broadcast_to(v[0].mean(axis=0), (3, v.shape[-1])), 1e-5)
    _close(ctx, _jax_pallas(q, k, v, m, sprev, c, h, True)[0], F32_TOL)


def test_3d_mask_takes_the_plain_path():
    """As in JAX: a 3-D mask goes to the xla path, which returns its scores
    even when none are asked for."""
    from multimodal_emotion_processing_tpu.ops import attention as jattn
    import jax.numpy as jnp

    q, k, v, m, sprev, c, h = _inputs(mask="3d", seed=2)
    jctx, js = jattn.scored_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        jnp.asarray(sprev), jnp.asarray(c), n_heads=h, impl="xla")
    before = tpa.scored_forward_kernel.launches
    ctx, s = tpa.scored_attention_pallas(_t(q), _t(k), _t(v), _t(m),
                                         _t(sprev), _t(c), n_heads=h,
                                         emit_scores=False)
    assert tpa.scored_forward_kernel.launches == before
    _close(ctx, jctx, F32_TOL)
    _close(s, js, F32_TOL)


def test_gradients_are_refused():
    """The bare kernel wrappers record no autograd graph: the forward
    kernel and the backward wrapper of its two kernels refuse inputs that
    need a gradient, pointing to ScoredAttention, on the CPU too.  The
    routing wrapper `scored_attention_pallas` takes every call through
    ScoredAttention instead, and returns a graph where one is needed."""
    q, k, v, m, sprev, c, h = _inputs()
    dctx = _t(np.ones_like(q))
    for i in range(6):
        args = [_t(x) for x in (q, k, v, m, sprev, c)]
        args[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match="ScoredAttention"):
            tpa.scored_forward_kernel(*args, n_heads=h)
        with pytest.raises(RuntimeError, match="ScoredAttention"):
            tpa.scored_backward_kernel(*args, None, None, dctx, n_heads=h)
        ctx, s = tpa.scored_attention_pallas(*args, n_heads=h)
        assert "ScoredAttention" in type(ctx.grad_fn).__name__
        assert s.requires_grad
        (ctx.sum() + s[s > -1e7].sum()).backward()
        assert args[i].grad is not None
    with torch.no_grad():
        ctx, _ = tpa.scored_attention_pallas(*args, n_heads=h)
    assert ctx.grad_fn is None


def test_kernel_takes_cuda_tensors_only():
    q, k, v, m, sprev, c, h = _inputs()
    before = (tpa.scored_forward_kernel.launches,
              dict(tpa.scored_forward_kernel.variant_launches))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.scored_forward_kernel(_t(q), _t(k), _t(v), _t(m), _t(sprev), _t(c),
                                  n_heads=h)
    assert (tpa.scored_forward_kernel.launches,
            tpa.scored_forward_kernel.variant_launches) == before


def test_capture_ledger_is_keyed_by_the_capture_stream():
    """A launch counts into the ledger of the capture its stream belongs to,
    from whichever thread launches it (autograd runs a captured backward
    on its own device thread, on the forward's stream): a stub kernel
    launched on the captured stream from a second thread lands in the
    ledger and not in its counts; a launch on another stream, or after the
    capture, counts; crediting the ledger adds its replays' launches."""
    import threading

    from multimodal_emotion_processing_tpu_torch.ops import cuda_binding

    class Stub(cuda_binding.Kernel):
        name = "stub"

        def launch(self, stream):
            self._count(stream=stream)

    stub = Stub()
    captured, other = 0x7000, 0x7008   # raw stream handles
    with cuda_binding.capture_ledger(captured) as ledger:
        worker = threading.Thread(target=lambda: (stub.launch(captured),
                                                  stub.launch(captured)))
        worker.start()
        worker.join()
        stub.launch(other)
    assert stub.launches == 1
    assert ledger == {(stub, "launches", None): 2}
    stub.launch(captured)
    assert stub.launches == 2
    cuda_binding.credit(ledger, times=3)
    assert stub.launches == 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, KERNEL_F32_TOL),
                                       (torch.bfloat16, KERNEL_BF16_TOL)])
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
@pytest.mark.parametrize("b,lq,lkv,h,dh,mask", [
    (8, 25, 100, 6, 32, "zero_row"), (8, 100, 25, 6, 32, "zero_row"),
    (2, 1, 1024, 2, 16, "zero_row"), (2, 70, 300, 2, 256, "none"),
    (3, 33, 77, 3, 48, "zero_row"), (1, 5, 3, 1, 1, "zero_row")])
def test_kernel_matches_plain_on_card(cuda, dtype, tol, has_sprev, emit, b, lq,
                                      lkv, h, dh, mask):
    q, k, v, m, sprev, c, _ = _inputs(b, lq, lkv, h, h * dh, mask=mask)
    q, k, v, c = (_t(x, dtype, cuda) for x in (q, k, v, c))
    m, sprev = _t(m, device=cuda), _t(sprev, device=cuda) if has_sprev else None
    before = tpa.scored_forward_kernel.variant_launches[(has_sprev, emit)]
    ctx, s = tpa.scored_forward_kernel(q, k, v, m, sprev, c, n_heads=h,
                                       emit_scores=emit)
    torch.cuda.synchronize()
    assert tpa.scored_forward_kernel.variant_launches[(has_sprev, emit)] \
        == before + 1
    rctx, rs = tpa.scored_forward_plain(q, k, v, m, sprev, c, n_heads=h,
                                        emit_scores=emit)
    assert ctx.dtype == dtype
    _close(ctx.float().cpu(), rctx.float().cpu(), tol)
    if emit:
        np.testing.assert_allclose(s.cpu().numpy(), rs.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert s is None


@pytest.mark.cuda
def test_kernel_validates_before_launch(cuda):
    q, k, v, m, sprev, c, h = (_t(x, device=cuda) if isinstance(x, np.ndarray)
                               else x for x in _inputs())
    with pytest.raises(ValueError, match="scores_prev"):
        tpa.scored_forward_kernel(q, k, v, m, sprev[:, :1], c, n_heads=h)
    with pytest.raises(ValueError, match="gate c"):
        tpa.scored_forward_kernel(q, k, v, m, sprev, None, n_heads=h)
    with pytest.raises(ValueError, match="mask"):
        tpa.scored_forward_kernel(q, k, v, m[:, :3], None, c, n_heads=h)
