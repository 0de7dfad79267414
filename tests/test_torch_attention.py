"""PyTorch port, attention: the plain path and the flash wrapper (its plain
version on the CPU) against the JAX package's `impl="xla"` oracle, on the
same numpy inputs, in f32 at 1e-5 after scaling by max(1, |ref|).

Also pins the padding fault of the JAX flash wrapper: with kv zero-padded to
a multiple of 128, a fully masked row averages over the padded length.  The
port masks the ragged edge instead and agrees with the oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.ops import attention as jattn  # noqa: E402
from multimodal_emotion_processing_tpu.ops import flash_attention as jfa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import attention as tattn  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops.pooling import mean_max_pool  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 5e-2


def _inputs(b=2, lq=20, lkv=200, h=2, d=32, seed=0, zero_row=False,
            mask="2d"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, lkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lkv, d)).astype(np.float32)
    if mask == "none":
        m = None
    elif mask == "3d":
        m = (rng.random((b, lq, lkv)) > 0.3).astype(np.float32)
    else:
        m = (rng.random((b, lkv)) > 0.3).astype(np.float32)
        if zero_row:
            m[0, :] = 0.0
    return q, k, v, m


def _close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


def _jax_xla(q, k, v, m, h, dtype=jnp.float32):
    c = jnp.zeros((1,), jnp.float32)
    mask = None if m is None else jnp.asarray(m, dtype)
    return jattn.scored_attention(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                                  jnp.asarray(v, dtype), mask, None, c,
                                  n_heads=h, impl="xla", emit_scores=True)


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("port", ["plain", "flash"])
@pytest.mark.parametrize("lkv,zero_row,mask", [
    (20, True, "2d"), (100, True, "2d"), (200, True, "2d"),
    (200, False, "none"), (256, False, "2d"), (7, False, "2d")])
def test_attention_matches_jax_xla(port, lkv, zero_row, mask):
    q, k, v, m = _inputs(lkv=lkv, zero_row=zero_row, mask=mask)
    ref_ctx, ref_scores = _jax_xla(q, k, v, m, 2)
    c = torch.zeros(1)
    if port == "plain":
        ctx, scores = tattn.scored_attention(_t(q), _t(k), _t(v), _t(m), None, c,
                                             n_heads=2, impl="xla")
        _close(scores, ref_scores, F32_TOL)
    else:
        ctx, scores = tfa.flash_scored_attention(_t(q), _t(k), _t(v), _t(m), c,
                                                 n_heads=2)
        assert scores is None
    _close(ctx, ref_ctx, F32_TOL)


def test_padding_fault_is_not_copied():
    """b=2, lq=20, lkv=200, dh=16, row 0 fully masked: JAX `flash` pads kv to
    256 and its row 0 is uniform over 256 keys; the oracle's (and the
    port's) is uniform over the 200 real ones."""
    q, k, v, m = _inputs(b=2, lq=20, lkv=200, h=2, d=32, zero_row=True)
    ref = np.asarray(_jax_xla(q, k, v, m, 2)[0])
    jflash = np.asarray(jfa.flash_scored_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        jnp.zeros((1,)), n_heads=2)[0])
    port = tfa.flash_scored_attention(_t(q), _t(k), _t(v), _t(m), torch.zeros(1),
                                      n_heads=2)[0].numpy()
    _close(port, ref, F32_TOL)
    assert np.abs(jflash[0] - ref[0]).max() > 1e-2       # the JAX fault
    _close(jflash[1], ref[1], F32_TOL)                   # unmasked row agrees


def test_chained_scores_and_3d_mask_match_jax():
    """The plain path's score chain (scores_prev, gate c) and 3-D masks."""
    q, k, v, m3 = _inputs(lq=6, lkv=9, mask="3d", seed=3)
    rng = np.random.default_rng(4)
    sprev = rng.standard_normal((2, 2, 6, 9)).astype(np.float32)
    c = np.asarray([0.41], np.float32)
    ref_ctx, ref_s = jattn.scored_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m3),
        jnp.asarray(sprev), jnp.asarray(c), n_heads=2, impl="xla")
    for impl in ("xla", "flash"):    # flash falls back: the scores are chained
        ctx, s = tattn.scored_attention(_t(q), _t(k), _t(v), _t(m3), _t(sprev),
                                        _t(c), n_heads=2, impl=impl)
        _close(ctx, ref_ctx, F32_TOL)
        _close(s, ref_s, F32_TOL)


def test_flash_falls_back_where_it_must_emit_scores():
    q, k, v, m = _inputs(lq=8, lkv=200, seed=5)
    ref_ctx, ref_s = _jax_xla(q, k, v, m, 2)
    ctx, s = tattn.scored_attention(_t(q), _t(k), _t(v), _t(m), None,
                                    torch.zeros(1), n_heads=2, impl="flash",
                                    emit_scores=True)
    _close(ctx, ref_ctx, F32_TOL)
    _close(s, ref_s, F32_TOL)


def test_bf16_matches_jax_xla():
    q, k, v, m = _inputs(lq=16, lkv=100, zero_row=True, seed=6)
    ref = _jax_xla(q, k, v, m, 2, dtype=jnp.bfloat16)[0]
    for impl in ("xla", "flash"):
        ctx, _ = tattn.scored_attention(
            _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
            _t(m, torch.bfloat16), None, torch.zeros(1), n_heads=2, impl=impl,
            emit_scores=False)
        assert ctx.dtype == torch.bfloat16
        _close(ctx.float(), np.asarray(ref, np.float32), BF16_TOL)


@pytest.mark.parametrize("lq,lkv,mask_kind,sprev,emit,dh", [
    (64, 256, "2d", False, False, 128), (64, 256, "none", False, False, 128),
    (64, 256, "2d", True, False, 128), (64, 256, "2d", False, True, 128),
    (64, 256, "3d", False, False, 128), (64, 200, "2d", False, False, 16),
    (64, 256, "2d", False, False, 256), (64, 256, "2d", False, False, 512)])
def test_flash_supported_gating_is_verbatim(lq, lkv, mask_kind, sprev, emit, dh):
    shapes = {"2d": (2, lkv), "3d": (2, lq, lkv)}
    jm = None if mask_kind == "none" else jnp.ones(shapes[mask_kind])
    tm = None if mask_kind == "none" else torch.ones(shapes[mask_kind])
    js = jnp.zeros((2, 2, lq, lkv)) if sprev else None
    ts = torch.zeros(2, 2, lq, lkv) if sprev else None
    assert (tfa.flash_supported(lq, lkv, tm, ts, emit, dh)
            == jfa.flash_supported(lq, lkv, jm, js, emit, dh))


def test_unported_impl_raises():
    """`pallas_fused` is the whole minus block in one kernel: `MinusBlock`
    routes it to ops/fused_block.py and `RealformerBlock` to `pallas`, so
    no path reaches the attention alone with it, which raises."""
    q, k, v, m = _inputs(lq=4, lkv=8)
    with pytest.raises(NotImplementedError):
        tattn.scored_attention(_t(q), _t(k), _t(v), _t(m), None, torch.zeros(1),
                               n_heads=2, impl="pallas_fused")


def test_mean_max_pool_matches_jax():
    from multimodal_emotion_processing_tpu.ops.pooling import (
        mean_max_pool as jpool)

    x = np.random.default_rng(7).standard_normal((3, 11, 5)).astype(np.float32)
    _close(mean_max_pool(torch.from_numpy(x)), jpool(jnp.asarray(x)), F32_TOL)


def test_mean_max_pool_gradient_on_ties_matches_jax():
    """Tied maxima: the whole gradient goes to the first maximal row, as JAX
    `seq_max` routes it (torch.amax would split it).  x (1, 4, 2): column 0
    all zero, column 1 = [1, 3, 3, 0]; weights w = [1, 2, 3, 4] on the
    pooled (mean, mean, max, max) features."""
    import jax

    from multimodal_emotion_processing_tpu.ops.pooling import (
        mean_max_pool as jpool)

    x = np.zeros((1, 4, 2), np.float32)
    x[0, :, 1] = [1.0, 3.0, 3.0, 0.0]
    w = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(jpool(a) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (mean_max_pool(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ref[0, :, 0], [3.25, 0.25, 0.25, 0.25])
    np.testing.assert_allclose(ref[0, :, 1], [0.5, 4.5, 0.5, 0.5])
    np.testing.assert_array_equal(xt.grad.numpy(), ref)
