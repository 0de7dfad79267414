"""PyTorch port, flash attention gradients on the CPU: the autograd Function
(`FlashAttention` over `flash_forward_plain` and `flash_backward_plain`)
against the JAX package's VJPs on the same numpy inputs, dq, dk, dv and
dmask, in f32 at 1e-5 after scaling by max(1, |ref|); and the plain row
stats m, l against the JAX forward kernel's (interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.ops import attention as jattn  # noqa: E402
from multimodal_emotion_processing_tpu.ops import flash_attention as jfa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import flash_attention as tfa  # noqa: E402

F32_TOL = 1e-5


def _inputs(b=2, lq=20, lkv=200, h=2, d=32, seed=0, zero_row=False,
            no_mask=False, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (q_scale * rng.standard_normal((b, lq, d))).astype(np.float32)
    k = rng.standard_normal((b, lkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lkv, d)).astype(np.float32)
    m = (rng.random((b, lkv)) > 0.3).astype(np.float32)
    if zero_row:
        m[0] = 0.0
    w = rng.standard_normal((b, lq, d)).astype(np.float32)
    return q, k, v, None if no_mask else m, w


def _close(got, ref, tol=F32_TOL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol)


def _jax_grads(impl, q, k, v, m, w, h):
    """Gradients of sum(o · w) by the JAX package's attention: `xla` is
    scored_attention's einsum path, `flash` the Pallas VJP (interpret mode
    on the CPU)."""
    def loss(*args):
        q_, k_, v_ = args[:3]
        m_ = args[3] if m is not None else None
        if impl == "flash":
            o, _ = jfa.flash_scored_attention(q_, k_, v_, m_, jnp.zeros((1,)),
                                              n_heads=h)
        else:
            o, _ = jattn.scored_attention(q_, k_, v_, m_, None, jnp.zeros((1,)),
                                          n_heads=h, impl="xla",
                                          emit_scores=False)
        return jnp.sum(o * w)

    args = [jnp.asarray(x) for x in (q, k, v) + ((m,) if m is not None else ())]
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _port_grads(q, k, v, m, w, h):
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (q, k, v) + ((m,) if m is not None else ())]
    mask = leaves[3] if m is not None else None
    before = [kern.launches for kern in tfa.KERNELS]
    o, _ = tfa.flash_scored_attention(*leaves[:3], mask, torch.zeros(1),
                                      n_heads=h)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    (o * torch.from_numpy(w)).sum().backward()
    assert [kern.launches for kern in tfa.KERNELS] == before   # CPU: plain
    return [t.grad for t in leaves]


@pytest.mark.parametrize("lkv,zero_row,no_mask,q_scale", [
    (20, True, False, 1.0), (77, True, False, 1.0), (200, False, False, 1.0),
    (200, True, False, 1.0), (256, False, True, 1.0), (40, True, False, 4.0)])
def test_function_matches_jax_xla_vjp(lkv, zero_row, no_mask, q_scale):
    """Ragged kv lengths and fully masked rows: the port masks the ragged
    edge, so it agrees with the einsum path at every length.  q_scale 4
    puts the masked row's raw scores across +-4."""
    q, k, v, m, w = _inputs(lkv=lkv, zero_row=zero_row, no_mask=no_mask,
                            q_scale=q_scale)
    ref = _jax_grads("xla", q, k, v, m, w, 2)
    got = _port_grads(q, k, v, m, w, 2)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("lkv,zero_row", [(128, True), (256, False)])
def test_function_matches_jax_flash_vjp(lkv, zero_row):
    """At kv lengths the JAX wrapper does not pad, its Pallas VJP (interpret
    mode) and the port's Function agree, fully masked rows included."""
    q, k, v, m, w = _inputs(b=2, lq=16, lkv=lkv, h=2, d=32, zero_row=zero_row,
                            seed=3)
    ref = _jax_grads("flash", q, k, v, m, w, 2)
    got = _port_grads(q, k, v, m, w, 2)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("lq,lkv,blocks", [(24, 128, (None, None)),
                                           (64, 256, (32, 128))])
def test_plain_stats_match_jax_forward(lq, lkv, blocks):
    """m and l against JAX `_flash_forward(..., emit_stats=True)`, column 0
    of its lane-broadcast (B, H, Lq, 128) stats: the whole-sequence kernel
    and, with explicit blocks, the tiled one."""
    q, k, v, m, _ = _inputs(lq=lq, lkv=lkv, zero_row=True, seed=5)
    h = 2
    neg = jnp.asarray(jattn.MASK_PENALTY * (m - 1.0)).reshape(2, 1, lkv)
    split = [jattn.split_heads(jnp.asarray(x), h) for x in (q, k, v)]
    jo, (jm, jl) = jfa._flash_forward(*split, neg, emit_stats=True,
                                      block_q=blocks[0], block_kv=blocks[1])
    o, ms, ls = tfa.flash_forward_plain(
        *(torch.from_numpy(x) for x in (q, k, v, m)), n_heads=h, stats=True)
    jm, jl = np.asarray(jm)[..., 0], np.asarray(jl)[..., 0]
    assert ms.shape == jm.shape == (2, h, lq)
    # m is about -1e8 in the masked row: each row at its own scale
    assert (np.abs(ms.numpy() - jm) / np.maximum(np.abs(jm), 1.0)).max() <= F32_TOL
    _close(ls, jl)
    _close(o, jattn.merge_heads(jo))


def test_backward_plain_matches_jax_xla_without_autograd():
    """flash_backward_plain called directly, dmask summed over heads."""
    q, k, v, m, w = _inputs(lkv=77, zero_row=True, seed=9)
    t = [torch.from_numpy(x) for x in (q, k, v, m, w)]
    o, ms, ls = tfa.flash_forward_plain(*t[:4], n_heads=2, stats=True)
    got = tfa.flash_backward_plain(*t[:4], o, t[4], ms, ls, n_heads=2)
    ref = _jax_grads("xla", q, k, v, m, w, 2)
    for g, r in zip(got, ref):
        _close(g, r)
