"""PyTorch port, `impl="pallas"` gradients: the autograd Function
`ScoredAttention` (over `scored_forward_plain` and `scored_backward_plain`
on the CPU) against `jax.grad` through the JAX package's
`scored_attention_pallas`, with its fused Pallas backward (`bwd_impl=
"pallas"`, interpret mode) and its einsum VJP, on the same numpy inputs:
dq, dk, dv, dS_prev, dc and dmask in the four variants (S_prev given or
not, S emitted or not), with a fully masked row whose S_prev holds -1e8 +
raw under c = 0.7, and without a mask; a loss that reads ctx and S; and a
two-block chain, both gates included.  f32 at 2e-4 after scaling by
max(1, |ref|) (tests/test_interop.py:20); dc and dmask at the scale of the
terms they sum, which cancel (±1e8-sized in a fully masked row).

The tests marked `cuda` hold the backward kernels against their plain
version on the card and skip elsewhere; they need no JAX:

    python -m pytest --noconftest tests/test_torch_scored_grad.py -q -m cuda
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as tpa  # noqa: E402

F32_TOL = 2e-4
KERNEL_F32_TOL = 1e-5    # f32, TF32 off: only the summation order differs
KERNEL_BF16_TOL = 5e-2   # bf16 operands and output (tests/test_flash.py:90)


def _inputs(b=2, lq=5, lkv=7, h=2, d=8, seed=0, mask="zero_row", c=0.7):
    """numpy q, k, v, a mask (row 0 fully masked for "zero_row", None for
    "none"), S_prev as block 0 emits it (-1e8 + raw where the mask is 0),
    the gate c, and the loss weights: w_ctx for ctx, w_s for S."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32)
               for n in (lq, lkv, lkv))
    m = None
    if mask != "none":
        m = (rng.random((b, lkv)) > 0.3).astype(np.float32)
        m[:, -1] = 1.0
        m[0] = 0.0
    sprev = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    if m is not None:
        sprev = sprev - np.float32(1e8) * (1.0 - m[:, None, None, :])
    w_ctx = rng.standard_normal((b, lq, d)).astype(np.float32)
    w_s = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    return dict(q=q, k=k, v=v, m=m, sprev=sprev,
                c=np.asarray([c], np.float32), h=h, w_ctx=w_ctx, w_s=w_s)


def _close(got, ref, tol=F32_TOL, scale=None, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()), scale or 0.0)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


def _term_scales(q, k, v, m, sprev, c, dctx, dscores, h):
    """The sizes of the terms that dc = Σ ds·S_prev and dmask =
    1e8·Σ_{h,q} ds add up, from the plain version on torch tensors:
    with |ds| ≤ p·(|dp| + |Σ dp·p|) + |dS|, Σ |ds|·|S_prev| and
    1e8·max_j Σ_{h,q} |ds|.  Those terms cancel (a row's p·(dp − Σ dp·p)
    sums to 0, and S_prev ≈ −1e8 in a fully masked row), so the results are
    no scale for their own rounding error; the terms are."""
    q, k, v, dctx = (t.float() for t in (q, k, v, dctx))
    _, s = tpa.scored_forward_plain(q, k, v, m, sprev, c, n_heads=h)
    vh, gh = (tpa.split_heads(t, h) for t in (v, dctx))
    p = torch.softmax(s, dim=-1)
    dp = gh @ vh.transpose(-2, -1)
    terms = p * (dp.abs() + (dp * p).sum(-1, keepdim=True).abs())
    if dscores is not None:
        terms = terms + dscores.abs()
    dc = 0.0 if sprev is None else float((terms * sprev.abs()).sum())
    return dc, 1e8 * float(terms.sum(dim=(1, 2)).max())


def _np_term_scales(x, has_sprev, emit):
    t = {k: None if x[k] is None else torch.from_numpy(x[k])
         for k in ("q", "k", "v", "m", "sprev", "c", "w_ctx", "w_s")}
    return _term_scales(t["q"], t["k"], t["v"], t["m"],
                        t["sprev"] if has_sprev else None, t["c"], t["w_ctx"],
                        t["w_s"] if emit else None, x["h"])


def _jax_grads(x, has_sprev, emit, bwd_impl):
    """jax.grad of Σ ctx·w_ctx (+ Σ S·w_s when S is emitted) through the
    JAX package's scored_attention_pallas, w.r.t. q, k, v, the mask, and
    S_prev and c where S_prev is given."""
    import jax
    import jax.numpy as jnp

    from multimodal_emotion_processing_tpu.ops.pallas_attention import (
        scored_attention_pallas)

    def loss(q, k, v, m, sprev, c):
        ctx, s = scored_attention_pallas(
            q, k, v, m, sprev if has_sprev else None, c, n_heads=x["h"],
            emit_scores=emit, bwd_impl=bwd_impl)
        out = jnp.sum(ctx * x["w_ctx"])
        return out + jnp.sum(s * x["w_s"]) if emit else out

    m = x["m"] if x["m"] is not None else np.ones(
        (x["q"].shape[0], x["k"].shape[1]), np.float32)
    args = [jnp.asarray(a) for a in (x["q"], x["k"], x["v"], m, x["sprev"],
                                     x["c"])]
    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    return [np.asarray(g) for g in grads]


def _port_grads(x, has_sprev, emit):
    leaves = {k: torch.from_numpy(x[k]).requires_grad_(True)
              for k in ("q", "k", "v", "sprev", "c") if x[k] is not None}
    mask = None
    if x["m"] is not None:
        mask = leaves["m"] = torch.from_numpy(x["m"]).requires_grad_(True)
    before = [kern.launches for kern in tpa.KERNELS]
    ctx, s = tpa.scored_attention_pallas(
        leaves["q"], leaves["k"], leaves["v"], mask,
        leaves["sprev"] if has_sprev else None, leaves["c"], n_heads=x["h"],
        emit_scores=emit)
    assert "ScoredAttention" in type(ctx.grad_fn).__name__
    assert (s is None) == (not emit)
    loss = (ctx * torch.from_numpy(x["w_ctx"])).sum()
    if emit:
        loss = loss + (s * torch.from_numpy(x["w_s"])).sum()
    loss.backward()
    assert [kern.launches for kern in tpa.KERNELS] == before   # CPU: plain
    return {k: t.grad for k, t in leaves.items()}


@pytest.mark.parametrize("bwd_impl", ["pallas", "einsum"])
@pytest.mark.parametrize("mask", ["zero_row", "none"])
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
def test_function_matches_jax_vjp(has_sprev, emit, mask, bwd_impl):
    x = _inputs(mask=mask, seed=1)
    ref = _jax_grads(x, has_sprev, emit, bwd_impl)
    got = _port_grads(x, has_sprev, emit)
    for i, name in enumerate("qkv"):
        _close(got[name], ref[i], what=f"d{name}")
    dc_scale, dm_scale = _np_term_scales(x, has_sprev, emit)
    if x["m"] is not None:
        _close(got["m"], ref[3], scale=dm_scale, what="dmask")
    if has_sprev:
        _close(got["sprev"], ref[4], what="dS_prev")
        _close(got["c"], ref[5], scale=dc_scale, what="dc")
        assert got["c"].dtype == torch.float32 and got["c"].shape == (1,)
    else:
        # JAX returns zeros for c and S_prev; the port none, as `xla` does
        assert got["c"] is None and got["sprev"] is None
        np.testing.assert_array_equal(ref[5], 0.0)


def test_two_block_chain_matches_jax():
    """Block 0 emits S, block 1 reads it under its own gate: the cotangent
    of block 0's S is c₁·ds₁ from block 1's dS_prev, and both gates get
    their gradients (c₀ none, as in JAX, where it is zero)."""
    import jax
    import jax.numpy as jnp

    from multimodal_emotion_processing_tpu.ops.pallas_attention import (
        scored_attention_pallas)

    x = _inputs(mask="zero_row", seed=4)
    q1 = np.random.default_rng(5).standard_normal(x["q"].shape).astype(np.float32)
    c0, c1 = np.asarray([0.4], np.float32), np.asarray([0.9], np.float32)

    def jloss(q, k, v, q1, c0, c1):
        m = jnp.asarray(x["m"])
        ctx0, s0 = scored_attention_pallas(q, k, v, m, None, c0, n_heads=x["h"],
                                           emit_scores=True, bwd_impl="pallas")
        ctx1, _ = scored_attention_pallas(q1 + ctx0, k, v, m, s0, c1,
                                          n_heads=x["h"], emit_scores=False,
                                          bwd_impl="pallas")
        return jnp.sum(ctx1 * x["w_ctx"]) + jnp.sum(ctx0 * ctx0)

    ref = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (x["q"], x["k"], x["v"], q1, c0, c1)))
    t = {k: torch.from_numpy(a).requires_grad_(True) for k, a in
         (("q", x["q"]), ("k", x["k"]), ("v", x["v"]), ("q1", q1),
          ("c0", c0), ("c1", c1))}
    m = torch.from_numpy(x["m"])
    ctx0, s0 = tpa.scored_attention_pallas(t["q"], t["k"], t["v"], m, None,
                                           t["c0"], n_heads=x["h"])
    ctx1, s1 = tpa.scored_attention_pallas(t["q1"] + ctx0, t["k"], t["v"], m,
                                           s0, t["c1"], n_heads=x["h"],
                                           emit_scores=False)
    assert s1 is None
    ((ctx1 * torch.from_numpy(x["w_ctx"])).sum() + (ctx0 * ctx0).sum()).backward()
    for name, r in zip(("q", "k", "v", "q1"), ref[:4]):
        _close(t[name].grad, r, what=name)
    assert t["c0"].grad is None
    np.testing.assert_array_equal(np.asarray(ref[4]), 0.0)
    with torch.no_grad():
        dc_scale, _ = _term_scales(t["q1"] + ctx0, t["k"], t["v"], m, s0,
                                   t["c1"], torch.from_numpy(x["w_ctx"]),
                                   None, x["h"])
    _close(t["c1"].grad, ref[5], scale=dc_scale, what="c1")


def test_backward_plain_without_autograd():
    """scored_backward_plain called directly: the emitted variant's ds
    carries dscores, and the dtypes follow `_make`'s casts."""
    x = _inputs(mask="zero_row", seed=6)
    t = {k: torch.from_numpy(x[k]) for k in ("q", "k", "v", "m", "sprev", "c")}
    ctx, s = tpa.scored_forward_plain(t["q"], t["k"], t["v"], t["m"],
                                      t["sprev"], t["c"], n_heads=x["h"])
    dq, dk, dv, dmask, dsprev, dc = tpa.scored_backward_plain(
        t["q"], t["k"], t["v"], t["m"], t["sprev"], t["c"], s,
        torch.from_numpy(x["w_s"]), torch.from_numpy(x["w_ctx"]),
        n_heads=x["h"])
    ref = _jax_grads(x, True, True, "einsum")
    for got, r in zip((dq, dk, dv, dsprev), (ref[0], ref[1], ref[2], ref[4])):
        _close(got, r)
    dc_scale, dm_scale = _np_term_scales(x, True, True)
    _close(dmask, ref[3], scale=dm_scale)
    _close(dc, ref[5], scale=dc_scale)
    assert dsprev.dtype == torch.float32 and dc.shape == (1,)
    # without a mask: no dmask; without S_prev: no dS_prev, no dc
    out = tpa.scored_backward_plain(t["q"], t["k"], t["v"], None, None,
                                    t["c"], None, None,
                                    torch.from_numpy(x["w_ctx"]),
                                    n_heads=x["h"])
    assert out[3] is None and out[4] is None and out[5] is None


def test_bare_backward_kernels_refuse_cpu_tensors_and_gradients():
    x = _inputs()
    t = {k: torch.from_numpy(x[k]) for k in ("q", "k", "v", "m", "sprev", "c",
                                               "w_ctx")}
    args = (t["q"], t["k"], t["v"], t["m"], t["sprev"], t["c"], None, None,
            t["w_ctx"])
    before = [(kern.launches, dict(kern.variant_launches))
              for kern in tpa.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        tpa.scored_backward_kernel(*args, n_heads=x["h"])
    with pytest.raises(ValueError, match="CUDA"):
        tpa.scored_backward_kernel.check(*args, n_heads=x["h"])
    grad_args = list(args)
    grad_args[0] = t["q"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="ScoredAttention"):
        tpa.scored_backward_kernel(*grad_args, n_heads=x["h"])
    grad_args[0] = t["q"]
    grad_args[8] = t["w_ctx"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="ScoredAttention"):
        tpa.scored_backward_kernel(*grad_args, n_heads=x["h"])
    assert [(kern.launches, kern.variant_launches)
            for kern in tpa.KERNELS] == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, KERNEL_F32_TOL),
                                       (torch.bfloat16, KERNEL_BF16_TOL)])
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
@pytest.mark.parametrize("b,lq,lkv,h,dh,mask", [
    (16, 50, 50, 6, 16, "zero_row"), (8, 25, 100, 6, 32, "zero_row"),
    (2, 1, 1024, 2, 16, "zero_row"), (2, 70, 300, 2, 256, "none"),
    (3, 33, 77, 3, 48, "zero_row"), (1, 5, 3, 1, 1, "zero_row")])
def test_kernels_match_plain_on_card(cuda, dtype, tol, has_sprev, emit, b, lq,
                                     lkv, h, dh, mask):
    """Each side from its own forward: the kernels from scored_fwd's S, the
    plain version from scored_forward_plain's."""
    x = _inputs(b, lq, lkv, h, h * dh, mask=mask)
    q, k, v, dctx = (torch.from_numpy(x[n]).to(dtype).to(cuda)
                     for n in ("q", "k", "v", "w_ctx"))
    c = torch.from_numpy(x["c"]).to(dtype).to(cuda)
    m = None if x["m"] is None else torch.from_numpy(x["m"]).to(cuda)
    sp = torch.from_numpy(x["sprev"]).to(cuda) if has_sprev else None
    dsc = torch.from_numpy(x["w_s"]).to(cuda) if emit else None
    ctx, s, stats = tpa.scored_forward_kernel(q, k, v, m, sp, c, n_heads=h,
                                              emit_scores=emit, stats=True)
    kernels = (tpa.scored_backward_kernel.dq, tpa.scored_backward_kernel.dkv)
    before = [kern.variant_launches[(has_sprev, emit)] for kern in kernels]
    dq, dk, dv, dmask, dsprev, dc = tpa.scored_backward_kernel(
        q, k, v, m, sp, c, s, dsc, dctx, n_heads=h, out=ctx, stats=stats)
    torch.cuda.synchronize()
    assert [kern.variant_launches[(has_sprev, emit)] for kern in kernels] \
        == [n + 1 for n in before]
    _, rs = tpa.scored_forward_plain(q, k, v, m, sp, c, n_heads=h,
                                     emit_scores=emit)
    ref = tpa.scored_backward_plain(q, k, v, m, sp, c, rs, dsc, dctx,
                                    n_heads=h)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    for got, r in zip((dq, dk, dv), ref[:3]):
        _close(got.float().cpu(), r.float().cpu(), tol)
    dc_scale, dm_scale = _term_scales(q, k, v, m, sp, c, dctx, dsc, h)
    if has_sprev:
        _close(dsprev.cpu(), ref[4].cpu(), tol)
        _close(dc.reshape(1).cpu(), ref[5].float().cpu(), tol, scale=dc_scale)
    if m is not None:
        _close(dmask.cpu(), ref[3].float().cpu(), tol, scale=dm_scale)
