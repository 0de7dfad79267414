"""PyTorch port, the rounding plan of the score-chained kernels on the CPU.

The kernels of csrc/scored_fwd.cu and csrc/scored_bwd.cu cannot run here, so
`tiled_forward` and `tiled_backward` below do in plain torch what they do,
in their order:

- every product takes each f32 operand as two TF32 values, hi = tf32(x) and
  lo = tf32(x − hi) (`tf32` emulates cvt.rna.tf32.f32), and takes the
  terms 8-wide chunk by chunk: hi·hi into one f32 accumulator, lo·hi and
  hi·lo into another, added once at the end (csrc/scored_mma.cuh);
  products over keys or query rows go 16 deep at a time, the slice's second
  chunk as −a_hi·b_hi into a third accumulator that is subtracted, each
  slice added to the running sum in f32;
- the forward: s = q·k·scale (+ c·S_prev) − 1e8·(1 − mask), each step
  rounded on its own, then an online softmax over steps of 16 keys, P·V
  with P split into terms, and the row stats m, l;
- the backward, one sweep over the keys: p = exp(s − m)·(1/l) from the
  forward's stats, delta = dctx·ctx (at bf16 Σ p·dp, from a first sweep),
  ds = p(dp − delta) (+ dS), dS_prev = c·ds, dc = Σ ds·S_prev, dq += ds·K,
  and per tile dk = dsᵀ·Q, dv = pᵀ·dctx.

That model is held against the JAX package's scored VJP (its Pallas kernels
in interpret mode, as tests/test_torch_scored_grad.py runs them) at the 2e-4
of tests/test_interop.py in all four variants, and against the port's plain
versions at the kernels' 1e-5.  One TF32 term misses that 1e-5 where three
meet it.  One test pins the one-chain rule: in a chained, fully masked row
(S_prev ≈ −1e8) raw dots from two chains can land on different s bits,
which moves p by a factor e^16, while one chain gives the same bits however
the keys are tiled.  The last shows why bf16 inputs take delta from a sweep
over the keys: their ctx comes back rounded to bf16.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as tpa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops.attention import (  # noqa: E402
    MASK_PENALTY, merge_heads, split_heads)

JAX_TOL = 2e-4       # tests/test_interop.py:20
KERNEL_TOL = 1e-5    # the kernels against their plain versions, f32
BF16_TOL = 5e-2      # the same at bf16 (tests/test_flash.py:47-52)
STEP = 16            # keys a warp takes in one step (csrc/scored_mma.cuh kSub)
CHUNK = 8            # the k width of one mma.m16n8k8


def tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 explicit mantissa bits, ties away
    from zero, held in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _terms(x, n_terms):
    if n_terms == 1:
        return [tf32(x)]
    hi = tf32(x)
    return [hi, tf32(x - hi)]


def _chunk(x, y, k0):
    """One chunk's products, summed in order (TF32 products are exact in
    f32)."""
    part = torch.zeros(x.shape[:-1] + (y.shape[-2],))
    for kk in range(k0, min(k0 + CHUNK, x.shape[-1])):
        part = part + x[..., :, None, kk] * y[..., None, :, kk]
    return part


def chain_dots(a, b, n_terms=3, alternate=False):
    """Σ_k a[..., i, k]·b[..., j, k] in f32 as the kernels take it: chunk by
    chunk of 8, hi·hi into one accumulator and lo·hi, hi·lo into another
    (one hi·hi term alone with n_terms 1), the two added at the end.  With
    `alternate` (the products over keys or rows) odd chunks take −a_hi·b_hi
    into a third accumulator, subtracted.  Elementwise, so an element does
    not depend on the tile around it."""
    at, bt = _terms(a, n_terms), _terms(b, n_terms)
    main = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    neg, corr = torch.zeros_like(main), torch.zeros_like(main)
    for i, k0 in enumerate(range(0, a.shape[-1], CHUNK)):
        if n_terms == 3:
            corr = corr + _chunk(at[1], bt[0], k0)
            corr = corr + _chunk(at[0], bt[1], k0)
        if alternate and i % 2:
            neg = neg + _chunk(-at[0], bt[0], k0)
        else:
            main = main + _chunk(at[0], bt[0], k0)
    return (main - neg) + corr


def sliced_dots(a, b, n_terms=3):
    """chain_dots over a long k (keys or query rows) 16 deep at a time, each
    slice from zero and added to the running sum in f32."""
    acc = None
    for k0 in range(0, a.shape[-1], STEP):
        part = chain_dots(a[..., k0:k0 + STEP], b[..., k0:k0 + STEP], n_terms,
                          alternate=True)
        acc = part if acc is None else acc + part
    return acc


def scalar_dots(a, b):
    """Another chain: a sequential f32 sum over d, as a scalar kernel takes
    it."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for kk in range(a.shape[-1]):
        acc = acc + a[..., :, None, kk] * b[..., None, :, kk]
    return acc


def chained(dots, scale, sprev, c, neg):
    """flash_common.cuh `chained_score`: each step rounded on its own."""
    x = dots * scale
    if sprev is not None:
        x = x + c * sprev
    return x - neg


def _neg(mask, b, lkv):
    if mask is None:
        return torch.zeros(b, 1, 1, lkv)
    return (MASK_PENALTY * (1.0 - mask.float()))[:, None, None, :]


def tiled_forward(q, k, v, mask, sprev, c, h, n_terms=3, bkv=STEP,
                  dots=None):
    """(ctx, S, m, l) with ctx (B, Lq, D), S (B, H, Lq, Lkv), m, l (B, H,
    Lq), tile by tile."""
    dots = dots or (lambda a, b_: chain_dots(a, b_, n_terms))
    qh, kh, vh = (split_heads(t, h).float() for t in (q, k, v))
    b, _, lq, dh = qh.shape
    lkv = kh.shape[2]
    scale = 1.0 / math.sqrt(dh)
    cv = None if sprev is None else c.float().reshape(())
    neg = _neg(mask, b, lkv)
    m = torch.full((b, h, lq), -torch.finfo(torch.float32).max)
    l = torch.zeros(b, h, lq)
    acc = torch.zeros(b, h, lq, dh)
    scores = []
    for kv0 in range(0, lkv, bkv):
        sl = slice(kv0, kv0 + bkv)
        s = chained(dots(qh, kh[:, :, sl]), scale,
                    None if sprev is None else sprev[..., sl], cv, neg[..., sl])
        scores.append(s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = (acc * alpha[..., None]
               + sliced_dots(p, vh[:, :, sl].transpose(-2, -1), n_terms))
        m = m_new
    return merge_heads(acc / l[..., None]), torch.cat(scores, -1), m, l


def tiled_backward(q, k, v, mask, sprev, c, scores, dscores, dctx, ctx, m, l,
                   h, n_terms=3, bkv=STEP, dots=None, sweep_delta=False):
    """(dq, dk, dv, dmask or None, dS_prev or None, dc or None) from the
    forward's ctx and stats, one sweep over the kv tiles; s read from
    `scores` or rebuilt through `dots` where it is None.  With
    `sweep_delta` (bf16) delta is Σ p·dp from a first sweep, not
    dctx·ctx."""
    dots = dots or (lambda a, b_: chain_dots(a, b_, n_terms))
    qh, kh, vh, gh, oh = (split_heads(t, h).float()
                          for t in (q, k, v, dctx, ctx))
    b, _, lq, dh = qh.shape
    lkv = kh.shape[2]
    scale = 1.0 / math.sqrt(dh)
    cv = None if sprev is None else c.float().reshape(())
    neg = _neg(mask, b, lkv)
    inv_l = 1.0 / l[..., None]

    def tile_p(sl):
        if scores is not None:
            s = scores[..., sl]
        else:
            s = chained(dots(qh, kh[:, :, sl]), scale,
                        None if sprev is None else sprev[..., sl], cv,
                        neg[..., sl])
        return torch.exp(s - m[..., None]) * inv_l

    if sweep_delta:
        delta = sum((tile_p(slice(kv0, kv0 + bkv))
                     * chain_dots(gh, vh[:, :, kv0:kv0 + bkv], n_terms)
                     ).sum(dim=-1, keepdim=True) for kv0 in range(0, lkv, bkv))
    else:
        delta = (gh * oh).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    dmh = torch.zeros(b, h, lkv)
    dsprev = None if sprev is None else torch.zeros(b, h, lq, lkv)
    dc = torch.zeros(())
    for kv0 in range(0, lkv, bkv):
        sl = slice(kv0, kv0 + bkv)
        p = tile_p(sl)
        ds = p * (chain_dots(gh, vh[:, :, sl], n_terms) - delta)
        if dscores is not None:
            ds = ds + dscores[..., sl]
        if sprev is not None:
            dsprev[..., sl] = cv * ds
            dc = dc + (ds * sprev[..., sl]).sum()
        dq = dq + sliced_dots(ds, kh[:, :, sl].transpose(-2, -1), n_terms)
        dk[:, :, sl] = sliced_dots(ds.transpose(-2, -1),
                                   qh.transpose(-2, -1), n_terms)
        dv[:, :, sl] = sliced_dots(p.transpose(-2, -1), gh.transpose(-2, -1),
                                   n_terms)
        dmh[..., sl] = MASK_PENALTY * ds.sum(dim=2)
    return (merge_heads(dq * scale), merge_heads(dk * scale), merge_heads(dv),
            None if mask is None else dmh.sum(dim=1), dsprev,
            None if sprev is None else dc.reshape(1))


def _inputs(b=2, lq=20, lkv=77, h=2, dh=16, seed=0, c=0.7):
    """numpy q, k, v, a mask with row 0 fully masked, S_prev as block 0
    emits it (−1e8 + raw where the mask is 0), the gate c and the
    cotangents of ctx and S."""
    rng = np.random.default_rng(seed)
    d = h * dh
    q, k, v, w_ctx = (rng.standard_normal((b, n, d)).astype(np.float32)
                      for n in (lq, lkv, lkv, lq))
    m = (np.arange(lkv)[None, :] < rng.integers(1, lkv + 1, size=b)[:, None])
    m = m.astype(np.float32)
    m[0] = 0.0
    sprev = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    sprev = sprev - np.float32(1e8) * (1.0 - m[:, None, None, :])
    w_s = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    return dict(q=q, k=k, v=v, m=m, sprev=sprev,
                c=np.asarray([c], np.float32), h=h, w_ctx=w_ctx, w_s=w_s)


def _jax(x, has_sprev, emit):
    """The JAX package's scored_attention_pallas on the same values: ctx,
    S, and jax.grad of Σ ctx·w_ctx (+ Σ S·w_s) through its Pallas backward
    w.r.t. q, k, v, the mask, S_prev and c."""
    import jax
    import jax.numpy as jnp

    from multimodal_emotion_processing_tpu.ops.pallas_attention import (
        scored_attention_pallas)

    def run(q, k, v, m, sprev, c):
        return scored_attention_pallas(
            q, k, v, m, sprev if has_sprev else None, c, n_heads=x["h"],
            emit_scores=emit, bwd_impl="pallas")

    def loss(*args):
        ctx, s = run(*args)
        out = jnp.sum(ctx * x["w_ctx"])
        return out + jnp.sum(s * x["w_s"]) if emit else out

    args = [jnp.asarray(x[n]) for n in ("q", "k", "v", "m", "sprev", "c")]
    ctx, s = run(*args)
    grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
    return [np.asarray(ctx), None if s is None else np.asarray(s)] + [
        np.asarray(g_) for g_ in grads]


def _err(got, ref, scale=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max(), scale or 0.0)


def _term_scales(s, v, dctx, sprev, dscores, h):
    """The sizes of the terms that dc and dmask sum (they cancel), as in
    tests/test_torch_scored_grad.py."""
    vh, gh = (split_heads(t, h) for t in (v, dctx))
    p = torch.softmax(s, dim=-1)
    dp = gh @ vh.transpose(-2, -1)
    terms = p * (dp.abs() + (dp * p).sum(-1, keepdim=True).abs())
    if dscores is not None:
        terms = terms + dscores.abs()
    dc = 0.0 if sprev is None else float((terms * sprev.abs()).sum())
    return dc, 1e8 * float(terms.sum(dim=(1, 2)).max())


def _model(x, has_sprev, emit, n_terms=3):
    t = {n: torch.from_numpy(x[n]) for n in ("q", "k", "v", "m", "sprev", "c",
                                             "w_ctx", "w_s")}
    sp = t["sprev"] if has_sprev else None
    ctx, s, m, l = tiled_forward(t["q"], t["k"], t["v"], t["m"], sp, t["c"],
                                 x["h"], n_terms)
    grads = tiled_backward(t["q"], t["k"], t["v"], t["m"], sp, t["c"],
                           s if emit else None, t["w_s"] if emit else None,
                           t["w_ctx"], ctx, m, l, x["h"], n_terms)
    return t, sp, ctx, s, grads


@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
def test_tiled_model_matches_jax_vjp_and_plain(has_sprev, emit):
    x = _inputs(seed=11)
    t, sp, ctx, s, grads = _model(x, has_sprev, emit)
    ref = _jax(x, has_sprev, emit)
    assert _err(ctx, ref[0]) <= JAX_TOL
    if emit:
        # masked entries sit near −1e8 or −(1 + c)·1e8: each at its own scale
        rel = np.abs(s.numpy() - ref[1]) / np.maximum(1.0, np.abs(ref[1]))
        assert rel.max() <= KERNEL_TOL
    dsc = t["w_s"] if emit else None
    dc_scale, dm_scale = _term_scales(s, t["v"], t["w_ctx"], sp, dsc, x["h"])
    for got, want in zip(grads[:3], ref[2:5]):
        assert _err(got, want) <= JAX_TOL
    assert _err(grads[3], ref[5], dm_scale) <= JAX_TOL
    if has_sprev:
        assert _err(grads[4], ref[6]) <= JAX_TOL
        assert _err(grads[5], ref[7], dc_scale) <= JAX_TOL

    pctx, ps = tpa.scored_forward_plain(t["q"], t["k"], t["v"], t["m"], sp,
                                        t["c"], n_heads=x["h"])
    assert _err(ctx, pctx) <= KERNEL_TOL
    plain = tpa.scored_backward_plain(t["q"], t["k"], t["v"], t["m"], sp,
                                      t["c"], ps if emit else None, dsc,
                                      t["w_ctx"], n_heads=x["h"])
    for got, want in zip(grads[:3], plain[:3]):
        assert _err(got, want) <= KERNEL_TOL
    assert _err(grads[3], plain[3], dm_scale) <= KERNEL_TOL
    if has_sprev:
        assert _err(grads[4], plain[4]) <= KERNEL_TOL
        assert _err(grads[5], plain[5], dc_scale) <= KERNEL_TOL


def test_one_tf32_term_misses_the_kernel_bound():
    """Why every operand is split: with one TF32 term per operand ctx, dq,
    dk and dv move past 1e-5 of the plain f32 versions; with three terms
    they stay inside it."""
    x = _inputs(seed=5, dh=32)
    errs = {}
    for n_terms in (1, 3):
        t, sp, ctx, s, grads = _model(x, True, True, n_terms)
        pctx, ps = tpa.scored_forward_plain(t["q"], t["k"], t["v"], t["m"], sp,
                                            t["c"], n_heads=x["h"])
        plain = tpa.scored_backward_plain(t["q"], t["k"], t["v"], t["m"], sp,
                                          t["c"], ps, t["w_s"], t["w_ctx"],
                                          n_heads=x["h"])
        errs[n_terms] = [_err(ctx, pctx)] + [_err(got, want) for got, want
                                             in zip(grads[:3], plain[:3])]
    assert max(errs[3]) <= KERNEL_TOL, errs
    assert min(errs[1]) > KERNEL_TOL, errs


def _straddling_rows(n_rows, dh, seed=3):
    """q rows whose raw dot with key 0, scaled by 1/√dh, lands on a value
    where chain_dots and scalar_dots give different s bits after
    chained() with this row's S_prev (≈ −1e8, c = 0.7) and the full mask
    penalty: found by aiming x = dot·scale at ±4 and ±12, where
    fl(x + c·S_prev) steps by 8."""
    rng = np.random.default_rng(seed)
    n = 4096
    cand = rng.standard_normal((n, dh))
    key = rng.standard_normal((1, dh)).astype(np.float32)
    target = rng.choice([-12.0, -4.0, 4.0, 12.0], size=n)
    scale = 1.0 / math.sqrt(dh)
    cand = (cand * (target / (cand @ key[0].astype(np.float64) * scale))[:, None]
            ).astype(np.float32)
    raw_prev = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32))
    sprev = raw_prev * scale - MASK_PENALTY        # block 0's S, masked
    qa, ka = torch.from_numpy(cand), torch.from_numpy(key)
    c = torch.tensor(0.7)
    s_a = chained(chain_dots(qa, ka), scale, sprev, c, MASK_PENALTY)
    s_b = chained(scalar_dots(qa, ka), scale, sprev, c, MASK_PENALTY)
    found = torch.nonzero(s_a[:, 0] != s_b[:, 0])[:, 0][:n_rows]
    assert len(found) == n_rows
    return qa[found], ka, sprev[found]


def test_one_chain_in_a_fully_masked_chained_row():
    """Rows whose mask is all zero, under S_prev ≈ −1e8 from a previous
    block: key 0 carries each row's maximum (the other keys' S_prev sits
    4096 lower), and its s lands on another multiple of 16 through the
    scalar chain than through the tensor-core chain.  The forward's S is
    the same bits under two tilings of the keys, and a backward that
    rebuilds s through the same chain returns the bits of one that reads
    S; rebuilt through the other chain, p at key 0 moves from 1 to e^±16
    and the gradients with it."""
    dh, lq, lkv = 16, 8, 77
    q_rows, key0, sprev0 = _straddling_rows(lq, dh)
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.standard_normal((1, lkv, dh)).astype(np.float32))
    k[0, 0] = key0[0]
    v, dctx = (torch.from_numpy(rng.standard_normal((1, n, dh)).astype(np.float32))
               for n in (lkv, lq))
    q = q_rows[None]
    mask = torch.zeros(1, lkv)
    sprev = torch.full((1, 1, lq, lkv), -1e8 - 4096.0)
    sprev[0, 0, :, 0] = sprev0[:, 0]
    c = torch.tensor([0.7])

    ctx, s, m, l = tiled_forward(q, k, v, mask, sprev, c, 1)
    _, s64, _, _ = tiled_forward(q, k, v, mask, sprev, c, 1, bkv=64)
    _, s_other, _, _ = tiled_forward(q, k, v, mask, sprev, c, 1,
                                     dots=scalar_dots)
    assert torch.equal(s, s64)
    assert (s_other[..., 0] != s[..., 0]).all()
    assert (s[..., 0] == m).all()       # key 0 holds each row's maximum

    read = tiled_backward(q, k, v, mask, sprev, c, s, None, dctx, ctx, m, l, 1)
    same = tiled_backward(q, k, v, mask, sprev, c, None, None, dctx, ctx, m, l,
                          1, bkv=64)
    other = tiled_backward(q, k, v, mask, sprev, c, None, None, dctx, ctx, m,
                           l, 1, dots=scalar_dots)
    for a, b in zip(read[:3], same[:3]):
        assert torch.equal(a, b)
    p = torch.exp(s[..., 0] - m) / l
    p_other = torch.exp(s_other[..., 0] - m) / l
    assert ((p_other - p).abs() > 0.5).all()
    assert max(_err(a, b) for a, b in zip(other[:3], read[:3])) > 1e-2


def test_bf16_takes_delta_from_a_sweep():
    """At bf16 the forward's ctx comes back rounded to bf16, and delta =
    dctx·ctx with it moves dk past the bf16 bound in fully masked rows with
    q x 4, where p sits on a few keys; delta = Σ p·dp, which scored_bwd_dq
    takes in a first sweep at bf16, keeps dk well inside.  Both against the
    backward evaluated in f64 from the same S, dk rounded to bf16 as the
    kernel stores it."""
    rng = np.random.default_rng(35)
    b, lq, lkv, h, dh = 2, 64, 77, 2, 16
    bf16 = torch.bfloat16
    q, k, v, dctx = (torch.from_numpy(rng.standard_normal((b, n, h * dh))
                                      .astype(np.float32)).to(bf16).float()
                     for n in (lq, lkv, lkv, lq))
    q = (q * 4).to(bf16).float()
    m = (np.arange(lkv)[None, :] < rng.integers(1, lkv + 1, size=b)[:, None])
    m = m.astype(np.float32)
    m[0] = 0.0
    mask = torch.from_numpy(m)
    ctx, s, mx, l = tiled_forward(q, k, v, mask, None, None, h)
    ctx = ctx.to(bf16).float()
    exact = tpa.scored_backward_plain(q.double(), k.double(), v.double(), mask,
                                      None, None, s.double(), None,
                                      dctx.double(), n_heads=h)[1]
    errs = {}
    for sweep in (False, True):
        dk = tiled_backward(q, k, v, mask, None, None, s, None, dctx, ctx, mx,
                            l, h, sweep_delta=sweep)[1]
        errs[sweep] = ((dk.to(bf16).double() - exact).abs()
                       / exact.abs().clamp(min=1.0)).max().item()
    assert errs[False] > BF16_TOL, errs
    assert errs[True] <= BF16_TOL / 5, errs
