"""PyTorch port, the rounding plan of the bf16 flash kernels on the CPU.

The bf16 kernels of csrc/flash_fwd.cu and csrc/flash_bwd.cu cannot run here,
so `tiled_forward` and `tiled_backward` below do in plain torch what they
do, in their order:

- scores from bf16 q and k in f32, then an online softmax over kv tiles of
  BKV keys: running max m and sum l in f32, l summed from the f32 p;
- P enters O += P·V as a sum of bf16 terms (t0 = bf16(p), t1 = bf16(p −
  t0), ...; three in the kernels), never as f32;
- the backward rebuilds p = exp(s − m)/l from the forward's m and l, takes
  ds = p(dp − delta) in f32, feeds P and dS to dV, dQ and dK as the same
  bf16 terms, and sums dmask = 1e8 Σ_q ds from the f32 ds.

That model is held against the JAX package's flash forward and custom VJP
in bf16 (its Pallas kernels in interpret mode, called without the wrapper's
kv padding, which would let padded keys into a fully masked row's softmax)
at the 5e-2 normalised bound of tests/test_flash.py, and against the port's
plain versions (`flash_forward_plain`, `flash_backward_plain`) with m and l
at 1e-5.  The last test shows why the kernels split P and dS into terms: a
single bf16 term rounds the output to another bf16 value than the f32
softmax path in many more places.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.ops import flash_attention as jfa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops.attention import (  # noqa: E402
    MASK_PENALTY, merge_heads, split_heads)

BF16_TOL = 5e-2     # tests/test_flash.py: bf16 operands and outputs
STATS_TOL = 1e-5    # m and l stay f32 in the kernels
BKV = 64            # the kernels' kv tile
N_TERMS = 3         # bf16 terms of P and dS (csrc/flash_mma.cuh kSplit)


def bf16_terms(x, n_terms):
    """x (f32) as n_terms bf16 values (held in f32) that sum to it."""
    terms = []
    for _ in range(n_terms):
        t = x.to(torch.bfloat16).float()
        terms.append(t)
        x = x - t
    return terms


def split_mm(a, b, n_terms):
    """a @ b with a fed as bf16 terms and b already bf16-valued, summed in
    f32 as the kernels' one accumulator takes them."""
    out = None
    for t in bf16_terms(a, n_terms):
        part = t @ b
        out = part if out is None else out + part
    return out


def _heads(x, n_heads):
    return split_heads(x, n_heads).float()


def _neg(mask, lkv):
    if mask is None:
        return torch.zeros(lkv)
    return MASK_PENALTY * (1.0 - mask.float())


def tiled_forward(q, k, v, mask, n_heads, n_terms=N_TERMS):
    """o at q's dtype and the row stats m, l (B, H, Lq) f32, tile by tile."""
    qh, kh, vh = (_heads(t, n_heads) for t in (q, k, v))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    neg = _neg(mask, kh.shape[2])
    neg = neg[:, None, None, :] if neg.ndim == 2 else neg
    b, h, lq, dh = qh.shape
    m = torch.full((b, h, lq), -torch.finfo(torch.float32).max)
    l = torch.zeros(b, h, lq)
    acc = torch.zeros(b, h, lq, dh)
    for kv0 in range(0, kh.shape[2], BKV):
        sl = slice(kv0, kv0 + BKV)
        s = (qh @ kh[:, :, sl].transpose(-2, -1)) * scale - neg[..., sl]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + split_mm(p, vh[:, :, sl], n_terms)
        m = m_new
    return merge_heads(acc / l[..., None]).to(q.dtype), m, l


def tiled_backward(q, k, v, mask, o, do, m, l, n_heads, n_terms=N_TERMS):
    """(dq, dk, dv) at q's dtype and dmask (B, Lkv) f32 or None."""
    qh, kh, vh, oh, doh = (_heads(t, n_heads) for t in (q, k, v, o, do))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    neg = _neg(mask, kh.shape[2])
    neg = neg[:, None, None, :] if neg.ndim == 2 else neg
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    dmh = torch.zeros(kh.shape[0], kh.shape[1], kh.shape[2])
    for kv0 in range(0, kh.shape[2], BKV):
        sl = slice(kv0, kv0 + BKV)
        s = (qh @ kh[:, :, sl].transpose(-2, -1)) * scale - neg[..., sl]
        p = torch.exp(s - m[..., None]) * (1.0 / l[..., None])
        ds = p * (doh @ vh[:, :, sl].transpose(-2, -1) - delta)
        dq += split_mm(ds, kh[:, :, sl], n_terms)
        dk[:, :, sl] = split_mm(ds.transpose(-2, -1).contiguous(), qh, n_terms)
        dv[:, :, sl] = split_mm(p.transpose(-2, -1).contiguous(), doh, n_terms)
        dmh[..., sl] = MASK_PENALTY * ds.sum(dim=2)
    dmask = None if mask is None else dmh.sum(dim=1)
    return (merge_heads(dq * scale).to(q.dtype),
            merge_heads(dk * scale).to(k.dtype),
            merge_heads(dv).to(v.dtype), dmask)


def _inputs(b, lq, lkv, h, dh, mask_kind, seed=0):
    """bf16 q, k, v, do and an f32 mask (None, or row 0 fully masked and a
    ragged valid prefix elsewhere), from numpy."""
    rng = np.random.default_rng(seed)
    d = h * dh
    q, k, v, do = (rng.standard_normal((b, n, d)).astype(np.float32)
                   for n in (lq, lkv, lkv, lq))
    mask = None
    if mask_kind == "zero_row":
        lens = rng.integers(1, lkv + 1, size=b)
        mask = (np.arange(lkv)[None, :] < lens[:, None]).astype(np.float32)
        mask[0] = 0.0
    to_bf16 = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    return (to_bf16(q), to_bf16(k), to_bf16(v),
            None if mask is None else torch.from_numpy(mask), to_bf16(do))


def _jax_flash(q, k, v, mask, do, h):
    """The JAX package's flash forward and VJP in bf16 on the same values:
    its custom VJP without the wrapper's kv padding."""
    b, _, _ = q.shape
    lkv = k.shape[1]
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    jm = (jnp.ones((b, lkv), jnp.bfloat16) if mask is None
          else jnp.asarray(mask.numpy()).astype(jnp.bfloat16))
    fn = jfa._make_flash(h, None, None)
    o, vjp = jax.vjp(lambda q_, k_, v_, m_: fn(q_, k_, v_, m_, jnp.zeros((1,))),
                     as_jax(q), as_jax(k), as_jax(v), jm)
    grads = vjp(as_jax(do))
    return [torch.from_numpy(np.array(x.astype(jnp.float32)))
            for x in (o,) + tuple(grads)]


def _close(got, ref, tol):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    scale = max(1.0, ref.abs().max().item())
    err = (got - ref).abs().max().item() / scale
    assert err <= tol, err


CASES = [(lq, lkv, dh, mask) for dh in (16, 128)
         for (lq, lkv) in ((20, 77), (37, 200))
         for mask in ("zero_row", "none")]


@pytest.mark.parametrize("lq,lkv,dh,mask_kind", CASES)
def test_rounding_plan_matches_jax_flash_and_plain(lq, lkv, dh, mask_kind):
    h = 2
    q, k, v, mask, do = _inputs(2, lq, lkv, h, dh, mask_kind,
                                seed=lq + lkv + dh)
    o, m, l = tiled_forward(q, k, v, mask, h)
    grads = tiled_backward(q, k, v, mask, o, do, m, l, h)

    ref = _jax_flash(q, k, v, mask, do, h)
    _close(o, ref[0], BF16_TOL)
    for got, want in zip(grads[:3], ref[1:4]):
        _close(got, want, BF16_TOL)
    if mask is not None:
        _close(grads[3], ref[4], BF16_TOL)

    po, pm, pl = tfa.flash_forward_plain(q, k, v, mask, n_heads=h, stats=True)
    _close(o, po, BF16_TOL)
    # m is about -1e8 in the masked row: each row at its own scale
    assert ((m - pm).abs() / pm.abs().clamp(min=1.0)).max().item() <= STATS_TOL
    _close(l, pl, STATS_TOL)
    plain = tfa.flash_backward_plain(q, k, v, mask, po, do, pm, pl, n_heads=h)
    for got, want in zip(grads[:3], plain[:3]):
        assert got.dtype == torch.bfloat16
        _close(got, want, BF16_TOL)
    if mask is None:
        assert grads[3] is None and plain[3] is None
    else:
        _close(grads[3], plain[3], BF16_TOL)


def test_fully_masked_row_is_uniform_over_real_keys():
    """Row 0's mask is all zero: the tiled model averages v over its Lkv
    keys only (the kernels never pad kv), for raw scores well inside +-4."""
    q, k, v, mask, _ = _inputs(2, 5, 77, 2, 16, "zero_row")
    o, _, l = tiled_forward((0.1 * q.float()).to(torch.bfloat16), k, v, mask, 2)
    _close(o[0], v[0].float().mean(dim=0).expand(5, -1), BF16_TOL / 10)
    assert torch.allclose(l[0], torch.full_like(l[0], 77.0))


def test_three_terms_round_like_the_f32_softmax():
    """Why P and dS enter as three bf16 terms: with one, the bf16 output
    lands on another bf16 value than the f32-softmax path's in many
    places; with three, in almost none."""
    q, k, v, mask, do = _inputs(2, 37, 200, 2, 128, "zero_row", seed=7)
    po, pm, pl = tfa.flash_forward_plain(q, k, v, mask, n_heads=2, stats=True)
    pgrads = tfa.flash_backward_plain(q, k, v, mask, po, do, pm, pl, n_heads=2)
    differ = {}
    for n_terms in (1, 3):
        o, m, l = tiled_forward(q, k, v, mask, 2, n_terms=n_terms)
        grads = tiled_backward(q, k, v, mask, po, do, pm, pl, 2,
                               n_terms=n_terms)
        differ[n_terms] = [(got != want).float().mean().item() for got, want
                           in zip((o,) + grads[:3], (po,) + pgrads[:3])]
    for one, three in zip(differ[1], differ[3]):
        assert three * 10 < one and three < 0.02, differ
