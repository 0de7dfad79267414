"""PyTorch port, the rounding plan of csrc/fused_block.cu on the CPU.

The kernel cannot run here, so `tiled_fused` below does in plain torch what
it does, in its order:

- each head's attention as tests/test_torch_scored_rounding.py's tiled
  model (`tiled_forward`: split-TF32 score dots, the chained score, online
  softmax over steps of 16 keys, P·V with P split into terms), which is the
  kernel's per-head body (csrc/scored_head.cuh, shared with scored_fwd);
- the epilogue's three products, x = ctx·W_projᵀ, then y = q·W_minus[:, :D]ᵀ
  continued by x·W_minus[:, D:]ᵀ, each operand as two TF32 terms and three
  products, k zero-padded to a multiple of 32 and taken 16 deep at a time
  from zero, each slice added to the output in f32 (scored_mma.cuh
  `mma_rowsW`);
- the LayerNorm as each of the kernel's two paths sums it.  The cluster
  path splits it over the C = min(H, 8) blocks of a cluster: block r owns
  the 8-column tiles n ≡ r (mod C), sums its columns in order, and the C
  partial sums are added in rank order 0 … C−1.  The tile path (one block
  holds every head of a row tile) gives a row to 8 lanes of a warp: lane l
  sums columns l, l + 8, … in order, and the 8 sums are added by the xor
  butterfly 4, 2, 1.  Both sum y for the mean, then (y − mean)² for the
  biased variance.

That model, with either order, is held against the JAX package's
`fused_minus_block` (its Pallas kernel in interpret mode, as
tests/test_torch_fused_block.py runs it) at the 2e-4 of
tests/test_interop.py in all four variants, and against the port's
`fused_block_plain` at the kernel's 1e-5.  At D 1024 one TF32 term per
operand misses that 1e-5 where three meet it.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_scored_rounding as sr  # noqa: E402

from multimodal_emotion_processing_tpu_torch.ops import fused_block as tfb  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as tpa  # noqa: E402

JAX_TOL = 2e-4       # tests/test_interop.py:20
KERNEL_TOL = 1e-5    # the kernel against its plain version, f32
LN_EPS = 1e-5
CLUSTER_MAX = 8      # blocks of a cluster (the portable cluster size)
K_PAD = 32           # the products' k is padded to a multiple of 32


def _pad_k(x, kp):
    return torch.nn.functional.pad(x, (0, kp - x.shape[-1]))


def cluster_layer_norm(y, ln_w, ln_b, n_blocks):
    """LayerNorm over the last dim as the kernel's cluster takes it: block
    r sums its own 8-column tiles (n ≡ r mod n_blocks) column by column,
    and the partials are added in rank order, for the mean and then for
    the biased variance."""
    d = y.shape[-1]
    cols = [[c for c in range(d) if (c // 8) % n_blocks == r]
            for r in range(n_blocks)]

    def cluster_sum(terms):
        tot = torch.zeros(terms.shape[:-1])
        for own in cols:
            part = torch.zeros(terms.shape[:-1])
            for col in own:
                part = part + terms[..., col]
            tot = tot + part
        return tot

    inv_d = 1.0 / d
    mean = cluster_sum(y) * inv_d
    dv = y - mean[..., None]
    rstd = torch.rsqrt(cluster_sum(dv * dv) * inv_d + LN_EPS)
    return dv * rstd[..., None] * ln_w + ln_b


def _fma(a, b, c):
    """fmaf(a, b, c): the f32 product is exact in f64, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def tile_layer_norm(y, ln_w, ln_b, lanes=8):
    """LayerNorm over the last dim as the tile path takes it: a row to 8
    lanes, lane l summing columns l, l + 8, … in order from zero (the
    variance's terms by fmaf), the lanes' sums added by the xor butterfly
    4, 2, 1 (each lane adds its partner's sum to its own), for the mean and
    then for the biased variance."""
    d = y.shape[-1]
    inv_d = torch.tensor(1.0, dtype=torch.float32) / d

    def butterfly(parts):
        off = lanes // 2
        while off:
            parts = [parts[i] + parts[i ^ off] for i in range(lanes)]
            off //= 2
        return parts[0]

    parts = [torch.zeros(y.shape[:-1]) for _ in range(lanes)]
    for col in range(d):
        parts[col % lanes] = parts[col % lanes] + y[..., col]
    mean = butterfly(parts) * inv_d
    dv = y - mean[..., None]
    parts = [torch.zeros(y.shape[:-1]) for _ in range(lanes)]
    for col in range(d):
        parts[col % lanes] = _fma(dv[..., col], dv[..., col], parts[col % lanes])
    rstd = torch.rsqrt(butterfly(parts) * inv_d + LN_EPS)
    return dv * rstd[..., None] * ln_w + ln_b


LAYER_NORMS = {"cluster": lambda y, w, b, h: cluster_layer_norm(
                   y, w, b, min(h, CLUSTER_MAX)),
               "tile": lambda y, w, b, h: tile_layer_norm(y, w, b)}


def tiled_fused(q, k, v, mask, sprev, c, ws, h, n_terms=3, path="cluster"):
    """(out, S, m, l) of the whole block, in the kernel's order on `path`."""
    proj_w, minus_w, ln_w, ln_b = ws
    d = q.shape[-1]
    kp = -(-d // K_PAD) * K_PAD
    ctx, s, m, l = sr.tiled_forward(q, k, v, mask, sprev, c, h, n_terms)
    x = sr.sliced_dots(_pad_k(ctx, kp), _pad_k(proj_w, kp), n_terms)
    # y = q·W_minus[:, :D]ᵀ, continued by x·W_minus[:, D:]ᵀ: one run of slices
    a = torch.cat([_pad_k(q, kp), _pad_k(x, kp)], dim=-1)
    w = torch.cat([_pad_k(minus_w[:, :d], kp), _pad_k(minus_w[:, d:], kp)],
                  dim=-1)
    y = sr.sliced_dots(a, w, n_terms)
    out = LAYER_NORMS[path](y, ln_w, ln_b, h)
    return out, s, m, l


def _inputs(b=2, lq=20, lkv=40, h=6, dh=16, seed=0, c=0.7):
    """numpy q, k, v, a mask with row 0 fully masked, S_prev as block 0
    emits it (−1e8 + raw where the mask is 0), the gate c and one block's
    weights in torch's layout: proj (D, D), minus (D, 2D), the LayerNorm's
    scale and bias away from 1 and 0."""
    rng = np.random.default_rng(seed)
    d = h * dh
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32)
               for n in (lq, lkv, lkv))
    m = (np.arange(lkv)[None, :] < rng.integers(1, lkv + 1, size=b)[:, None])
    m = m.astype(np.float32)
    m[0] = 0.0
    sprev = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    sprev = sprev - np.float32(1e8) * (1.0 - m[:, None, None, :])
    bound = 1.0 / np.sqrt(d)
    ws = [rng.uniform(-bound, bound, (d, d)).astype(np.float32),
          rng.uniform(-bound, bound, (d, 2 * d)).astype(np.float32),
          (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          (0.1 * rng.standard_normal(d)).astype(np.float32)]
    return dict(q=q, k=k, v=v, m=m, sprev=sprev,
                c=np.asarray([c], np.float32), h=h, ws=ws)


def _torch(x):
    t = {n: torch.from_numpy(x[n]) for n in ("q", "k", "v", "m", "sprev", "c")}
    return t, [torch.from_numpy(w) for w in x["ws"]]


def _jax(x, has_sprev):
    """The JAX package's fused_minus_block on the same values: out and S
    (the JAX layout takes proj (in, out) and minus (2D, D))."""
    import jax.numpy as jnp

    from multimodal_emotion_processing_tpu.ops.fused_block import (
        fused_minus_block)

    proj, minus, scale, bias = x["ws"]
    out, s = fused_minus_block(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["m"]), jnp.asarray(x["sprev"]) if has_sprev else None,
        jnp.asarray(x["c"]), jnp.asarray(proj.T), jnp.asarray(minus.T),
        jnp.asarray(scale), jnp.asarray(bias), n_heads=x["h"])
    return np.asarray(out), np.asarray(s)


@pytest.mark.parametrize("path", sorted(LAYER_NORMS))
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
def test_tiled_model_matches_jax_and_plain(has_sprev, emit, path):
    x = _inputs(seed=21)
    t, ws = _torch(x)
    sp = t["sprev"] if has_sprev else None
    out, s, m, l = tiled_fused(t["q"], t["k"], t["v"], t["m"], sp, t["c"], ws,
                               x["h"], path=path)
    jout, js = _jax(x, has_sprev)
    assert sr._err(out, jout) <= JAX_TOL
    # masked entries sit near −1e8 or −(1 + c)·1e8: each at its own scale
    rel = np.abs(s.numpy() - js) / np.maximum(1.0, np.abs(js))
    assert rel.max() <= KERNEL_TOL

    pout, ps = tfb.fused_block_plain(t["q"], t["k"], t["v"], t["m"], sp,
                                     t["c"], *ws, n_heads=x["h"],
                                     emit_scores=emit)
    assert sr._err(out, pout) <= KERNEL_TOL
    if emit:
        rel = (s - ps).abs() / ps.abs().clamp(min=1.0)
        assert float(rel.max()) <= KERNEL_TOL
    # the row stats the kernel writes for the backward: m the row max of
    # S, l the sum of exp(S − m)
    assert torch.equal(m, s.amax(dim=-1))
    ref_l = torch.exp(s.double() - m.double()[..., None]).sum(dim=-1)
    assert float(((l.double() - ref_l).abs() / ref_l).max()) <= 1e-6


@pytest.mark.parametrize("path", sorted(LAYER_NORMS))
def test_cluster_layer_norm_is_layer_norm(path):
    """Each path's order is the plain LayerNorm at f32's accuracy: the
    cluster's C-way split with rank-order partials for every cluster size
    a model of the repo takes, the tile path's 8-lane butterfly."""
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((3, 5, 96)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(96)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(96)).astype(np.float32))
    ref = torch.nn.functional.layer_norm(y.double(), (96,), w.double(),
                                         bias.double(), LN_EPS)
    for h in ((1, 6, 8) if path == "cluster" else (6,)):
        got = LAYER_NORMS[path](y, w, bias, h)
        assert sr._err(got, ref) <= 1e-6


def test_one_tf32_term_misses_the_kernel_bound_at_d1024():
    """Why every operand of the epilogue's products is split: at D 1024
    (8 heads of 128, the s1024 preset's block) one TF32 term per operand
    moves out past 1e-5 of the plain f32 version; three terms stay inside
    it."""
    x = _inputs(b=1, lq=4, lkv=8, h=8, dh=128, seed=9)
    t, ws = _torch(x)
    pout, _ = tfb.fused_block_plain(t["q"], t["k"], t["v"], t["m"],
                                    t["sprev"], t["c"], *ws, n_heads=x["h"])
    errs = {}
    for n_terms in (1, 3):
        out, _, _, _ = tiled_fused(t["q"], t["k"], t["v"], t["m"], t["sprev"],
                                   t["c"], ws, x["h"], n_terms)
        errs[n_terms] = sr._err(out, pout)
    assert errs[3] <= KERNEL_TOL, errs
    assert errs[1] > KERNEL_TOL, errs
    assert math.isfinite(errs[1])
