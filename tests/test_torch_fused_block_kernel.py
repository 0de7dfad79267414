"""PyTorch port, `impl="pallas_fused"` on the card: csrc/fused_block.cu
`fused_block` against its plain version `fused_block_plain` on the same
CUDA tensors, in its four variants (S_prev given or not, S emitted or
not), f32 with TF32 off and bf16: out within 1e-5 (f32) and 5e-2 (bf16) of
max(1, |ref|), S at rtol 1e-5 elementwise and bit-equal to
csrc/scored_fwd.cu's S on the same inputs, and the ctx residual against
the plain attention.  At the shapes that stress the cluster launch (one
head, more heads than a cluster holds, D 1024, Lq 1, ren_mme at B 1 and
B 8) and at mosei_trans's stream shapes at B 64 (the tile path: one block
holds every head of a row tile) the row stats m are bit-equal to
scored_fwd's and l within 1e-6 relative, out and S are the same bits over
two launches, each shape's launch takes the path `geometry()` reports, and
`FusedMinusBlock`'s f32 gradients with the stats lie within 1e-6 of those
without them.  Then `FusedMinusBlock`'s gradients against the same
Function on the CPU.  Every test here needs a GPU and skips without one;
they need no JAX:

    python -m pytest --noconftest tests/test_torch_fused_block_kernel.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch.ops import fused_block as tfb  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as tpa  # noqa: E402

F32_TOL = 1e-5    # f32, TF32 off: only the summation order differs
BF16_TOL = 5e-2   # bf16 operands and output (tests/test_flash.py:90)
S_RTOL = 1e-5
GRAD_TOL = 2e-4   # the CPU and card backwards, f32 (tests/test_interop.py:20)
L_RTOL = 1e-6     # l against scored_fwd's: the key split may differ
STATS_GRAD_TOL = 1e-6   # one key sweep in dq against two, f32
# (B, Lq, Lkv, H, dh, mask): one head (a cluster of one block), 12 heads
# of 8 (more than a cluster's 8 blocks), D 1024, Lq 1, ren_mme's three
# query lengths at B 1 and B 8
CLUSTER_SHAPES = [
    (2, 37, 77, 1, 64, "zero_row"), (2, 40, 100, 12, 8, "zero_row"),
    (2, 33, 128, 8, 128, "zero_row"), (3, 1, 100, 6, 16, "zero_row"),
    (1, 40, 275, 8, 16, "zero_row"), (1, 76, 40, 8, 16, "zero_row"),
    (1, 275, 76, 8, 16, "zero_row"), (8, 40, 275, 8, 16, "zero_row"),
    (8, 76, 40, 8, 16, "zero_row"), (8, 275, 76, 8, 16, "zero_row")]
# mosei_trans's stream shapes at its batch 64, 6 heads of 16: the tile path
MOSEI_SHAPES = [(64, 20, 200, 6, 16, "zero_row"),
                (64, 200, 20, 6, 16, "zero_row"),
                (64, 200, 200, 6, 16, "zero_row")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, lq, lkv, h, dh, mask, dtype, device, seed=0):
    """q, k, v, a mask (row 0 fully masked for "zero_row"; None for
    "none"), S_prev as a block emits it (-1e8 + raw where the mask is 0),
    c = 0.7, and the block's weights in torch's layout."""
    rng = np.random.default_rng(seed)
    d = h * dh

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt).to(device)

    q, k, v = (t(rng.standard_normal((b, n, d))) for n in (lq, lkv, lkv))
    m = None
    if mask != "none":
        mm = (rng.random((b, lkv)) > 0.3).astype(np.float32)
        mm[:, -1] = 1.0
        if mask == "zero_row":
            mm[0] = 0.0
        m = t(mm, torch.float32)
    sprev = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    if m is not None:
        sprev = sprev - np.float32(1e8) * (1.0 - mm[:, None, None, :])
    bound = 1.0 / np.sqrt(d)
    ws = [t(rng.uniform(-bound, bound, (d, d))),
          t(rng.uniform(-bound, bound, (d, 2 * d))),
          t(1.0 + 0.1 * rng.standard_normal(d)), t(0.1 * rng.standard_normal(d))]
    return q, k, v, m, t(sprev, torch.float32), t([0.7]), ws


def _close(got, ref, tol):
    got, ref = got.double().cpu(), ref.double().cpu()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) / scale <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
@pytest.mark.parametrize("b,lq,lkv,h,dh,mask", [
    (8, 20, 200, 6, 16, "zero_row"), (4, 100, 20, 6, 16, "zero_row"),
    (4, 40, 275, 8, 16, "zero_row"), (2, 70, 300, 2, 256, "none"),
    (3, 1, 100, 4, 1, "zero_row"), (2, 33, 1000, 4, 64, "zero_row"),
    (2, 128, 512, 8, 128, "zero_row")] + CLUSTER_SHAPES + MOSEI_SHAPES)
def test_kernel_matches_plain_on_card(cuda, dtype, tol, has_sprev, emit, b,
                                      lq, lkv, h, dh, mask):
    q, k, v, m, sprev, c, ws = _inputs(b, lq, lkv, h, dh, mask, dtype, cuda)
    sp = sprev if has_sprev else None
    before = tfb.fused_block_kernel.variant_launches[(has_sprev, emit)]
    out, s, ctx = tfb.fused_block_kernel(q, k, v, m, sp, c, *ws, n_heads=h,
                                         emit_scores=emit, save_ctx=True)
    torch.cuda.synchronize()
    assert tfb.fused_block_kernel.variant_launches[(has_sprev, emit)] == before + 1
    ref, rs = tfb.fused_block_plain(q, k, v, m, sp, c, *ws, n_heads=h,
                                    emit_scores=emit)
    assert out.dtype == dtype and (s is None) == (not emit)
    _close(out, ref, tol)
    rctx, ss = tpa.scored_forward_plain(q, k, v, m, sp, c, n_heads=h)
    _close(ctx, rctx, tol)
    if emit:
        assert (((s - rs).abs() / rs.abs().clamp(min=1.0)) <= S_RTOL).all()
        _, s_scored = tpa.scored_forward_kernel(q, k, v, m, sp, c, n_heads=h)
        assert torch.equal(s, s_scored)


def _dtypes(dh, h):
    """f32 everywhere; bf16 too at D 1024."""
    return [torch.float32, torch.bfloat16] if h * dh == 1024 else [torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
@pytest.mark.parametrize("b,lq,lkv,h,dh,mask", CLUSTER_SHAPES + MOSEI_SHAPES)
def test_stats_and_repeat_bits_on_card(cuda, has_sprev, emit, b, lq, lkv, h,
                                       dh, mask):
    """m bit-equal to scored_fwd's row stats, l within 1e-6 relative (the
    two kernels may split the keys over warps differently), and out, S and
    the stats the same bits over two launches."""
    for dtype in _dtypes(dh, h):
        q, k, v, m, sprev, c, ws = _inputs(b, lq, lkv, h, dh, mask, dtype,
                                           cuda, seed=5)
        sp = sprev if has_sprev else None
        runs = [tfb.fused_block_kernel(q, k, v, m, sp, c, *ws, n_heads=h,
                                       emit_scores=emit, stats=True)
                for _ in range(2)]
        _, _, st = tpa.scored_forward_kernel(q, k, v, m, sp, c, n_heads=h,
                                             emit_scores=False, stats=True)
        torch.cuda.synchronize()
        (out, s, _, stats), (out2, s2, _, stats2) = runs
        assert torch.equal(out, out2) and torch.equal(stats, stats2)
        assert (s is None and s2 is None) or torch.equal(s, s2)
        assert torch.equal(stats[0], st[0])
        assert float(((stats[1] - st[1]).abs() / st[1]).max()) <= L_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lkv,h,dh,path", [
    (b, lq, lkv, h, dh, "tile") for b, lq, lkv, h, dh, _ in MOSEI_SHAPES] + [
    (2, 33, 128, 8, 128, "cluster"), (1, 40, 275, 8, 16, "cluster"),
    (1, 76, 40, 8, 16, "cluster"), (1, 275, 76, 8, 16, "cluster")])
def test_geometry_reports_the_path_taken(cuda, b, lq, lkv, h, dh, path):
    """The tile path (cluster 1, one block a row tile) at mosei_trans's
    widths, the cluster path at D 1024 and at ren_mme's D 128; a launch
    counts under the path its geometry names."""
    geo = tfb.fused_block_kernel.geometry(b, h, lq, lkv, dh)
    assert geo["path"] == path
    assert (geo["cluster"] == 1) == (path == "tile")
    if path == "cluster":
        assert geo["cluster"] == min(h, 8) and geo["warps"] == 4
    q, k, v, m, _, c, ws = _inputs(b, lq, lkv, h, dh, "zero_row",
                                   torch.float32, cuda)
    before = dict(tfb.fused_block_kernel.path_launches)
    tfb.fused_block_kernel(q, k, v, m, None, c, *ws, n_heads=h,
                           emit_scores=False)
    torch.cuda.synchronize()
    after = tfb.fused_block_kernel.path_launches
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in tfb.PATHS}


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("b,lq,lkv,h,dh,mask", CLUSTER_SHAPES)
def test_gradients_with_stats_match_without(cuda, monkeypatch, emit, b, lq,
                                            lkv, h, dh, mask):
    """FusedMinusBlock's f32 gradients when its backward reads the forward's
    row stats (dq sweeps the keys once) against the same backward with no
    stats (dq takes them in a sweep of its own), S_prev given."""
    real = tfb.fused_block_kernel

    def without_stats(*args, stats=False, **kw):
        out = real(*args, **kw)
        return (*out, None) if stats else out

    grads = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(tfb, "fused_block_kernel", without_stats)
        q, k, v, m, sprev, c, ws = _inputs(b, lq, lkv, h, dh, mask,
                                           torch.float32, cuda, seed=7)
        leaves = [q, k, v, sprev, c, *ws]
        for a in leaves:
            a.requires_grad_(True)
        out, s = tfb.fused_minus_block(q, k, v, m, sprev, c, *ws, n_heads=h,
                                       emit_scores=emit)
        g = torch.Generator().manual_seed(1)
        loss = (out * torch.randn(out.shape, generator=g).to(cuda)).sum()
        if emit:
            loss = loss + (s * torch.randn(s.shape, generator=g).to(cuda)).sum()
        loss.backward()
        grads.append([a.grad for a in leaves])
    for got, ref in zip(*grads):
        _close(got, ref, STATS_GRAD_TOL)


@pytest.mark.cuda
def test_kernel_refuses_blocks_wider_than_1024(cuda):
    """D up to 1024 (the s1024 preset's blocks); wider raises, with no
    launch and no fallback."""
    q, k, v, m, _, c, ws = _inputs(2, 4, 6, 8, 129, "ragged", torch.float32,
                                   cuda)
    before = tfb.fused_block_kernel.launches
    with pytest.raises(ValueError, match="1024"):
        tfb.fused_block_kernel(q, k, v, m, None, c, *ws, n_heads=8)
    assert tfb.fused_block_kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
def test_function_on_card_matches_cpu(cuda, has_sprev, emit):
    """FusedMinusBlock's gradients on the card (the kernel's ctx residual,
    the scored_bwd kernels) against the same Function on CPU copies (the
    plain versions), f32, a ragged mask."""
    grads = []
    for device in (cuda, torch.device("cpu")):
        q, k, v, m, sprev, c, ws = _inputs(4, 20, 100, 6, 16, "ragged",
                                           torch.float32, device, seed=3)
        leaves = [q, k, v, sprev, c, *ws]
        for a in leaves:
            a.requires_grad_(True)
        out, s = tfb.fused_minus_block(q, k, v, m, sprev if has_sprev else None,
                                       c, *ws, n_heads=6, emit_scores=emit)
        g = torch.Generator().manual_seed(1)
        loss = (out * torch.randn(out.shape, generator=g).to(device)).sum()
        if emit:
            loss = loss + (s * torch.randn(s.shape, generator=g).to(device)).sum()
        loss.backward()
        grads.append([a.grad for a in leaves])
    for got, ref in zip(*grads):
        assert (got is None) == (ref is None)
        if ref is not None:
            _close(got, ref, GRAD_TOL)
