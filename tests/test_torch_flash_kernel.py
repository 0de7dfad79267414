"""PyTorch port, the flash kernels' wrappers: the forward (with and without
its row stats) and the two backward kernels.  No JAX here, so the card-only
tests run on a machine without it:

    python -m pytest --noconftest tests/test_torch_flash_kernel.py -q

On the CPU the CUDA tests skip, and the wrappers' own contract is checked:
the kernels take CUDA tensors only (the plain versions are the caller's
choice for CPU tensors, never a fallback), gradients flow through the
autograd Function while the bare wrappers refuse inputs that need one, and
the launch counters move only on a launch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodal_emotion_processing_tpu_torch.ops import flash_attention as tfa  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 5e-2


def _inputs(b=2, lq=20, lkv=200, h=2, d=32, seed=0, dtype=torch.float32,
            device="cpu"):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
               for n in (lq, lkv, lkv))
    m = torch.from_numpy((rng.random((b, lkv)) > 0.3).astype(np.float32))
    m[0] = 0.0                                   # a fully masked row
    return [t.to(dtype).to(device) for t in (q, k, v, m)]


def _close(got, ref, tol):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() / scale <= tol


def test_kernel_takes_cuda_tensors_only():
    q, k, v, m = _inputs(lq=4, lkv=8)
    before = tfa.flash_forward_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward_kernel(q, k, v, m, n_heads=2)
    assert tfa.flash_forward_kernel.launches == before


def test_cpu_call_takes_the_plain_version():
    q, k, v, m = _inputs(lq=4, lkv=8)
    before = tfa.flash_forward_kernel.launches
    ctx, scores = tfa.flash_scored_attention(q, k, v, m, torch.zeros(1),
                                             n_heads=2)
    assert scores is None and tfa.flash_forward_kernel.launches == before
    _close(ctx, tfa.flash_forward_plain(q, k, v, m, n_heads=2), 0.0)


def test_gradients_are_refused():
    """The bare kernel wrappers record no autograd graph, so they refuse
    inputs that need a gradient instead of dropping it; a differentiable
    call goes through the autograd Function (next test)."""
    q, k, v, m = _inputs(lq=4, lkv=8)
    o, ms, ls = tfa.flash_forward_plain(q, k, v, m, n_heads=2, stats=True)
    q.requires_grad_(True)
    for kern, args in ((tfa.flash_forward_kernel, (q, k, v, m)),
                       (tfa.flash_bwd_dq_kernel, (q, k, v, m, o, o, ms, ls)),
                       (tfa.flash_bwd_dkv_kernel, (q, k, v, m, o, o, ms, ls))):
        before = kern.launches
        with pytest.raises(RuntimeError, match="FlashAttention"):
            kern(*args, n_heads=2)
        assert kern.launches == before


def test_gradients_flow():
    """A call that needs a gradient goes through the autograd Function (its
    plain versions on the CPU) and gives autograd's gradients of the plain
    forward; without one it is a plain forward."""
    q, k, v, m = _inputs(lq=4, lkv=8)
    w = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (lambda *a: tfa.flash_scored_attention(*a, torch.zeros(1),
                                                     n_heads=2)[0],
               lambda *a: tfa.flash_forward_plain(*a, n_heads=2)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, m)]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    before = [kern.launches for kern in tfa.KERNELS]
    for got, ref in zip(*grads):
        _close(got, ref, F32_TOL)
    assert [kern.launches for kern in tfa.KERNELS] == before
    with torch.no_grad():
        ctx, _ = tfa.flash_scored_attention(q.requires_grad_(True), k, v, m,
                                            torch.zeros(1), n_heads=2)
    assert ctx.shape == (2, 4, 32) and ctx.grad_fn is None


def test_backward_kernels_take_cuda_tensors_only():
    q, k, v, m = _inputs(lq=4, lkv=8)
    o, ms, ls = tfa.flash_forward_plain(q, k, v, m, n_heads=2, stats=True)
    for kern in (tfa.flash_bwd_dq_kernel, tfa.flash_bwd_dkv_kernel):
        before = kern.launches
        with pytest.raises(ValueError, match="CUDA"):
            kern(q, k, v, m, o, o, ms, ls, n_heads=2)
        assert kern.launches == before


def test_fully_masked_row_is_uniform_over_real_keys():
    """The plain version, which the kernel is held to: a row with an
    all-zero mask averages v over its Lkv keys, none padded in.  (Exactly
    so while |q·k/√dh| < 4, half the f32 spacing at 1e8: then every masked
    score rounds to −1e8 itself; q is scaled down to keep it there.)"""
    q, k, v, m = _inputs(lq=3, lkv=200)
    out = tfa.flash_forward_plain(0.1 * q, k, v, m, n_heads=2)
    _close(out[0], v[0].mean(dim=0).expand(3, -1), 1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("lq,lkv,h,d", [(20, 200, 2, 32), (128, 512, 8, 1024),
                                        (5, 1, 1, 3), (70, 300, 4, 1024)])
def test_kernel_matches_plain_on_card(cuda, dtype, tol, lq, lkv, h, d):
    q, k, v, m = _inputs(lq=lq, lkv=lkv, h=h, d=d, dtype=dtype, device=cuda)
    before = tfa.flash_forward_kernel.launches
    got = tfa.flash_forward_kernel(q, k, v, m, n_heads=h)
    torch.cuda.synchronize()
    assert tfa.flash_forward_kernel.launches == before + 1
    assert got.dtype == dtype
    _close(got, tfa.flash_forward_plain(q, k, v, m, n_heads=h), tol)


def _grad_inputs(b, lq, lkv, h, dh, dtype, device, seed=0, q_scale=1.0,
                 mask="zero_row"):
    """q, k, v, a mask (a ragged valid prefix per row, row 0 fully masked)
    and a cotangent do."""
    g = torch.Generator().manual_seed(seed)
    d = h * dh
    q, k, v, do = (torch.randn(b, n, d, generator=g)
                   for n in (lq, lkv, lkv, lq))
    q = q * q_scale
    m = None
    if mask != "none":
        lens = torch.randint(1, lkv + 1, (b,), generator=g)
        m = (torch.arange(lkv)[None, :] < lens[:, None]).float()
        m[0] = 0.0
    return [None if t is None else t.to(dtype).to(device)
            for t in (q, k, v, m, do)]


# Cases that fail if any of the three kernels computes a score with other
# bits than the others (bf16 takes the tensor cores up to dh 128): a fully
# masked row with q x 4 at each tensor-core head-width bucket, Lkv and Lq
# not multiples of the 64-wide tiles, and Lq 1.
SCORE_ORDER_CASES = [(2, 64, 77, 2, 32, 4.0), (2, 64, 77, 2, 64, 4.0),
                     (2, 64, 77, 2, 128, 4.0), (2, 96, 130, 4, 128, 4.0),
                     (2, 1, 77, 2, 128, 4.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,lq,lkv,h,dh,q_scale", [
    (2, 20, 200, 2, 16, 1.0), (2, 128, 512, 8, 128, 1.0), (1, 1, 1, 1, 1, 1.0),
    (2, 70, 300, 2, 256, 1.0), (2, 33, 77, 3, 48, 1.0)] + SCORE_ORDER_CASES)
def test_stats_match_plain_on_card(cuda, dtype, tol, b, lq, lkv, h, dh,
                                   q_scale):
    q, k, v, m, _ = _grad_inputs(b, lq, lkv, h, dh, dtype, cuda,
                                 q_scale=q_scale)
    before = tfa.flash_forward_kernel.stats_launches
    o, ms, ls = tfa.flash_forward_kernel(q, k, v, m, n_heads=h, stats=True)
    torch.cuda.synchronize()
    assert tfa.flash_forward_kernel.stats_launches == before + 1
    ro, rm, rl = tfa.flash_forward_plain(q, k, v, m, n_heads=h, stats=True)
    _close(o, ro, tol)
    # m is about -1e8 in the masked row: compare each row at its own scale
    assert ((ms - rm).abs() / rm.abs().clamp(min=1.0)).max().item() <= F32_TOL
    _close(ls, rl, F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,lq,lkv,h,dh,q_scale,mask", [
    (2, 20, 200, 2, 16, 1.0, "zero_row"), (2, 128, 512, 8, 128, 1.0, "zero_row"),
    (1, 1, 1, 1, 1, 1.0, "zero_row"), (2, 70, 300, 2, 256, 1.0, "zero_row"),
    (2, 33, 77, 3, 48, 1.0, "none"), (2, 64, 77, 2, 16, 4.0, "zero_row")]
    + [c + ("zero_row",) for c in SCORE_ORDER_CASES])
def test_backward_kernels_match_plain_on_card(cuda, dtype, tol, b, lq, lkv, h,
                                              dh, q_scale, mask):
    """Each side from its own forward (kernel stats for the kernels, plain
    stats for the plain version).  q_scale 4 puts the fully masked row's raw
    scores across +-4, where -1e8 + raw rounds to a neighbouring multiple
    of 8: the backward must recompute the forward's scores bit for bit."""
    q, k, v, m, do = _grad_inputs(b, lq, lkv, h, dh, dtype, cuda,
                                  q_scale=q_scale, mask=mask)
    o, ms, ls = tfa.flash_forward_kernel(q, k, v, m, n_heads=h, stats=True)
    counts = (tfa.flash_bwd_dq_kernel.launches, tfa.flash_bwd_dkv_kernel.launches)
    dq = tfa.flash_bwd_dq_kernel(q, k, v, m, o, do, ms, ls, n_heads=h)
    dk, dv, dmask = tfa.flash_bwd_dkv_kernel(q, k, v, m, o, do, ms, ls,
                                             n_heads=h)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_dq_kernel.launches,
            tfa.flash_bwd_dkv_kernel.launches) == (counts[0] + 1, counts[1] + 1)
    ro, rm, rl = tfa.flash_forward_plain(q, k, v, m, n_heads=h, stats=True)
    ref = tfa.flash_backward_plain(q, k, v, m, ro, do, rm, rl, n_heads=h)
    for got, want in zip((dq, dk, dv), ref[:3]):
        assert got.dtype == dtype
        _close(got, want, tol)
    if mask == "none":
        assert dmask is None and ref[3] is None
    else:
        _close(dmask, ref[3], tol)


@pytest.mark.cuda
def test_function_gradients_on_card(cuda):
    """Autograd through the Function launches one forward with stats and
    one of each backward kernel, and gives the plain path's gradients."""
    q, k, v, m, do = _grad_inputs(2, 40, 130, 2, 64, torch.float32, cuda)
    grads = []
    for fn in (lambda *a: tfa.flash_scored_attention(*a, torch.zeros(1),
                                                     n_heads=2)[0],
               lambda *a: tfa.flash_forward_plain(*a, n_heads=2)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, m)]
        before = [kern.launches for kern in tfa.KERNELS]
        (fn(*leaves) * do).sum().backward()
        torch.cuda.synchronize()
        grads.append(([t.grad for t in leaves],
                      [kern.launches - n for kern, n in zip(tfa.KERNELS, before)]))
    assert grads[0][1] == [1, 1, 1] and grads[1][1] == [0, 0, 0]
    for got, ref in zip(grads[0][0], grads[1][0]):
        _close(got, ref, F32_TOL)


@pytest.mark.cuda
def test_kernel_validates_before_launch(cuda):
    q, k, v, m = _inputs(lq=4, lkv=8, device=cuda)
    with pytest.raises(TypeError):
        tfa.flash_forward_kernel(q.half(), k.half(), v.half(), m, n_heads=2)
    with pytest.raises(ValueError, match="mask"):
        tfa.flash_forward_kernel(q, k, v, m[:, :4], n_heads=2)
    with pytest.raises(ValueError, match="head width"):
        tfa.flash_forward_kernel(*(torch.zeros(1, 2, 514, device=cuda)
                                   for _ in range(3)), None, n_heads=1)
