"""PyTorch port, the flash forward kernel's wrapper.  No JAX here, so the
card-only tests run on a machine without it:

    python -m pytest --noconftest tests/test_torch_flash_kernel.py -q

On the CPU the CUDA tests skip, and the wrapper's own contract is checked:
the kernel takes CUDA tensors only (the plain version is the caller's
choice for CPU tensors, never a fallback), gradients are refused, and the
launch counter moves only on a launch."""

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
    q, k, v, m = _inputs(lq=4, lkv=8)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        tfa.flash_scored_attention(q, k, v, m, torch.zeros(1), n_heads=2)
    with torch.no_grad():
        ctx, _ = tfa.flash_scored_attention(q, k, v, m, torch.zeros(1),
                                            n_heads=2)
    assert ctx.shape == (2, 4, 32)


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
