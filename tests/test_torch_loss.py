"""PyTorch port, the ZLPR loss against the JAX package's `zlpr_loss`: value
and gradient on the same numpy logits and labels, all-zero and all-one
label rows included, in f32 at 1e-5 after scaling by max(1, |ref|)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.ops.loss import zlpr_loss as jzlpr  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops.loss import zlpr_loss  # noqa: E402

TOL = 1e-5


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(6, 7), (2, 3, 5)])
def test_zlpr_value_and_gradient_match_jax(shape):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    labels = (rng.random(shape) > 0.5).astype(np.int32)
    labels.reshape(-1, shape[-1])[0] = 0               # an all-zero row
    labels.reshape(-1, shape[-1])[1] = 1               # an all-one row
    w = rng.standard_normal(shape[:-1]).astype(np.float32)

    ref = jzlpr(jnp.asarray(logits), jnp.asarray(labels))
    ref_grad = jax.grad(lambda x: jnp.sum(jzlpr(x, jnp.asarray(labels)) * w))(
        jnp.asarray(logits))

    x = torch.from_numpy(logits).requires_grad_(True)
    got = zlpr_loss(x, torch.from_numpy(labels))
    (got * torch.from_numpy(w)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == shape[:-1]
    _close(got.detach(), ref)
    _close(x.grad, ref_grad)


def test_zlpr_casts_labels_to_the_logits_dtype():
    logits = torch.tensor([[0.5, -1.0, 2.0]], dtype=torch.float64)
    labels = torch.tensor([[1, 0, 1]], dtype=torch.int32)
    out = zlpr_loss(logits, labels)
    assert out.dtype == torch.float64
    # log(1 + e^-0.5 + e^-2) + log(1 + e^-1): the closed form
    want = np.log(1 + np.exp(-0.5) + np.exp(-2.0)) + np.log(1 + np.exp(-1.0))
    assert out.item() == pytest.approx(want, rel=1e-12)
