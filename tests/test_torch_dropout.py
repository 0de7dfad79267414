"""PyTorch port, the pieces of training with dropout and R-Drop: `dropout`
(keep-rate statistics, exact x / keep scaling, rate-0 and eval identity,
the same bits from the same seed, an explicit generator at every site),
`symmetric_sigmoid_kl` against the JAX package's (with and without pair
weights, padded pairs, sigmoids that underflow to 0) and
`Batcher(duplicate=True)` against JAX's `Batcher`, batch for batch."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu.data import loader as jloader  # noqa: E402
from multimodal_emotion_processing_tpu.ops.loss import (  # noqa: E402
    symmetric_sigmoid_kl as j_kl)
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data import loader  # noqa: E402
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model, layers  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops.loss import symmetric_sigmoid_kl  # noqa: E402

PORT = Path(__file__).resolve().parent.parent / "multimodal_emotion_processing_tpu_torch"
N_STAT = 1_000_000


def test_dropout_keep_rate_and_exact_scaling():
    """Over 1e6 elements the keep share is within 5 sigma of 1 - rate; a
    kept value is x / keep divided in f32 (numpy's IEEE division), a
    dropped one 0."""
    rate = 0.1
    keep = 1.0 - rate
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        N_STAT).astype(np.float32) + 3.0)                 # no zero inputs
    y = layers.dropout(x, rate, torch.Generator().manual_seed(1))
    kept = (y != 0).numpy()
    sigma = np.sqrt(keep * rate / N_STAT)
    assert abs(kept.mean() - keep) < 5 * sigma
    want = x.numpy() / np.float32(keep)
    np.testing.assert_array_equal(y.numpy()[kept], want[kept])
    assert y.dtype == x.dtype and y.shape == x.shape


def test_dropout_repeats_from_a_seed():
    x = torch.randn(64, 7, 12, generator=torch.Generator().manual_seed(0))
    a = layers.dropout(x, 0.3, torch.Generator().manual_seed(5))
    b = layers.dropout(x, 0.3, torch.Generator().manual_seed(5))
    c = layers.dropout(x, 0.3, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(5)          # one stream, two draws
    assert torch.equal(layers.dropout(x, 0.3, g), a)
    assert not torch.equal(layers.dropout(x, 0.3, g), a)


def test_dropout_rate_zero_and_eval_are_identity(monkeypatch):
    """Rate 0 returns x itself, generator or not; a model with dropout 0.1
    in eval mode draws no mask; in training it needs a generator."""
    x = torch.randn(3, 4)
    assert layers.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        layers.dropout(x, 0.1, None)

    def no_draw(*args):
        raise AssertionError("a mask was drawn in eval mode")

    exp = configs.get("robot_demo")
    m = exp.model
    model = build_model(exp, device="cpu")
    samples = synthetic_dataset(exp.name, m, 2, seed=0)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
             for k in samples[0]}
    monkeypatch.setattr(layers, "keep_mask", no_draw)
    with torch.no_grad():
        out = model(batch, impl="pallas")
    assert out.shape == (2, m.n_emotions) and torch.isfinite(out).all()


def test_no_port_module_draws_masks_from_the_global_generator():
    """Every dropout mask comes from `layers.keep_mask` with an explicit
    generator: no F.dropout, nn.Dropout or generator-free random draw."""
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"\bF\.dropout\b|nn\.Dropout\b|"
                             r"functional\.dropout\b", text), path
        for call in re.findall(r"torch\.(?:rand|bernoulli)\w*\([^)]*\)", text):
            assert "generator=" in call, (path, call)


def _kl_logits(n_pairs, seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((2 * n_pairs, 9))).astype(np.float32)
    logits[0, :3] = (-200.0, 200.0, -90.0)   # sigmoid 0 in f32, 1, subnormal
    logits[1, :3] = (150.0, -300.0, 40.0)
    return logits


@pytest.mark.parametrize("weights", [None, "padded", "all_padding"])
def test_symmetric_sigmoid_kl_matches_jax(weights):
    logits = _kl_logits(5, 3)
    w = None
    if weights == "padded":
        w = np.array([1, 1, 0, 1, 0], np.float32)
        logits[4:6] = 0.0                    # a padding pair's zero logits
    elif weights == "all_padding":
        w = np.zeros(5, np.float32)
    ref = float(j_kl(jnp.asarray(logits),
                     None if w is None else jnp.asarray(w)))
    got = symmetric_sigmoid_kl(torch.from_numpy(logits),
                               None if w is None else torch.from_numpy(w))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), ref, rtol=2e-6, atol=1e-7)
    if weights == "padded":
        # the weighted mean over the real pairs is the unweighted KL of them
        real = logits.reshape(5, 2, 9)[w > 0].reshape(-1, 9)
        np.testing.assert_allclose(
            float(got), float(symmetric_sigmoid_kl(torch.from_numpy(real))),
            rtol=1e-6)
    if weights == "all_padding":
        assert float(got) == 0.0


def test_symmetric_sigmoid_kl_gradient_matches_jax():
    """The gradient against JAX's where JAX's is finite.  Where a sigmoid
    underflows to 0, JAX's is NaN: XLA on the CPU flushes the subnormal
    1e-38 of max(p, 1e-38) to 0, and log(0) reaches the branch that
    `where` discards; the port's stays finite there."""
    import jax

    logits = _kl_logits(4, 8)
    w = np.array([1, 0, 1, 1], np.float32)
    ref = np.asarray(jax.grad(lambda x: j_kl(x, jnp.asarray(w)))(
        jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    symmetric_sigmoid_kl(x, torch.from_numpy(w)).backward()
    got = x.grad.numpy()
    assert np.isfinite(got).all()
    finite = np.isfinite(ref)
    assert finite.sum() >= logits.size - 4
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-5, atol=1e-7)
    assert not got[2:4].any()                 # a padding pair gets nothing


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n,batch_size", [(7, 3), (6, 3), (2, 4)])
def test_batcher_duplicate_equals_jax(shuffle, n, batch_size):
    """Each sample twice in adjacent rows, 2 x batch_size rows a batch,
    the padding rows zero with weight 0; the same arrays as JAX's Batcher
    from the same seed over two epochs."""
    m = dataclasses.replace(configs.get("ren_mme").model, l_len=3, v_len=4,
                            a_len=5, l_dim=2, v_dim=3, a_dim=2)
    samples = synthetic_dataset("ren_mme", m, n, seed=2)
    ours = loader.Batcher(samples, batch_size, shuffle=shuffle,
                          duplicate=True, seed=4)
    theirs = jloader.Batcher(samples, batch_size, shuffle=shuffle,
                             duplicate=True, seed=4)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() \
        == -(-n // batch_size)
    for _ in range(2):
        got, ref = list(ours()), list(theirs())
        assert len(got) == len(ref) == ours.steps_per_epoch()
        for a, b in zip(got, ref):
            assert list(a) == list(b)
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["label"].shape[0] == 2 * batch_size
            np.testing.assert_array_equal(a["l"][::2], a["l"][1::2])
    last = got[-1]
    real = 2 * (n - batch_size * (len(got) - 1))
    assert last["sample_weight"].sum() == real
    assert not last["l"][real:].any()
