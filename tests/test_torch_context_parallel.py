"""The port's context-parallel attention (ops/context_parallel.py) on
four gloo ranks spawned on the CPU against the JAX package's
single-device attention and model, within the JAX tests' own tolerances
(tests/test_context_parallel.py): psum and ring modes, forward and
gradients, chained blocks, `emit_scores=False`, the padding of a kv
length that does not divide the ranks, the ring's error, and
`impl="cp"` through the whole model on a long audio sequence."""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_common as tdc  # noqa: E402
from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.ops.attention import (  # noqa: E402
    scored_attention as jattn)
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import context_parallel as cp  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops.attention import (  # noqa: E402
    scored_attention)

RANKS = 4   # tests/test_context_parallel.py:15 (its 4-device mesh)


def _inputs(b=2, lq=8, lkv=16, h=2, d=8, seed=0):
    """tests/test_context_parallel.py:19-28, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, lkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lkv, d)).astype(np.float32)
    m = (rng.random((b, lkv)) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    prev = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    c = np.asarray([0.37], np.float32)
    return q, k, v, m, prev, c, h


def _case(mode, seed, **kw):
    *args, h = _inputs(**{k: kw.pop(k) for k in ("lq", "lkv") if k in kw},
                       seed=seed)
    return {"mode": mode, "args": args, "h": h, **kw}


ATTENTION = {
    "psum": _case("psum", 0),
    "psum_chained": _case("psum", 1, chain=True),
    "psum_no_mask_no_prev": _case("psum", 2, no_mask_prev=True),
    "psum_grads": _case("psum", 9, grad=True),
    "psum_pads_indivisible_kv": _case("psum", 11, lkv=10),
    "ring": _case("ring", 4),
    "ring_emit_scores_false": _case("ring", 11, grad_noemit=True),
    "ring_chained_grads": _case("ring", 5, grad=True),
    "ring_rejects_indivisible": _case("ring", 0, lq=6),
}

# tests/test_context_parallel.py:76-78: audio 8x the flagship kv budget
LONG = dict(l_len=8, v_len=16, a_len=8 * 200, dim=24, n_heads=2, l_dim=5,
            v_dim=4, a_dim=3)


def _long_batch(m, b=2):
    rng = np.random.default_rng(0)
    return {
        "l": rng.standard_normal((b, 2, m.l_len, m.l_dim)).astype(np.float32),
        "v": rng.standard_normal((b, 2, m.v_len, m.v_dim)).astype(np.float32),
        "a": rng.standard_normal((b, 2, m.a_len, m.a_dim)).astype(np.float32),
        "l_mask": np.ones((b, 2, m.l_len), np.float32),
        "v_mask": np.ones((b, 2, m.v_len), np.float32),
        "a_mask": (rng.random((b, 2, m.a_len)) > 0.2).astype(np.float32),
    }


@pytest.fixture(scope="module")
def long_model():
    exp = jconfigs.get("mosei_trans")
    exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                             **LONG))
    params = jbuild(exp).init(jax.random.PRNGKey(0))
    batch = _long_batch(exp.model)
    ref = np.asarray(jbuild(exp).apply(params, batch, impl="xla"))
    return exp, params, batch, ref


@pytest.fixture(scope="module")
def ranks(long_model, tmp_path_factory):
    exp, params, batch, _ = long_model
    sd = from_jax_params(params, exp)
    model = {f"model_{mode}": {"name": "mosei_trans", "model": LONG, "state_dict": sd,
                    "batch": batch, "mode": mode} for mode in ("psum", "ring")}
    return tdc.spawn("cp", RANKS, tmp_path_factory.mktemp("cp"),
                     {"attention": ATTENTION, "model": model})


def _ref(key, prev=True):
    q, k, v, m, p, c = (jnp.asarray(a) for a in ATTENTION[key]["args"])
    h = ATTENTION[key]["h"]
    if ATTENTION[key].get("no_mask_prev"):
        return jattn(q, k, v, None, None, c, n_heads=h)
    if ATTENTION[key].get("chain"):
        ctx1, s1 = jattn(q, k, v, m, None, c, n_heads=h)
        return jattn(ctx1, k, v, m, s1, c, n_heads=h)
    return jattn(q, k, v, m, p, c, n_heads=h)


def _ref_grads(key):
    q, k, v, m, _, c = (jnp.asarray(a) for a in ATTENTION[key]["args"])
    h = ATTENTION[key]["h"]

    def loss(q, k, v, c):
        ctx1, s1 = jattn(q, k, v, m, None, c, n_heads=h)
        ctx2, _ = jattn(ctx1, k, v, m, s1, c, n_heads=h)
        return jnp.sum(ctx2 ** 2) + 0.1 * jnp.sum(ctx1 ** 2)

    return (float(loss(q, k, v, c)),
            jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, c))


# (key, ctx rtol/atol, scores rtol, scores atol): JAX's per test
FORWARD = [("psum", 1e-5, 1e-5, 1e-1), ("psum_chained", 2e-5, 1e-5, 1e-1),
           ("psum_no_mask_no_prev", 1e-5, None, None),
           ("psum_pads_indivisible_kv", 2e-5, 2e-5, 2e-5),
           ("ring", 1e-5, 1e-5, 1e-1)]


@pytest.mark.parametrize("key,ctx_tol,s_rtol,s_atol", FORWARD)
def test_cp_forward_matches_single_device(ranks, key, ctx_tol, s_rtol,
                                          s_atol):
    ctx_ref, s_ref = _ref(key)
    for r, out in enumerate(ranks):
        got = out[key]
        np.testing.assert_allclose(got["ctx"].numpy(), np.asarray(ctx_ref),
                                   rtol=ctx_tol, atol=ctx_tol,
                                   err_msg=f"rank {r}")
        assert tuple(got["scores"].shape) == tuple(s_ref.shape)
        if s_rtol is not None:
            # masked entries sit near -1e8
            np.testing.assert_allclose(got["scores"].numpy(),
                                       np.asarray(s_ref), rtol=s_rtol,
                                       atol=s_atol, err_msg=f"rank {r}")


@pytest.mark.parametrize("key", ["psum_grads", "ring_chained_grads"])
def test_cp_gradients_match_single_device(ranks, key):
    """Two chained blocks, dq, dk, dv and dc at 2e-4 (JAX's tolerance);
    every rank holds the whole gradient, not world-size times it."""
    loss_ref, g_ref = _ref_grads(key)
    for r, out in enumerate(ranks):
        assert abs(out[key]["loss"] - loss_ref) <= 1e-5 * abs(loss_ref)
        for name, got, want in zip(("dq", "dk", "dv", "dc"),
                                   out[key]["grads"], g_ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"{name} rank {r}")


def test_ring_emit_scores_false(ranks):
    """A terminal ring block builds no S: its context equals the emitting
    path's (1e-6), S is None, and dq flows (JAX's test at :153-185)."""
    ctx_ref, _ = _ref("ring_emit_scores_false")
    q, k, v, m, p, c = (jnp.asarray(a)
                        for a in ATTENTION["ring_emit_scores_false"]["args"])
    h = ATTENTION["ring_emit_scores_false"]["h"]
    dq_ref = jax.grad(lambda q_: jnp.sum(
        jattn(q_, k, v, m, p, c, n_heads=h)[0] ** 2))(q)
    for out in ranks:
        got = out["ring_emit_scores_false"]
        assert got["scores_False"] is None
        np.testing.assert_allclose(got["ctx_False"].numpy(),
                                   got["ctx_True"].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["ctx_False"].numpy(),
                                   np.asarray(ctx_ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dq"][False].numpy(),
                                   got["dq"][True].numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["dq"][False].numpy(),
                                   np.asarray(dq_ref), rtol=2e-4, atol=2e-4)


def test_ring_rejects_indivisible(ranks):
    for out in ranks:
        assert "divisible" in out["ring_rejects_indivisible"]["error"]
        assert "Lq (6)" in out["ring_rejects_indivisible"]["error"]


@pytest.mark.parametrize("mode", ["psum", "ring"])
def test_model_impl_cp_long_sequence_matches_xla(ranks, long_model, mode):
    """The whole flagship model with impl='cp' on 4 ranks, audio of 1600
    frames, equals the JAX model's single-device forward at 2e-4
    (tests/test_context_parallel.py:68-107)."""
    *_, ref = long_model
    for out in ranks:
        np.testing.assert_allclose(out[f"model_{mode}"]["logits"].numpy(), ref,
                                   rtol=2e-4, atol=2e-4)


def test_impl_cp_requires_context():
    q, k, v, m, p, c, h = _inputs()
    with pytest.raises(RuntimeError, match="cp_context"):
        scored_attention(*(torch.as_tensor(a) for a in (q, k, v, m, p, c)),
                         n_heads=h, impl="cp")


def test_ensure_cp_binding():
    """The entry points' helper (tests/test_context_parallel.py:220-241):
    null for other impls; for 'cp' a psum binding over every rank of the
    world (one here, made for the block and gone after it), deferring to
    an active binding, and degenerate one-rank CP equal to the plain
    path."""
    import torch.distributed as dist

    assert isinstance(cp.ensure_cp("xla"), contextlib.nullcontext)
    q, k, v, m, p, c, h = (torch.as_tensor(a) if not isinstance(a, int) else a
                           for a in _inputs())
    with cp.ensure_cp("cp", device="cpu"):
        mesh, axis, mode = cp.current_cp()
        assert axis == "context" and mode == "psum"
        assert mesh.size == dist.get_world_size() == 1
        with cp.ensure_cp("cp", device="cpu"):
            assert cp.current_cp()[0] is mesh
        with cp.cp_context(mesh, mode="ring"):
            with cp.ensure_cp("cp"):
                assert cp.current_cp() == (mesh, "context", "ring")
            got = scored_attention(q, k, v, m, p, c, n_heads=h, impl="cp")
        want = scored_attention(q, k, v, m, p, c, n_heads=h)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="cp_context"):
        cp.current_cp()
