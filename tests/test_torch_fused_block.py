"""PyTorch port, `impl="pallas_fused"`: the whole minus block of
ops/fused_block.py.  On the CPU its wrapper takes the plain version, held
here against the JAX package's `fused_minus_block` (its Pallas kernel in
interpret mode, as tests/test_pallas.py:97-114 runs it) on the same numpy
inputs: the four variants (S_prev given or not, S emitted or not), with a
fully masked row whose S_prev holds -1e8 + raw under c = 0.7, and without a
mask; out within 1e-5 of max(1, |ref|), S at rtol 1e-5 (atol 1e-2 on the
masked entries, which sit near -1e8 or -(1 + c)·1e8, where the f32 spacing
is 8 to 16).  Two chained blocks' gradients (q, k, v, S_prev, both gates,
proj, minus and the LayerNorm of each block) against `jax.grad` through the
JAX fused blocks at 2e-4 (tests/test_interop.py:20), dc at the scale of
the terms it sums; `FusedMinusBlock` against autograd through the plain
version in f64, dmask included; the routing of `MinusBlock` and
`RealformerBlock`; and a tiny `mosei_trans` at `impl="pallas_fused"`:
logits and step-1 gradients against the JAX model at `impl="xla"`.

The kernel itself is held against its plain version on the card by
tests/test_torch_fused_block_kernel.py.
"""

import dataclasses
import json
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multimodal_emotion_processing_tpu import configs as jconfigs  # noqa: E402
from multimodal_emotion_processing_tpu.models import build_model as jbuild  # noqa: E402
from multimodal_emotion_processing_tpu.ops.fused_block import (  # noqa: E402
    fused_minus_block as jax_fused_minus_block)
from multimodal_emotion_processing_tpu.train import engine as jeng  # noqa: E402
from multimodal_emotion_processing_tpu_torch import configs  # noqa: E402
from multimodal_emotion_processing_tpu_torch.cli import main  # noqa: E402
from multimodal_emotion_processing_tpu_torch.interop import from_jax_params  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models import build_model  # noqa: E402
from multimodal_emotion_processing_tpu_torch.models.layers import (  # noqa: E402
    MinusBlock, RealformerBlock)
from multimodal_emotion_processing_tpu_torch.ops import cuda_binding  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import fused_block as tfb  # noqa: E402
from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as tpa  # noqa: E402
from multimodal_emotion_processing_tpu_torch.train import engine  # noqa: E402

OUT_TOL = 1e-5
S_RTOL = 1e-5
GRAD_TOL = 2e-4
F64_TOL = 1e-6     # f64 on both sides; dS_prev comes back as f32
TINY = dict(l_len=4, v_len=9, a_len=20, dim=12, n_heads=2, l_dim=7, v_dim=3,
            a_dim=5)
TINY_SET = [f"--set=model.{k}={json.dumps(v)}" for k, v in TINY.items()]


def _inputs(b=2, lq=5, lkv=7, h=2, d=8, seed=0, mask="zero_row", c=0.7):
    """numpy q, k, v, a mask (row 0 fully masked for "zero_row", every row
    ragged for "ragged", None for "none"), S_prev as a block emits it (-1e8
    + raw where the mask is 0), the gate c, and one block's weights in the
    JAX layout: proj (D, D) and minus (2D, D) as (in, out), the LayerNorm's
    scale and bias away from 1 and 0."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32)
               for n in (lq, lkv, lkv))
    m = None
    if mask != "none":
        m = (rng.random((b, lkv)) > 0.3).astype(np.float32)
        m[:, -1] = 1.0
        if mask == "zero_row":
            m[0] = 0.0
    sprev = rng.standard_normal((b, h, lq, lkv)).astype(np.float32)
    if m is not None:
        sprev = sprev - np.float32(1e8) * (1.0 - m[:, None, None, :])
    return dict(q=q, k=k, v=v, m=m, sprev=sprev, c=np.asarray([c], np.float32),
                h=h, w=_weights(rng, d))


def _weights(rng, d):
    bound = 1.0 / np.sqrt(d)
    return dict(
        proj=rng.uniform(-bound, bound, (d, d)).astype(np.float32),
        minus=rng.uniform(-bound, bound, (2 * d, d)).astype(np.float32),
        scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        bias=(0.1 * rng.standard_normal(d)).astype(np.float32))


def _torch_weights(w, dtype=torch.float32):
    """The port's layout: torch's (out, in)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in
            (w["proj"].T, w["minus"].T, w["scale"], w["bias"])]


def _jax_weights(w):
    return [jnp.asarray(w[n]) for n in ("proj", "minus", "scale", "bias")]


def _close(got, ref, tol=GRAD_TOL, scale=None, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()), scale or 0.0)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol,
                               err_msg=what)


def _scores_close(got, ref, m):
    """S elementwise: rtol 1e-5, atol 1e-2 where the key is masked."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    masked = (np.zeros(ref.shape, bool) if m is None
              else np.broadcast_to((m == 0)[:, None, None, :], ref.shape))
    atol = np.where(masked, 1e-2, 1e-5)
    assert (np.abs(got - ref) <= atol + S_RTOL * np.abs(ref)).all()


@pytest.mark.parametrize("mask", ["zero_row", "none"])
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
def test_plain_matches_jax_fused_block(has_sprev, emit, mask):
    x = _inputs(mask=mask)
    sprev = x["sprev"] if has_sprev else None
    jout, js = jax_fused_minus_block(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        None if x["m"] is None else jnp.asarray(x["m"]),
        None if sprev is None else jnp.asarray(sprev), jnp.asarray(x["c"]),
        *_jax_weights(x["w"]), n_heads=x["h"])
    before = [(k.launches, dict(k.variant_launches)) for k in tfb.KERNELS]
    t = {n: None if x[n] is None else torch.from_numpy(x[n])
         for n in ("q", "k", "v", "m", "c")}
    out, s = tfb.fused_minus_block(
        t["q"], t["k"], t["v"], t["m"],
        None if sprev is None else torch.from_numpy(sprev), t["c"],
        *_torch_weights(x["w"]), n_heads=x["h"], emit_scores=emit)
    assert [(k.launches, k.variant_launches) for k in tfb.KERNELS] == before
    assert out.dtype == torch.float32 and (s is None) == (not emit)
    _close(out, jout, OUT_TOL, what="out")
    if emit:
        _scores_close(s, js, x["m"])
    # the plain version alone gives the same
    pout, ps = tfb.fused_block_plain(
        t["q"], t["k"], t["v"], t["m"],
        None if sprev is None else torch.from_numpy(sprev), t["c"],
        *_torch_weights(x["w"]), n_heads=x["h"], emit_scores=emit)
    assert torch.equal(pout, out) and (ps is None or torch.equal(ps, s))


def _plain_f64_chain(x, ws, emit1):
    """The two-block chain through the plain version in f64 under torch
    autograd, with each block's S kept: returns (their S with their
    gradients after backward, the S_prev each block read)."""
    t = {n: torch.from_numpy(x[n]).double().requires_grad_(True)
         for n in ("q", "k", "v", "sprev")}
    m = None if x["m"] is None else torch.from_numpy(x["m"]).double()
    c0, c1 = (torch.tensor([c], dtype=torch.float64) for c in (0.7, 0.4))
    w0, w1 = ([a.double() for a in _torch_weights(w)] for w in ws)
    o1, s0 = tfb.fused_block_plain(t["q"], t["k"], t["v"], m, t["sprev"], c0,
                                   *w0, n_heads=x["h"])
    o2, s1 = tfb.fused_block_plain(o1, t["k"], t["v"], m, s0, c1, *w1,
                                   n_heads=x["h"])
    for s in (s0, s1):
        s.retain_grad()
    loss = (o2 * torch.from_numpy(x["w_out"]).double()).sum() + 0.1 * (o1 ** 2).sum()
    if emit1:
        loss = loss + (s1 * torch.from_numpy(x["w_s"]).double()).sum()
    loss.backward()
    return (s0, s1), (t["sprev"], s0)


@pytest.mark.parametrize("emit1", [False, True])
@pytest.mark.parametrize("mask", ["ragged", "zero_row"])
def test_two_chained_blocks_match_jax_grad(mask, emit1):
    """Block 0 reads S_prev under c0 and emits S, block 1 reads it under c1
    and emits S or not (JAX always does): gradients of q, k, v, S_prev, c0,
    c1 and both blocks' proj, minus and LayerNorm, against jax.grad through
    the JAX fused blocks.  dc = Σ ds·S_prev adds ±1e8-sized terms that
    cancel where a row is fully masked, so it is held at the scale of its
    terms, Σ |ds|·|S_prev|, from the plain chain in f64."""
    x = _inputs(mask=mask, seed=3)
    rng = np.random.default_rng(4)
    ws = [_weights(rng, x["q"].shape[-1]) for _ in range(2)]
    x["w_out"] = rng.standard_normal(x["q"].shape).astype(np.float32)
    x["w_s"] = rng.standard_normal(x["sprev"].shape).astype(np.float32)
    jm = None if x["m"] is None else jnp.asarray(x["m"])

    def jloss(q, k, v, sprev, c0, c1, w0, w1):
        o1, s0 = jax_fused_minus_block(q, k, v, jm, sprev, c0, *w0,
                                       n_heads=x["h"])
        o2, s1 = jax_fused_minus_block(o1, k, v, jm, s0, c1, *w1,
                                       n_heads=x["h"])
        out = jnp.sum(o2 * x["w_out"]) + 0.1 * jnp.sum(o1 ** 2)
        return out + jnp.sum(s1 * x["w_s"]) if emit1 else out

    jargs = ([jnp.asarray(x[n]) for n in ("q", "k", "v", "sprev")]
             + [jnp.asarray([0.7], jnp.float32), jnp.asarray([0.4], jnp.float32)]
             + [_jax_weights(w) for w in ws])
    ref = jax.grad(jloss, argnums=tuple(range(8)))(*jargs)

    t = {n: torch.from_numpy(x[n]).requires_grad_(True)
         for n in ("q", "k", "v", "sprev")}
    c0 = torch.tensor([0.7], requires_grad=True)
    c1 = torch.tensor([0.4], requires_grad=True)
    w0, w1 = ([a.requires_grad_(True) for a in _torch_weights(w)] for w in ws)
    m = None if x["m"] is None else torch.from_numpy(x["m"])
    o1, s0 = tfb.fused_minus_block(t["q"], t["k"], t["v"], m, t["sprev"], c0,
                                   *w0, n_heads=x["h"])
    assert "FusedMinusBlock" in type(o1.grad_fn).__name__
    o2, s1 = tfb.fused_minus_block(o1, t["k"], t["v"], m, s0, c1, *w1,
                                   n_heads=x["h"], emit_scores=emit1)
    loss = (o2 * torch.from_numpy(x["w_out"])).sum() + 0.1 * (o1 ** 2).sum()
    if emit1:
        loss = loss + (s1 * torch.from_numpy(x["w_s"])).sum()
    loss.backward()

    for i, n in enumerate(("q", "k", "v", "sprev")):
        _close(t[n].grad, ref[i], what=f"d{n}")
    for blk, (got_w, ref_w) in enumerate(((w0, ref[6]), (w1, ref[7]))):
        for name, got, r in zip(("proj", "minus", "scale", "bias"), got_w,
                                ref_w):
            r = np.asarray(r)
            _close(got.grad, r.T if r.ndim == 2 else r, what=f"{name}{blk}")
    (gs0, gs1), (read0, read1) = _plain_f64_chain(x, ws, emit1)
    for i, (c, gs, read) in enumerate(((c0, gs0, read0), (c1, gs1, read1))):
        scale = float((gs.grad.abs() * read.detach().abs()).sum())
        _close(c.grad, ref[4 + i], scale=scale, what=f"dc{i}")


@pytest.mark.parametrize("mask", ["zero_row", "none"])
@pytest.mark.parametrize("has_sprev,emit", tpa.VARIANTS)
def test_function_matches_plain_autograd_in_f64(has_sprev, emit, mask):
    """FusedMinusBlock's backward against torch autograd through the plain
    version on the same f64 inputs: every input's gradient, dmask
    included (1e8·Σ ds: in f64 its cancellation leaves ~1e-7)."""
    x = _inputs(mask=mask, seed=5)
    rng = np.random.default_rng(6)
    w_out = torch.from_numpy(rng.standard_normal(x["q"].shape))
    w_s = torch.from_numpy(rng.standard_normal(x["sprev"].shape))
    grads = []
    for fn in (tfb.fused_minus_block, tfb.fused_block_plain):
        t = {n: torch.from_numpy(x[n]).double().requires_grad_(True)
             for n in ("q", "k", "v", "sprev", "c")}
        m = (None if x["m"] is None
             else torch.from_numpy(x["m"]).double().requires_grad_(True))
        ws = [a.double().requires_grad_(True) for a in _torch_weights(x["w"])]
        out, s = fn(t["q"], t["k"], t["v"], m, t["sprev"] if has_sprev else None,
                    t["c"], *ws, n_heads=x["h"], emit_scores=emit)
        loss = (out * w_out).sum()
        if emit:
            loss = loss + (s * w_s).sum()
        loss.backward()
        leaves = [t["q"], t["k"], t["v"], m, t["sprev"], t["c"], *ws]
        grads.append([None if a is None else a.grad for a in leaves])
    for name, got, ref in zip(("q", "k", "v", "mask", "sprev", "c", "proj",
                               "minus", "scale", "bias"), *grads):
        if ref is None:
            # no S_prev: neither S_prev nor c gets a gradient on either side
            assert got is None, name
            continue
        assert got.dtype == ref.dtype, name
        _close(got, ref, F64_TOL, what=name)


def test_fused_minus_block_refuses_3d_masks_and_the_bare_kernel_cpu():
    x = _inputs()
    t = {n: torch.from_numpy(x[n]) for n in ("q", "k", "v", "sprev", "c")}
    ws = _torch_weights(x["w"])
    with pytest.raises(NotImplementedError, match="2-D"):
        tfb.fused_minus_block(t["q"], t["k"], t["v"], torch.ones(2, 5, 7),
                              None, t["c"], *ws, n_heads=2)
    before = [(k.launches, dict(k.variant_launches)) for k in tfb.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fused_block_kernel(t["q"], t["k"], t["v"], None, None, t["c"],
                               *ws, n_heads=2)
    with pytest.raises(RuntimeError, match="FusedMinusBlock"):
        tfb.fused_block_kernel(t["q"], t["k"], t["v"], None, None, t["c"],
                               ws[0].clone().requires_grad_(True), *ws[1:],
                               n_heads=2)
    assert [(k.launches, k.variant_launches) for k in tfb.KERNELS] == before


def test_path_launches_count_per_path_and_reset():
    """`path_launches` counts per path the kernel's plan took ("tile" or
    "cluster"), under the same rule as the other counters (a launch
    recorded into a captured graph counts at each replay), and `reset()`
    clears it with them."""
    k = tfb.FusedBlockKernel()
    assert k.path_launches == {"tile": 0, "cluster": 0}
    k._count("path_launches", "tile")
    k._count("path_launches", "tile")
    k._count("path_launches", "cluster")
    k._count("variant_launches", (False, False))
    assert k.path_launches == {"tile": 2, "cluster": 1}
    ledger = Counter({(k, "path_launches", "tile"): 3})
    cuda_binding.credit(ledger, times=2)
    assert k.path_launches == {"tile": 8, "cluster": 1}
    k.reset()
    assert k.path_launches == {"tile": 0, "cluster": 0}
    assert set(k.variant_launches.values()) == {0} and k.launches == 0


def _minus_block(d=8, h=2, seed=0, **kw):
    blk = MinusBlock(d, h, **kw)
    blk.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        blk.c.fill_(0.6)
        blk.norm.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    return blk


def test_minus_block_routes_pallas_fused():
    """A 2-D mask or none goes through FusedMinusBlock; a 3-D mask, and
    training with active dropout, take impl="pallas" (its plain path for
    the 3-D mask), as JAX apply_block_minus does; every route gives the
    xla block's numbers."""
    x = _inputs()
    t = {n: torch.from_numpy(x[n]) for n in ("q", "k", "v", "m", "sprev")}
    mask3 = torch.from_numpy(
        (np.random.default_rng(2).random((2, 5, 7)) > 0.3).astype(np.float32))
    blk = _minus_block()
    for mask in (t["m"], None, mask3):
        for sprev in (None, t["sprev"]):
            out, s = blk(t["q"], t["k"], t["v"], mask, sprev, impl="pallas_fused")
            ref, rs = blk(t["q"], t["k"], t["v"], mask, sprev, impl="xla")
            fused = "FusedMinusBlock" in type(out.grad_fn).__name__
            assert fused == (mask is None or mask.ndim == 2)
            _close(out.detach(), ref.detach(), OUT_TOL)
            np.testing.assert_allclose(s.detach(), rs.detach(), rtol=1e-6)
    dropout = _minus_block(dropout=0.1)
    out, s = dropout.train()(t["q"], t["k"], t["v"], t["m"], None,
                             impl="pallas_fused", generator=torch.Generator())
    assert "ScoredAttention" in type(s.grad_fn).__name__
    out, s = dropout.eval()(t["q"], t["k"], t["v"], t["m"], None,
                            impl="pallas_fused")
    assert "FusedMinusBlock" in type(out.grad_fn).__name__
    with torch.no_grad():
        out, s = blk(t["q"], t["k"], t["v"], t["m"], None, impl="pallas_fused",
                     emit_scores=False)
    assert out.grad_fn is None and s is None


def test_realformer_block_maps_pallas_fused_to_pallas():
    x = _inputs(d=12)
    t = {n: torch.from_numpy(x[n]) for n in ("q", "k", "v", "m")}
    blk = RealformerBlock(12, 2, 2)
    blk.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for gate in (blk.a, blk.b, blk.c):
            gate.fill_(0.8)
    out, s = blk(t["q"], t["k"], t["v"], t["m"], None, impl="pallas_fused")
    ref, rs = blk(t["q"], t["k"], t["v"], t["m"], None, impl="pallas")
    assert "ScoredAttention" in type(s.grad_fn).__name__
    assert torch.equal(out, ref) and torch.equal(s, rs)


def _exp(**model):
    exp = configs.get("mosei_trans")
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **{**TINY, **model}))


def _jexp(exp):
    return dataclasses.replace(
        jconfigs.get(exp.name),
        model=jconfigs.ModelConfig(**dataclasses.asdict(exp.model)),
        train=jconfigs.TrainConfig(**dataclasses.asdict(exp.train)))


def _perturb(params, seed):
    """Every gate c ~ U(0.25, 1.0), every LayerNorm's scale and bias moved
    from 1 and 0 (in a no_name slot every block's output is its LN bias:
    spread apart, no two blocks tie in the max pool)."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        x = np.asarray(x)
        if names[-1] == "c":
            return rng.uniform(0.25, 1.0, x.shape).astype(np.float32)
        if "norm" in names or "ln" in names:
            noise = 0.1 * rng.standard_normal(x.shape).astype(np.float32)
            return x + noise
        return x

    return jax.tree_util.tree_map_with_path(move, jax.device_get(params))


def _batch(m, b=3, seed=0):
    """Ragged masks, a no_name (all-zero) previous slot in row 0."""
    rng = np.random.default_rng(seed)
    batch = {}
    for kind, length, dim in (("l", m.l_len, m.l_dim), ("v", m.v_len, m.v_dim),
                              ("a", m.a_len, m.a_dim)):
        batch[kind] = rng.standard_normal((b, 2, length, dim)).astype(np.float32)
        mask = (rng.random((b, 2, length)) > 0.3).astype(np.float32)
        mask[..., 0] = 1.0
        mask[0, 0] = 0.0
        batch[kind][0, 0] = 0.0
        batch[kind + "_mask"] = mask
    batch["label"] = (rng.random((b, m.n_emotions)) > 0.6).astype(np.int32)
    return batch


@pytest.mark.parametrize("n_layers", [1, 2])
def test_tiny_mosei_trans_matches_jax_xla(n_layers):
    """Logits and step-1 gradients of every parameter at pallas_fused
    against the JAX model at impl="xla" (its own whole-model fused parity
    is a slow test, tests/test_pallas.py:161)."""
    exp = _exp(n_layers=n_layers)
    jexp = _jexp(exp)
    jmodel = jbuild(jexp)
    params = _perturb(jmodel.init(jax.random.PRNGKey(n_layers)), n_layers)
    batch = _batch(exp.model, seed=n_layers)

    @jax.jit
    def reference(p):
        grads = jax.grad(lambda p_: jeng.batch_loss(
            jmodel, jexp.train, p_, batch, None, True, "xla"))(p)
        return jmodel.apply(p, batch, impl="xla"), grads

    ref_logits, ref_grads = reference(params)
    ref_grads = from_jax_params(jax.device_get(ref_grads), exp.model)
    model = build_model(exp, device="cpu", seed=99)
    model.load_state_dict(from_jax_params(params, exp.model))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = [k.launches for k in tfb.KERNELS + tpa.KERNELS]
    with torch.no_grad():
        _close(model(tb, impl="pallas_fused"), ref_logits, GRAD_TOL, what="logits")
    model.train()
    engine.batch_loss(model, exp.train, tb, impl="pallas_fused").backward()
    assert [k.launches for k in tfb.KERNELS + tpa.KERNELS] == before  # CPU
    for n, p in model.named_parameters():
        if p.grad is None:
            # a block that reads no S_prev gives its gate c no gradient;
            # JAX's is zero
            assert n.endswith(".c")
            np.testing.assert_array_equal(ref_grads[n].numpy(), 0.0)
            continue
        _close(p.grad, ref_grads[n], GRAD_TOL, what=n)


def test_cli_train_mosei_trans_pallas_fused_on_cpu(capsys):
    """`cli train` is the k-fold experiment: two members, each trained on
    5 of the 10 samples (2 steps of batch 3), then evaluated."""
    res = main(["train", "mosei_trans", "--device", "cpu",
                "--epochs", "1", "--n-train", "10", "--n-test", "3",
                "--impl", "pallas_fused", *TINY_SET,
                "--set", "train.batch_size=3", "--set", "train.n_folds=2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    epochs = [x for x in lines if "epoch" in x]
    assert len(epochs) == 2 and all(x["steps"] == 2 for x in epochs)
    assert all(np.isfinite(x["train_loss"]) and np.isfinite(x["valid_loss"])
               for x in epochs)
    assert sum(h.steps for hist in res.fold_histories for h in hist) == 4
    assert lines[-1] == {"report": res.report}
