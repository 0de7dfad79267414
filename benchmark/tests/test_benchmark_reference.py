"""The yardstick on the CPU: the plain reference against the port's plain
(`xla`) path at tiny sizes, the bulk traffic generators against the
frozen per-sample samplers, and the FLOP, roofline and busy-time
arithmetic against hand counts."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.core import port
from benchmark.core.harness import Context
from benchmark.core import spec
from benchmark.reference import (flops, models, profile, roofline, synthetic,
                                 training, weights)

CPU = torch.device("cpu")


def _ctx(cell, tiny, seed=7):
    return Context(spec.Cell(cell), seed, CPU, tiny[cell])


def _tensors(arrays, keys, n):
    return {k: torch.as_tensor(arrays[k][:n]) for k in keys}


@pytest.mark.parametrize("cell,keys,gen", [
    ("mosei_trans.eval", synthetic.MOSEI_KEYS, synthetic.mosei_pairs),
    ("robot_demo.stream", synthetic.ROBOT_KEYS, synthetic.robot_samples)])
def test_reference_forward_matches_the_ports_plain_path(tiny, cell, keys, gen):
    ctx = _ctx(cell, tiny)
    model, w = ctx.member("a")
    batch = _tensors(gen(ctx.m, 12, 3, CPU), keys, 12)
    with torch.no_grad():
        got = model(batch, impl="xla")
        want = ctx.reference_forward()(w, batch)
    assert got.shape == want.shape == (12, ctx.m.n_emotions)
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert err <= 1e-5


def test_reference_steps_match_the_ports_train_step(tiny):
    from multimodal_emotion_processing_tpu_torch.train import engine

    ctx = _ctx("mosei_trans.train", tiny)
    tcfg = ctx.exp.train
    w = ctx.weights("member1")
    arrays = synthetic.mosei_pairs(ctx.m, 3 * 8, 5, CPU)
    batches = [{k: torch.as_tensor(arrays[k][i * 8:(i + 1) * 8])
                for k in synthetic.MOSEI_KEYS} for i in range(3)]
    state = engine.init_state(ctx.exp.model, tcfg, 0, device=CPU)
    port.load_weights(state.model, w)
    params = dict(state.model.named_parameters())
    losses, first = [], None
    for b in batches:
        losses.append(float(engine.train_step(state, tcfg, b, impl="xla")))
        if first is None:
            idx = {id(p): i for i, p in enumerate(state.optimizer.params)}
            first = {n: state.optimizer.mu[idx[id(p)]] / np.float32(0.1)
                     for n, p in params.items()}
    r_losses, r_first, r_change = training.train_steps(
        ctx.reference_forward(), w, batches, lr=tcfg.lr, clip=tcfg.grad_clip,
        weight_decay=tcfg.weight_decay)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    for n, p in params.items():
        assert torch.allclose(first[n], r_first[n], rtol=1e-3, atol=1e-6), n
        assert torch.allclose(p.detach() - w[n], r_change[n], rtol=1e-3,
                              atol=1e-6), n


def test_weights_cover_the_ports_state_dict(tiny):
    for cell in ("mosei_trans.eval", "robot_demo.stream"):
        ctx = _ctx(cell, tiny)
        model, w = ctx.member("x")
        assert set(model.state_dict()) == set(w)
        again = ctx.weights("x")
        assert all(torch.equal(w[k], again[k]) for k in w)
        assert not torch.equal(w[next(iter(w))], ctx.weights("y")[next(iter(w))])


def test_bulk_pairs_follow_the_per_sample_sampler(tiny):
    ctx = _ctx("mosei_trans.eval", tiny)
    m, n = ctx.m, 3000
    bulk = synthetic.mosei_pairs(m, n, 11, CPU)
    rng = np.random.default_rng(11)
    each = [synthetic.mosei_pair_sample(rng, m) for _ in range(n)]
    slow = {k: np.stack([s[k] for s in each]) for k in synthetic.MOSEI_KEYS}
    for arrays in (bulk, slow):
        for k, length in (("l", m.l_len), ("v", m.v_len), ("a", m.a_len)):
            mask = arrays[k + "_mask"]
            # masks are 1s then 0s; features are zero where masked
            assert np.all(np.diff(mask, axis=-1) <= 0)
            assert np.all(arrays[k][mask == 0] == 0)
            cur = arrays[k][:, 1]
            full = mask[:, 1].sum(-1) == length
            # summary frames: max >= mean >= min
            assert np.all(cur[:, 0] >= cur[:, 2] - 1e-5)
            assert np.all(cur[:, 2] >= cur[:, 1] - 1e-5)
            arrays.setdefault("_full", {})[k] = full.mean()
        arrays["_no_name"] = (arrays["l_mask"][:, 0].sum(-1) == 0).mean()
        arrays["_polluted"] = (arrays["a"][:, 1, 1] == -71.0).any(-1).mean()
        arrays["_labels"] = arrays["label"].mean()
    for k in ("l", "v", "a"):
        assert abs(bulk["_full"][k] - slow["_full"][k]) < 0.05
    for key, tol in (("_no_name", 0.03), ("_polluted", 0.04), ("_labels", 0.02)):
        assert abs(bulk[key] - slow[key]) < tol, key


def test_bulk_robot_samples_follow_the_per_sample_sampler(tiny):
    ctx = _ctx("robot_demo.stream", tiny)
    m, n = ctx.m, 3000
    bulk = synthetic.robot_samples(m, n, 13, CPU)
    rng = np.random.default_rng(13)
    each = [synthetic.robot_sample(rng, m) for _ in range(n)]
    slow = {k: np.stack([s[k] for s in each]) for k in synthetic.ROBOT_KEYS}
    stats = []
    for arrays in (bulk, slow):
        active = np.stack([np.abs(arrays[k]).sum((1, 2)) > 0
                           for k in ("v256", "v512", "v1024")], 1)
        assert np.all(active.sum(1) == 1)
        for k in ("l", "a"):
            assert np.all(np.diff(arrays[k + "_mask"], axis=-1) <= 0)
            assert np.all(arrays[k][arrays[k + "_mask"] == 0] == 0)
        stats.append([active.mean(0), (arrays["l_mask"].sum(-1) == m.l_len).mean(),
                      (arrays["v_mask"].sum(-1) == m.v_len).mean()])
    np.testing.assert_allclose(stats[0][0], stats[1][0], atol=0.04)
    assert abs(stats[0][1] - stats[1][1]) < 0.04
    assert abs(stats[0][2] - stats[1][2]) < 0.04


def test_forward_flops_hand_count():
    from multimodal_emotion_processing_tpu_torch import configs

    m = configs.get("mosei_trans").model
    d, e = 96, 7
    unify = 2 * d * (20 * 300 + 100 * 35 + 200 * 74)
    attention = 4 * d * (20 + 100 + 200) ** 2
    epilogue = 3 * 6 * d * d * (20 + 100 + 200)
    grid = unify + attention + epilogue + 2 * 6 * d * e
    assert flops.forward_flops_per_sample(m) == 2 * grid + 2 * e ** 3 + 2 * e ** 2 + 4 * e * e
    assert round(flops.forward_flops_per_sample(m) / 1e6, 1) == 194.2


def test_roofline_hand_counts():
    b, h, lq, lkv, dh = 64, 6, 20, 200, 16
    d = h * dh
    r = roofline.fused_bound(b, h, lq, lkv, dh, "split_tf32", False, False, False)
    nbytes = (2 * b * lq * d + 2 * b * lkv * d + 3 * d * d + 2 * d) * 4 + b * lkv * 4
    fl = 4 * b * h * lq * lkv * dh + 6 * b * lq * d * d
    assert r["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert r["ops_ms"] == pytest.approx(fl / (495e12 / 3) * 1e3)
    assert r["bound_ms"] == max(r["bytes_ms"], r["ops_ms"])
    s = roofline.scored_bound(1, 6, 25, 100, 32, "split_tf32", True, False)
    nbytes = (2 * 25 * 192 + 2 * 100 * 192) * 4 + 100 * 4 + 6 * 25 * 100 * 4
    assert s["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    p = roofline.scored_bwd_bounds(b, h, lq, lkv, dh, "split_tf32", False,
                                   False)["pair"]
    q_like, kv_like = b * lq * d * 4, b * lkv * d * 4
    nbytes = (2 * q_like + 2 * kv_like + b * lkv * 4 + q_like
              + 2 * b * h * lq * 4 + q_like + 2 * kv_like)
    assert p["bytes_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert p["ops_ms"] == pytest.approx(10 * b * h * lq * lkv * dh
                                        / (495e12 / 3) * 1e3)


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 30), (25, 26), (40, 41)]
    assert profile.busy_union(spans) == 12 + 10 + 1
    assert profile.idle_gaps(spans) == [(12, 20), (30, 40)]
    host = [("wait", 11, 21), ("copy", 14, 16), ("save", 29, 45)]
    assert profile.label_gaps(profile.idle_gaps(spans), host) == [
        ("save", 10e-9), ("copy", 8e-9)]
    ops = profile.by_name([("k<1>", 0, 10), ("k<2>", 0, 5), ("m", 1, 2)])
    assert profile.matching(ops, "k") == (pytest.approx(15e-9), 2)


def test_weight_scales():
    w = weights.make_weights([("x.norm1.weight", (4000,)), ("x.c", (1,)),
                              ("x.lin.weight", (8, 400))], 3, CPU)
    assert abs(float(w["x.norm1.weight"].mean()) - 1.0) < 0.02
    assert float(w["x.c"]) >= 0
    assert abs(float(w["x.lin.weight"].std()) - 400 ** -0.5) < 0.01
