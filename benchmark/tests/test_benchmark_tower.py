"""The `moonlight_trans.eval` driver on the CPU at tiny sizes: the sound
run is correct, each fault the cell's limits are set against
(drivers/tower_eval.FAULTS, planted in the reference's tower) and its
lower-precision control fail a limit, the longest transcripts are always
compared, and an altered answer fails."""

import time

import numpy as np
import pytest
import torch

from benchmark.core import harness, spec
from benchmark.conftest import TINY
from benchmark.core.trace import Tracer

TOWER = TINY["moonlight_trans.eval"]
SEED = 3_000_000_011


@pytest.fixture
def full_gain(monkeypatch):
    """The tower's weights at the published model's gain: each matrix's
    draw scaled by √(2,048 / its fan-in), so that a tiny tower's layers
    move its hidden states as far as the published widths do, and the
    routing correction bias by 64 / 8 experts, so that it moves as many
    choices among 8 experts as among 64."""
    cell = spec.Cell("moonlight_trans.eval")
    mod = cell.driver()
    real = mod.tower_weight

    def weight(seed, name, shape, device, n_layers):
        w = real(seed, name, shape, device, n_layers)
        if len(shape) == 2 and name != "model.embed_tokens.weight":
            w = (w.float() * (2048 / shape[1]) ** 0.5).to(w.dtype)
        if name.endswith("e_score_correction_bias"):
            w = w * 64 / 8
        return w

    monkeypatch.setattr(mod, "tower_weight", weight)
    return cell, mod


def _program(cell, mod):
    ctx = harness.Context(cell, SEED, "cpu", TOWER)
    program = mod.Cell(ctx)
    mod.window(program, 0.5, Tracer("cpu", False, dict))
    prog = program.outputs()
    program.release()
    return ctx, prog


def test_tower_sound_run_is_correct(full_gain):
    cell, _ = full_gain
    result, lines = harness.run(cell, seed=SEED, seconds=0.5, trace=False,
                                device="cpu", t0=time.perf_counter(),
                                overrides=TOWER)
    assert result["correct"] and set(result["checks"]) == {
        "hidden_err", "flip_share", "logit_err"}
    assert result["metrics"]["eval_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["top5", "no_bias", "no_shared",
                                   "cross_boundary", "no_kpe_rope",
                                   "partial_rows", "control"])
def test_tower_fault_fails_a_limit(full_gain, fault):
    cell, mod = full_gain
    ctx, prog = _program(cell, mod)
    ref = mod.reference(ctx, prog)
    sound = mod.compare(prog, ref)
    assert all(v <= cell.limits[k] for k, v in sound.items())
    bad = (mod.reference(ctx, prog, tf32=True) if fault == "control"
           else mod.reference(ctx, prog, fault=fault))
    got = mod.compare({**prog, "outputs": bad}, ref)
    assert any(got[k] > cell.limits[k] for k in ("hidden_err", "flip_share")), got
    if fault == "partial_rows":
        # the last layer's rows lost after its routing: no choice changes,
        # and the tokens that chose as the reference did moved
        assert got["flip_share"] == 0.0 and got["hidden_err"] > cell.limits[
            "hidden_err"]


def test_tower_flips_are_counted_per_token_and_layer():
    cell = spec.Cell("moonlight_trans.eval")
    mod = cell.driver()
    ref = torch.tensor([[[0, 1], [2, 3]], [[4, 5], [6, 7]], [[1, 2], [3, 4]]])
    same_sets = ref.flip(-1)
    assert not mod.flipped(same_sets, ref).any()
    other = ref.clone()
    other[1, 1, 0] = 5
    assert mod.flipped(other, ref).tolist() == [False, True, False]
    assert mod.flipped(ref[..., :1], ref).all()


def test_tower_compares_the_longest_transcripts():
    cell = spec.Cell("moonlight_trans.eval")
    mod = cell.driver()
    for seed in (SEED, SEED + 1):
        ctx = harness.Context(cell, seed, "cpu", TOWER)
        program = mod.Cell(ctx)
        n_tok = program.arrays["n_tokens"]
        longest = np.argsort(n_tok, kind="stable")[-mod.LONGEST:]
        assert set(longest) <= set(program.pairs.tolist())
        assert len(program.pairs) == TOWER["traffic"]["check_pairs"]
        program.release()


def test_tower_window_counts_what_the_readers_divide():
    cell = spec.Cell("moonlight_trans.eval")
    mod = cell.driver()
    ctx = harness.Context(cell, SEED, "cpu", TOWER)
    program = mod.Cell(ctx)
    win = mod.window(program, 3.0, Tracer("cpu", True, dict))
    w = win.work
    n_traced = len(w["traced_lengths"]) // program.batches_per_pass
    assert win.attempted == 10 * w["passes"] and win.failed == 0
    assert w["traced_batches"] == len(w["traced_lengths"])
    # every traced token routed to k experts in each MoE layer
    assert np.asarray(w["traced_routed"]).sum() == 2 * 2 * sum(
        map(sum, w["traced_lengths"]))
    assert w["tower_tokens"] == sum(map(sum, mod._lengths(
        program, w["passes"] - n_traced)))
    assert np.asarray(w["routed"]).sum() == 2 * 2 * w["tower_tokens"]
    # the tower's spans of the traced passes: one forward and one gather
    # a batch, and a route per MoE layer inside each forward
    span_s = w["traced_span_s"]
    assert set(span_s) == {"tower.pack", "tower.forward", "tower.route",
                           "tower.gather"}
    assert span_s["tower.route"] < span_s["tower.forward"]
    program.release()


def test_lengths_are_the_same_for_every_seed():
    cell = spec.Cell("moonlight_trans.eval")
    mod = cell.driver()
    p = cell.traffic
    a, b = (mod.lognormal_quantiles(512, *p["transcript_tokens"],
                                    np.random.default_rng(s)) for s in (1, 2))
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() >= 64 and a.max() <= 4096 and np.median(a) == 384


def _altered(out):
    out = out.clone()
    out[:, 0] = out[:, 0] + 0.05
    return out


def test_tower_altered_answer_fails(full_gain, monkeypatch):
    from multimodal_emotion_processing_tpu_torch.eval import ensemble

    real = ensemble._combination

    def broken(*args, **kw):
        combine = real(*args, **kw)
        return lambda batch: _altered(combine(batch))

    monkeypatch.setattr(ensemble, "_combination", broken)
    cell, _ = full_gain
    result, _ = harness.run(cell, seed=SEED, seconds=0.5, trace=False,
                            device="cpu", t0=time.perf_counter(),
                            overrides=TOWER)
    assert not result["correct"]
    assert result["checks"]["logit_err"]["value"] > result["checks"][
        "logit_err"]["limit"]
