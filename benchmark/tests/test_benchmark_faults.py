"""A run with the timed path broken underneath must come out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (`harness.run`) at a tiny size on the CPU, with one fault planted in
the program where it does its work: a step that leaves its state
unchanged, half of each batch left out (the loss's mean over the rest),
an answer altered where it is produced.  The cells run on one card, so
no exchange between cards exists to leave out.  A test of the sound run
stands beside them: the same run without the fault is correct."""

import time

import pytest
import torch

from benchmark.core import harness, spec


def _run(cell, tiny, seed=3_000_000_007):
    result, lines = harness.run(spec.Cell(cell), seed=seed, seconds=1.0,
                                trace=False, device="cpu",
                                t0=time.perf_counter(), overrides=tiny[cell])
    assert len(lines) == len(result["checks"]) and list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("cell", ["mosei_trans.train", "mosei_trans.eval",
                                  "robot_demo.stream", "robot_demo.serve"])
def test_sound_run_is_correct(tiny, cell):
    assert _run(cell, tiny)["correct"]


def test_step_leaving_state_unchanged(tiny, monkeypatch):
    from multimodal_emotion_processing_tpu_torch.train import engine

    monkeypatch.setattr(engine.Optimizer, "step",
                        lambda self, grads=None, *, active=None: None)
    r = _run("mosei_trans.train", tiny)
    assert not r["correct"] and r["checks"]["change_gap"]["value"] >= 0.99


def test_half_batch_left_out_in_training(tiny, monkeypatch):
    from multimodal_emotion_processing_tpu_torch.train import engine

    real = engine.batch_loss

    def half(model, tcfg, batch, **kw):
        rows = batch["label"].shape[0] // 2
        return real(model, tcfg, {k: v[:rows] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(engine, "batch_loss", half)
    assert not _run("mosei_trans.train", tiny)["correct"]


def _altered(out):
    out = out.clone()
    out[:, 0] = out[:, 0] + 0.05
    return out


def _halved(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0.0
    return out


@pytest.mark.parametrize("fault", [_altered, _halved])
def test_eval_answers_broken(tiny, monkeypatch, fault):
    from multimodal_emotion_processing_tpu_torch.eval import ensemble

    real = ensemble._combination

    def broken(*args, **kw):
        combine = real(*args, **kw)
        return lambda batch: fault(combine(batch))

    monkeypatch.setattr(ensemble, "_combination", broken)
    assert not _run("mosei_trans.eval", tiny)["correct"]


def _patch_serving(monkeypatch, module, fault):
    from multimodal_emotion_processing_tpu_torch.serve import graphs, stream

    real = stream.ensemble_serve_fn

    def broken(*args, **kw):
        fn = real(*args, **kw).fn

        def run(batch):
            pred, probs = fn(batch)
            return fault(pred), fault(probs)

        return graphs.GraphedFunction(run, torch.device("cpu"))

    monkeypatch.setattr(module, "ensemble_serve_fn", broken)


def test_stream_answer_altered(tiny, monkeypatch):
    from multimodal_emotion_processing_tpu_torch.serve import stream

    _patch_serving(monkeypatch, stream, _altered)
    assert not _run("robot_demo.stream", tiny)["correct"]


@pytest.mark.parametrize("fault", [_altered, _halved])
def test_served_answers_broken(tiny, monkeypatch, fault):
    from multimodal_emotion_processing_tpu_torch.serve import server

    _patch_serving(monkeypatch, server, fault)
    assert not _run("robot_demo.serve", tiny)["correct"]
