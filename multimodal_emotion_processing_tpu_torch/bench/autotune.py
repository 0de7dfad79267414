"""Autotune: measure this card's winners for the selectable performance
knobs of one config and write them as a tuned record that `train`,
`eval`, `predict` and `serve` apply with `--tuned` (bench/autotune.py of
the JAX package, its arms, margin and merge rules).

Each arm times the program the command would run on the card: the
Trainer's captured train steps (engine.Trainer.fit, each step a replay,
its batches copied by the prefetcher as `train` copies them) and the
Ensemble's captured forward (eval.ensemble.Ensemble.logits), never eager
calls, which run several times slower on the card and would pick other
winners.  Every window ends with a fetch of its result (a
synchronisation); an arm takes the best of `reps` windows after one that
captures.

    python -m multimodal_emotion_processing_tpu_torch tune <config> \
        [-o tuned.json] [--arms scan,remat,impl] [--allow-lossy]
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
import traceback
from typing import Dict, List, Optional

# knobs whose winners change numerics (the int8 and float16 wires quantize
# features); measured and applied only under --allow-lossy
LOSSY_KNOBS = ("transfer_dtype",)

# relative margin a challenger must clear to replace the default: close
# calls keep the default
MARGIN = 1.05


def _batcher(exp, n: int):
    """A Batcher over n synthetic samples of the config, no shuffle, with
    R-Drop's duplicated rows where the config trains with them."""
    from ..data.loader import Batcher
    from ..data.synthetic import synthetic_dataset

    samples = synthetic_dataset(exp.name, exp.model, n, seed=0)
    return Batcher(samples, exp.train.batch_size, shuffle=False,
                   duplicate=exp.train.rdrop_kl)


def _release(torch, device) -> None:
    """Free what the last arm held (its graphs sit in reference cycles)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class _Deadline(Exception):
    """Raised by a fit's log callback to end it at its deadline."""


def train_windows(exp, loader, *, impl: str, device, epochs: int,
                  scan_steps: int = 1, transfer_dtype=None,
                  deadline: Optional[float] = None,
                  info: Optional[Dict] = None) -> List[float]:
    """Samples/s of each epoch after the first of one Trainer fit over
    `loader` (a zero-arg callable of numpy batches) with no valid batches:
    the Trainer's program, each step a replay on a card; epoch 1 captures.
    With `deadline` (a time.perf_counter value) the fit ends after the
    first timed epoch that ends past it.  `info` receives "capture_s", the
    train program's first call (its eager call and the capture; None on
    the CPU, where nothing is captured), and on a card "peak_bytes", the
    peak memory the fit added."""
    import torch

    from ..train import engine, schedule

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    trainer = engine.Trainer(exp, exp.train, impl=impl, device=device,
                             scan_steps=scan_steps,
                             transfer_dtype=transfer_dtype)
    sps: List[float] = []

    def log_cb(epoch, stats):
        if epoch > 0:
            sps.append(stats.samples_per_sec)
            if deadline is not None and time.perf_counter() >= deadline:
                raise _Deadline

    trainer.log_cb = log_cb
    try:
        trainer.fit(loader, lambda: iter(()), epochs=epochs,
                    stopper=schedule.EarlyStop(patience=epochs + 1,
                                               save_guard=None))
    except _Deadline:
        pass
    if info is not None:
        ms = trainer.programs["train"].capture_ms
        info["capture_s"] = sum(ms) / 1e3 if ms else None
        if device.type == "cuda":
            info["peak_bytes"] = torch.cuda.max_memory_allocated(device) - before
    del trainer
    _release(torch, device)
    return sps


def _measure_train(exp, *, impl: str, device, n_batches: int, reps: int,
                   scan_steps: int = 1, transfer_dtype=None,
                   distinct: bool = False,
                   info: Optional[Dict] = None) -> Dict:
    """Train samples/s of the Trainer's program: one fit of 1 + reps epochs
    of `n_batches` host-fed batches (the same batch again, or with
    `distinct` that many distinct ones) and no valid batches; epoch 1
    captures, the best of the others counts (`train_windows`, and its
    `info`).  On a card also the peak memory the fit added."""
    base = _batcher(exp, exp.train.batch_size * (n_batches if distinct else 1))
    batches = list(base())
    if not distinct:
        batches = batches * n_batches
    info = {} if info is None else info
    sps = train_windows(exp, lambda: iter(batches), impl=impl, device=device,
                        epochs=1 + reps, scan_steps=scan_steps,
                        transfer_dtype=transfer_dtype, info=info)
    out = {"train_sps": max(sps)}
    if "peak_bytes" in info:
        out["peak_bytes"] = info["peak_bytes"]
    return out


def _measure_infer(exp, *, impl: str, device, steps: int, reps: int,
                   stacked=None, batch=None) -> float:
    """Inference samples/s of the Ensemble's captured forward on one
    batch already on the device (one member; `batch`, by default one of
    the config's synthetic samples), on the grid path `stacked` selects
    (Ensemble(stacked=)): utils/timing.best_window_ms over its replays."""
    import torch

    from ..data.loader import to_device
    from ..eval.ensemble import Ensemble
    from ..models import build_model
    from ..utils.timing import best_window_ms

    if batch is None:
        batch = to_device(next(iter(_batcher(
            dataclasses.replace(exp, train=dataclasses.replace(
                exp.train, rdrop_kl=False)), exp.train.batch_size)())), device)
    ens = Ensemble([build_model(exp, device=device)], impl=impl,
                   dtype=exp.train.compute_dtype, stacked=stacked)
    ms = best_window_ms(ens.logits, batch, steps=steps, reps=reps)
    del ens
    _release(torch, device)
    return next(iter(batch.values())).shape[0] * 1e3 / ms


def _measure_step(exp, *, impl: str, device, steps: int, reps: int) -> Dict:
    out = _measure_train(exp, impl=impl, device=device, n_batches=steps,
                         reps=reps)
    out["infer_sps"] = _measure_infer(exp, impl=impl, device=device,
                                      steps=steps, reps=reps)
    return out


def _rounded(row: Dict) -> Dict:
    return {k: (round(v, 1) if isinstance(v, float) else v)
            for k, v in row.items()}


def tune(config_name: str, *, arms: Optional[List[str]] = None,
         allow_lossy: bool = False, steps: int = 20, reps: int = 4,
         scan_ks=(8, 32), device=None, quiet: bool = True) -> Dict:
    """Measure the requested arms on `device` ("cuda" unless "cpu" is
    asked for) and return the tuned record.

    Arms (default: every applicable one), JAX's:
      scan      the Trainer's scan_steps in {1} + scan_ks at the config's
                attention implementation: k batches copied together, k
                replays launched back to back; 1 over `steps` batches,
                k over 2k;
      stacked   the Ensemble's captured inference forward at impl "xla"
                (the only impl the stacked RealFormer grid takes) with the
                stacked grid off and on, RealFormer families only;
                `stacked` wins by MARGIN;
      transfer  the host-fed wire float32 against int8 and float16 through
                the prefetcher, over 4 distinct batches (lossy: only with
                allow_lossy);
      remat     per-block rematerialisation (ModelConfig.remat) off and
                on at the config's attention implementation, with each
                fit's peak memory on a card; without remat an
                out-of-memory error makes remat the winner;
      impl      xla, flash and pallas train and inference; a kernel arm
                that raises is recorded as {"error": ...} and does not
                win.
    Scaled presets tune like any config, at their dims, batch and
    compute dtype.  A challenger must beat the default by MARGIN; a tie
    keeps the default."""
    import torch

    from .. import configs
    from ..utils.device import resolve_device
    from .doctor import smi_line

    exp = configs.get(config_name)
    dev = resolve_device(device)
    all_arms = ["scan", "stacked", "transfer", "remat", "impl"]
    arms = [a for a in (arms or all_arms) if a in all_arms]
    if "transfer" in arms and not allow_lossy:
        arms.remove("transfer")
    if "stacked" in arms and exp.model.block != "realformer":
        arms.remove("stacked")
    impl0 = exp.model.attn_impl

    def log(msg):
        if not quiet:
            print(msg, file=sys.stderr, flush=True)

    def with_remat(flag):
        return dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, remat=flag))

    measured: Dict = {}
    winners: Dict = {}
    step_rows: Dict = {}   # impl -> its train / infer row

    if "scan" in arms:
        step_rows[impl0] = _measure_step(exp, impl=impl0, device=dev,
                                         steps=steps, reps=reps)
        measured["per_dispatch"] = {"impl": impl0,
                                    **_rounded(step_rows[impl0])}
        rows = {1: step_rows[impl0]["train_sps"]}
        for k in scan_ks:
            rows[k] = _measure_train(exp, impl=impl0, device=dev,
                                     n_batches=2 * k, reps=reps,
                                     scan_steps=k)["train_sps"]
            log(f"scan k={k}: {rows[k]:.1f} samples/s (k=1 {rows[1]:.1f})")
        measured["scan_train_sps"] = {str(k): round(v, 1)
                                      for k, v in rows.items()}
        best_k = max(rows, key=rows.get)
        winners["scan_steps"] = int(best_k) if (
            best_k != 1 and rows[best_k] >= MARGIN * rows[1]) else 1

    if "stacked" in arms:
        off, on = (_measure_infer(exp, impl="xla", device=dev, steps=steps,
                                  reps=reps, stacked=flag)
                   for flag in (False, True))
        measured["stacked_infer_sps"] = {"impl": "xla", "off": round(off, 1),
                                         "on": round(on, 1)}
        winners["stacked"] = bool(on >= MARGIN * off)
        log(f"stacked off {off:.1f} / on {on:.1f} samples/s")

    if "transfer" in arms:
        n = 4
        rows = {wire: _measure_train(exp, impl=impl0, device=dev, n_batches=n,
                                     reps=reps, transfer_dtype=wire,
                                     distinct=True)["train_sps"]
                for wire in (None, "int8", "float16")}
        measured["datafed_train_sps"] = {
            (w or "float32"): round(v, 1) for w, v in rows.items()}
        f32 = rows.pop(None)
        best = max(rows, key=rows.get)
        winners["transfer_dtype"] = best if rows[best] >= MARGIN * f32 else None
        log(f"wire {measured['datafed_train_sps']} samples/s")

    if "remat" in arms:
        row: Dict = {"impl": impl0}
        try:
            off = _measure_train(with_remat(False), impl=impl0, device=dev,
                                 n_batches=steps, reps=reps)
        except torch.OutOfMemoryError as e:
            off = None
            row["off_error"] = repr(e)
            _release(torch, dev)
        on = _measure_train(with_remat(True), impl=impl0, device=dev,
                            n_batches=steps, reps=reps)
        row.update(off=None if off is None else round(off["train_sps"], 1),
                   on=round(on["train_sps"], 1))
        if dev.type == "cuda":
            row["peak_bytes"] = {"off": None if off is None
                                 else off["peak_bytes"],
                                 "on": on["peak_bytes"]}
        measured["remat_train_sps"] = row
        if off is None:
            winners["remat"] = True   # only remat trains at these shapes
        elif exp.model.remat:
            winners["remat"] = not off["train_sps"] >= MARGIN * on["train_sps"]
        else:
            winners["remat"] = on["train_sps"] >= MARGIN * off["train_sps"]
        log(f"remat {row}")

    if "impl" in arms:
        scores = {}
        for impl in ("xla", "flash", "pallas"):
            try:
                if impl not in step_rows:
                    step_rows[impl] = _measure_step(exp, impl=impl, device=dev,
                                                    steps=steps, reps=reps)
            except Exception as e:  # recorded, as JAX's tune records it
                traceback.print_exc()
                measured[impl] = {"error": repr(e)}
                _release(torch, dev)
                continue
            measured[impl] = _rounded(step_rows[impl])
            scores[impl] = step_rows[impl]["train_sps"]
        if "xla" not in scores:
            winners["impl"] = "xla"
        else:
            best = max(scores, key=scores.get)
            winners["impl"] = best if (
                best != "xla" and scores[best] >= MARGIN * scores["xla"]) \
                else "xla"
        log("impl " + ", ".join(f"{k} {v}" for k, v in measured.items()
                                if k in ("xla", "flash", "pallas")))

    smi = smi_line() if dev.type == "cuda" else None
    return {
        "config": config_name,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "power_limit": smi.split(",")[-1].strip() if smi else None,
        "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "tuned_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        "allow_lossy": allow_lossy,
        "margin": MARGIN,
        "measured": measured,
        "winners": winners,
    }


# knob -> (CLI arg name, parser default): a tuned winner fills the arg only
# while it still holds the parser default, so an explicit flag wins.  An
# explicitly passed default value cannot be told from the default and is
# overridden.
_ARG_OF = {
    "scan_steps": ("scan_steps", 1),
    "impl": ("impl", None),
    "transfer_dtype": ("transfer_dtype", None),
    "stacked": ("stacked_grid", False),
}


def apply_tuned(args, path: str) -> Dict:
    """Merge a tuned record's winners into parsed CLI args, in place.

    Returns the {knob: value} actually applied.  Winners for knobs the
    command does not take are skipped; a record tuned for another config
    than the one being run is an error (the winners are per config)."""
    with open(path) as f:
        rec = json.load(f)
    cfg = getattr(args, "config", None)
    if cfg is not None and rec.get("config") not in (None, cfg):
        raise SystemExit(
            f"--tuned {path}: tuned for config {rec.get('config')!r}, "
            f"running {cfg!r}; run `tune {cfg}`")
    applied = {}
    for knob, value in (rec.get("winners") or {}).items():
        if knob == "remat":
            # a model-config override, not a driver flag: it rides --set
            # (an explicit --set model.remat=... wins), both ways, since a
            # tuned remat=false matters where a config defaults to remat on
            sets = getattr(args, "set", None)
            if (isinstance(value, bool) and sets is not None
                    and not any(s.startswith("model.remat=") for s in sets)):
                sets.append(f"model.remat={'true' if value else 'false'}")
                applied["remat"] = value
            continue
        if knob not in _ARG_OF:
            continue
        arg, default = _ARG_OF[knob]
        if not hasattr(args, arg):
            continue   # the command does not take this knob
        if getattr(args, arg) != default:
            continue   # an explicit flag wins
        if value == default or value is None or value is False:
            continue
        setattr(args, arg, value)
        applied[knob] = value
    return applied
