"""Environment doctor: measure the properties of this card and host that
every performance number of the port depends on (bench/doctor.py of the
JAX package, rewritten for a CUDA card).

    python -m multimodal_emotion_processing_tpu_torch doctor [--json-only]
        [--device cpu]

Probes, each a few milliseconds to a second:

  * the device: its name and power limit (`nvidia-smi`) and the device
    count; a card held below its 700 W maximum runs slower under load;
  * the launch floor: the p50 of one tiny kernel launch plus
    `torch.cuda.synchronize()`, and of one replay of a captured one-node
    CUDA graph plus the synchronize, the floor under every step;
  * host-to-device bandwidth: an 8 MB copy from pageable and from pinned
    host memory, best of several;
  * matmul rate: 1024³ GEMMs in f32 with TF32 off, in TF32 and in bf16,
    timed by CUDA events, each as TFLOP/s and as a share of the H100's
    67, 495 and 989 TFLOP/s (bench/flops.PEAK_TFLOPS; MEP_PEAK_TFLOPS
    overrides the bf16 peak); single 1024³ GEMMs underfill the card;
  * sync honesty: the wall to `torch.cuda.synchronize()` after a chain of k
    dependent matmuls against the wall to a `.item()` fetch of its last
    value: a synchronize that returned early would read far below the
    fetch.

With `--device cpu` the same keys are written, measured on the host where
a probe has a host counterpart and null where it has none (no graph
replay, no host-to-device copy, no card peak).  Prints one JSON object on
stdout and, unless --json-only, what it found on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .flops import PEAK_TFLOPS


def _p50(samples):
    s = sorted(samples)
    return s[len(s) // 2]


def smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    first card; "not measured (...)" where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not measured ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not measured"


def _timed(torch, fn, device, reps: int) -> float:
    """Seconds per call of fn, by CUDA events over `reps` calls after a
    warm-up (the host clock around a synchronize on the CPU)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def run(device=None, *, scan_k: int = 64, n: int = 1024, chain_dim: int = 512,
        log=lambda m: None) -> dict:
    """The probes on `device` ("cuda" unless "cpu" is asked for); returns
    the record."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = {"platform": "gpu" if cuda else "cpu",
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "device_count": torch.cuda.device_count() if cuda else 0,
           "nvidia_smi": smi_line() if cuda else None,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"device: {out['device']} x {out['device_count']} "
        f"({out['nvidia_smi']}); torch {out['torch']}, CUDA {out['cuda']}")

    # --- launch floor -------------------------------------------------------
    x = torch.zeros((), device=dev)
    x.add_(1.0)
    sync()
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        x.add_(1.0)
        sync()
        times.append(time.perf_counter() - t0)
    out["launch_floor_ms"] = _p50(times) * 1e3
    out["graph_replay_floor_ms"] = None
    if cuda:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            x.add_(1.0)   # warm on the side stream before the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x.add_(1.0)
        graph.replay()
        sync()
        times = []
        for _ in range(50):
            t0 = time.perf_counter()
            graph.replay()
            sync()
            times.append(time.perf_counter() - t0)
        out["graph_replay_floor_ms"] = _p50(times) * 1e3
    log(f"launch floor (p50 of one tiny launch + synchronize): "
        f"{out['launch_floor_ms']:.4f} ms; one-node graph replay: "
        f"{out['graph_replay_floor_ms']} ms")

    # --- host-to-device bandwidth ---------------------------------------------
    out["h2d_pageable_gb_s"] = out["h2d_pinned_gb_s"] = None
    if cuda:
        host = torch.ones(2 * 1024 * 1024)          # 8 MB of f32
        for key, src in (("h2d_pageable_gb_s", host),
                         ("h2d_pinned_gb_s", host.pin_memory())):
            src.to(dev, non_blocking=True)
            sync()
            best = float("inf")
            for _ in range(5):
                t0 = time.perf_counter()
                src.to(dev, non_blocking=True)
                sync()
                best = min(best, time.perf_counter() - t0)
            out[key] = src.nbytes / best / 1e9
        log(f"H2D 8 MB, best of 5: pageable {out['h2d_pageable_gb_s']:.2f} "
            f"GB/s, pinned {out['h2d_pinned_gb_s']:.2f} GB/s")

    # --- matmul rate ------------------------------------------------------------
    peaks = dict(PEAK_TFLOPS)
    if os.environ.get("MEP_PEAK_TFLOPS"):
        peaks["bfloat16"] = float(os.environ["MEP_PEAK_TFLOPS"])
    flops = 2 * n ** 3
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    try:
        for name, dtype, tf32, peak in (
                ("f32", torch.float32, False, peaks["float32"]),
                ("tf32", torch.float32, True, peaks["tf32"]),
                ("bf16", torch.bfloat16, False, peaks["bfloat16"])):
            if not cuda and name == "tf32":
                out[f"matmul_{name}_tflop_s"] = None
                out[f"matmul_{name}_peak_share"] = None
                continue
            torch.backends.cuda.matmul.allow_tf32 = tf32
            a = torch.ones((n, n), dtype=dtype, device=dev)
            s = _timed(torch, lambda: a @ a, dev, reps=50 if cuda else 3)
            tflops = flops / s / 1e12
            out[f"matmul_{name}_tflop_s"] = tflops
            out[f"matmul_{name}_peak_share"] = tflops / peak if cuda else None
            log(f"matmul {n}^3 {name}: {tflops:.2f} TFLOP/s"
                + (f" ({tflops / peak:.1%} of {peak:g} TFLOP/s)" if cuda
                   else ""))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was

    # --- sync honesty -------------------------------------------------------------
    c0 = torch.eye(chain_dim, device=dev)

    def chain():
        c = c0
        for _ in range(scan_k):
            c = c @ c * 1e-3 + 1.0
        return c

    chain()
    sync()
    t_sync = t_fetch = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        chain()
        sync()
        t_sync = min(t_sync, time.perf_counter() - t0)
        t0 = time.perf_counter()
        chain()[0, 0].item()
        t_fetch = min(t_fetch, time.perf_counter() - t0)
    ratio = t_fetch / max(t_sync, 1e-9)
    out["sync_ms"] = t_sync * 1e3
    out["sync_fetch_ms"] = t_fetch * 1e3
    out["sync_early_ratio"] = ratio
    out["sync_honest"] = bool(ratio < 3.0)
    log(f"sync probe (k={scan_k} chained {chain_dim}^2 matmuls): "
        f"synchronize {t_sync * 1e3:.2f} ms, .item() {t_fetch * 1e3:.2f} ms "
        f"(ratio {ratio:.2f})")
    if not out["sync_honest"]:
        log("  ! synchronize returned well before the work was done: end "
            "timed windows with a fetch of the result")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="multimodal_emotion_processing_tpu_torch doctor")
    ap.add_argument("--json-only", action="store_true",
                    help="no findings on stderr")
    ap.add_argument("--scan-k", type=int, default=64,
                    help="chain length of the sync-honesty probe")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    log = (lambda m: None) if args.json_only else (
        lambda m: print(m, file=sys.stderr, flush=True))
    out = run(args.device, scan_k=args.scan_k, log=log)
    print(json.dumps(out), flush=True)
    return out
