#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card's name and power limit, and the build of every CUDA
     kernel from the sources in this checkout (one nvcc per source, started
     together);
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it and at edge cases, with its time, the
     plain version's, one library call's (timing yardstick only) and the
     bound the card sets for the same work;
  3. main path: `mosei_trans_s1024`, four seeded random members in bf16,
     served through the port's BatchingServer (16 concurrent synthetic
     requests) and StreamingPredictor (4 batch-1 requests), with the kernel
     launch counts of that run and the outputs held against the plain
     attention path (impl="xla") on the same members.
Then one JSON line of the kernels, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
Details go to chip_smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_JSON = ROOT / "chip_smoke_out" / "chip_smoke.json"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; FLOP/s by type —
# bf16 on the tensor cores, f32 outside them (TF32 is off in this script)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

F32_TOL = 1e-5     # f32 with TF32 off: only summation order differs
BF16_TOL = 5e-2    # bf16 operands and output (tests/test_flash.py:90)

# the nine (Lq, Lkv) stream shapes of mosei_trans_s1024 (l/v/a = 128/256/512)
S1024_LENS = (128, 256, 512)
S1024_HEADS, S1024_DH, SERVE_BUCKET = 8, 128, 8
N_MEMBERS, N_CONCURRENT, N_STREAMING = 4, 16, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(b, h, lq, lkv, dh, dtype_name, mask_itemsize):
    """Least time for o = softmax(q·kᵀ/√dh + neg)·v on this card: q, k, v
    and the mask read once and o written once, against the two products'
    flops at the peak of the operand type."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    d = h * dh
    nbytes = (2 * b * lq * d + 2 * b * lkv * d) * itemsize + b * lkv * mask_itemsize
    flops = 4.0 * b * h * lq * lkv * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def attention_inputs(torch, g, b, lq, lkv, h, dh, dtype, mask_kind):
    d = h * dh
    q = torch.randn(b, lq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, lkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, lkv, d, generator=g, device="cuda").to(dtype)
    if mask_kind == "none":
        return q, k, v, None
    # a ragged valid prefix per row, like summary masking gives, and row 0
    # fully masked (the no_name sample) when asked for
    lens = torch.randint(1, lkv + 1, (b,), generator=g, device="cuda")
    mask = (torch.arange(lkv, device="cuda")[None, :] < lens[:, None]).to(dtype)
    if mask_kind == "zero_row":
        mask[0] = 0
    return q, k, v, mask


def phase_kernels(torch, report):
    from multimodal_emotion_processing_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_processing_tpu_torch.ops.attention import (
        MASK_PENALTY, split_heads)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for lq in S1024_LENS:
            for lkv in S1024_LENS:
                cases.append(dict(main=True, dtype=dtype, b=SERVE_BUCKET, lq=lq,
                                  lkv=lkv, h=S1024_HEADS, dh=S1024_DH,
                                  mask="zero_row"))
        for (b, lq, lkv, h, dh, mask) in (
                (4, 128, 64, 8, 128, "ragged"), (3, 37, 100, 6, 16, "ragged"),
                (2, 20, 200, 2, 16, "zero_row"), (2, 5, 20, 2, 16, "zero_row"),
                (2, 64, 64, 8, 128, "none"), (2, 128, 1024, 8, 128, "zero_row"),
                (2, 70, 300, 4, 256, "zero_row"), (2, 33, 77, 3, 48, "zero_row"),
                (1, 1, 1, 1, 1, "ragged")):
            cases.append(dict(main=False, dtype=dtype, b=b, lq=lq, lkv=lkv,
                              h=h, dh=dh, mask=mask))
    rows, ok = [], True
    for c in cases:
        dname = str(c["dtype"]).removeprefix("torch.")
        q, k, v, mask = attention_inputs(torch, g, c["b"], c["lq"], c["lkv"],
                                         c["h"], c["dh"], c["dtype"], c["mask"])
        out = fa.flash_forward_kernel(q, k, v, mask, n_heads=c["h"])
        torch.cuda.synchronize()
        ref = fa.flash_forward_plain(q, k, v, mask, n_heads=c["h"])
        abs_err = (out.float() - ref.float()).abs().max().item()
        err = abs_err / max(1.0, ref.float().abs().max().item())
        tol = BF16_TOL if c["dtype"] == torch.bfloat16 else F32_TOL
        good = bool(torch.isfinite(out).all().item()) and err <= tol
        ok &= good
        row = dict(dtype=dname, b=c["b"], lq=c["lq"], lkv=c["lkv"], h=c["h"],
                   dh=c["dh"], mask=c["mask"], main_path=c["main"],
                   max_abs_err=abs_err, max_norm_err=err, tol=tol, ok=good)
        if c["main"]:
            qh, kh, vh = (split_heads(t, c["h"]).contiguous() for t in (q, k, v))
            bias = (-MASK_PENALTY * (1.0 - mask.float())).to(c["dtype"])[:, None, None, :]
            row["ms"] = time_ms(torch, lambda: fa.flash_forward_kernel(
                q, k, v, mask, n_heads=c["h"]))
            row["plain_ms"] = time_ms(torch, lambda: fa.flash_forward_plain(
                q, k, v, mask, n_heads=c["h"]))
            row["library_ms"] = time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=bias))
            row.update(attention_bound(c["b"], c["h"], c["lq"], c["lkv"],
                                       c["dh"], dname, mask.element_size()))
        rows.append(row)
        timing = (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                  if c["main"] else "")
        log(f"[kernels] flash_fwd {dname} B={c['b']} Lq={c['lq']} "
            f"Lkv={c['lkv']} H={c['h']} dh={c['dh']} mask={c['mask']} "
            f"max_abs_err={abs_err:.3e} norm_err={err:.3e} tol={tol:g} "
            f"{'ok' if good else 'FAIL'}{timing}")
    report["kernel_cases"] = rows
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version")
    main_bf16 = [r for r in rows if r["main_path"] and r["dtype"] == "bfloat16"]
    summary = {k: sum(r[k] for r in main_bf16)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    summary["bound_by"] = ("operations" if sum(
        r["bound_by"] == "operations" for r in main_bf16) * 2 > len(main_bf16)
        else "bytes")
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return summary


def ensure_no_name(samples):
    """The main path must carry a no_name request (previous slot all zero,
    all-zero masks): make sample 0 one if the seed gave none."""
    if not any(float(s["l_mask"][0].sum()) == 0.0 for s in samples):
        for kind in ("l", "v", "a"):
            samples[0][kind][0] = 0.0
            samples[0][kind + "_mask"][0] = 0.0
    return samples


def phase_main_path(torch, report):
    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.ops.flash_attention import flash_forward_kernel
    from multimodal_emotion_processing_tpu_torch.serve import (
        BatchingServer, StreamingPredictor, ensemble_serve_fn)

    exp = configs.get("mosei_trans_s1024")
    dtype = exp.train.compute_dtype
    members = [build_model(exp, device="cuda", seed=i) for i in range(N_MEMBERS)]
    n_params = sum(p.numel() for p in members[0].parameters())
    samples = ensure_no_name(synthetic_dataset(exp.name, exp.model,
                                               N_CONCURRENT, seed=7))
    log(f"[main] {exp.name}: dim={exp.model.dim} heads={exp.model.n_heads} "
        f"lens l/v/a={exp.model.l_len}/{exp.model.v_len}/{exp.model.a_len} "
        f"params/member={n_params} members={N_MEMBERS} dtype={dtype} "
        f"impl={exp.model.attn_impl}")

    srv = BatchingServer(members, exp.thresholds, impl=exp.model.attn_impl,
                         max_delay_ms=3.0, dtype=dtype)
    sp = StreamingPredictor(members, exp.thresholds, impl=exp.model.attn_impl,
                            dtype=dtype)
    try:
        srv.warmup(samples[0])
        sp.warmup(samples[0])
        torch.cuda.synchronize()

        flash_forward_kernel.reset()
        t0 = time.perf_counter()
        done = {}
        futs = []
        for i, s in enumerate(samples):
            t_submit = time.perf_counter()
            fut = srv.submit(s)
            fut.add_done_callback(
                lambda f, i=i, t=t_submit: done.__setitem__(
                    i, time.perf_counter() - t))
            futs.append(fut)
        served = [f.result(timeout=600) for f in futs]
        elapsed = time.perf_counter() - t0
        stats = srv.stats()
        stream_ms, streamed = [], []
        for s in samples[:N_STREAMING]:
            t1 = time.perf_counter()
            streamed.append(sp.predict(s))
            stream_ms.append((time.perf_counter() - t1) * 1e3)
        launches = flash_forward_kernel.launches
    finally:
        srv.close()

    forwards = stats["batches"] + N_STREAMING
    expected = 18 * N_MEMBERS * forwards
    lat_ms = sorted(v * 1e3 for v in done.values())
    main = dict(config=exp.name, params_per_member=n_params,
                requests=len(served), batches=stats["batches"],
                by_bucket=stats["by_bucket"], forwards=forwards,
                flash_launches=launches, expected_launches=expected,
                server_elapsed_s=elapsed, server_req_per_s=len(served) / elapsed,
                server_p50_ms=statistics.median(lat_ms), server_max_ms=max(lat_ms),
                stream_ms=stream_ms, stream_p50_ms=statistics.median(stream_ms))
    report["main_path"] = main
    log(f"[main] server: {len(served)} requests in {elapsed * 1e3:.2f} ms = "
        f"{main['server_req_per_s']:.2f} req/s; p50 latency "
        f"{main['server_p50_ms']:.2f} ms, max {main['server_max_ms']:.2f} ms; "
        f"batches={stats['batches']} by_bucket={stats['by_bucket']}")
    log(f"[main] streaming: {N_STREAMING} batch-1 predicts, p50 "
        f"{main['stream_p50_ms']:.2f} ms ({', '.join(f'{t:.2f}' for t in stream_ms)})")
    log(f"[main] flash_fwd launches={launches} expected 18 x {N_MEMBERS} "
        f"members x {forwards} forwards = {expected}")

    pred = np.stack([p for p, _ in served])
    probs = np.stack([q for _, q in served])
    n_off = len(exp.thresholds)
    if pred.shape != (N_CONCURRENT, exp.model.n_emotions) or probs.shape != (
            N_CONCURRENT, n_off):
        raise AssertionError(f"served shapes {pred.shape} {probs.shape}")
    if not (np.isfinite(pred).all() and np.isfinite(probs).all()):
        raise AssertionError("served outputs are not finite")

    # the same members through the plain attention path, all requests at once
    ref_fn = ensemble_serve_fn(members, exp.thresholds, impl="xla", dtype=dtype)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])).cuda()
             for k in samples[0] if k != "label"}
    ref_pred, ref_probs = (t.cpu().numpy() for t in ref_fn(batch))
    scale = max(1.0, float(np.abs(ref_pred).max()))
    err_pred = float(np.abs(pred - ref_pred).max()) / scale
    err_probs = float(np.abs(probs - ref_probs).max())
    err_stream = max(float(np.abs(p - ref_pred[i]).max()) / scale
                     for i, (p, _) in enumerate(streamed))
    main.update(err_vs_xla_pred=err_pred, err_vs_xla_probs=err_probs,
                err_stream_vs_xla=err_stream)
    log(f"[main] vs impl=xla on the same members: logits norm_err={err_pred:.3e} "
        f"probs abs_err={err_probs:.3e} streaming norm_err={err_stream:.3e} "
        f"(bound {BF16_TOL:g})")
    if max(err_pred, err_probs, err_stream) > BF16_TOL:
        raise AssertionError("served outputs disagree with impl='xla'")
    if launches != expected:
        raise AssertionError(f"flash_fwd launched {launches} times, expected "
                             f"{expected}")

    # where the time goes, after the counted run: one bucket-8 ensemble
    # forward and one batch-1 predict under torch.profiler
    fwd8 = ensemble_serve_fn(members, exp.thresholds, impl=exp.model.attn_impl,
                             dtype=dtype)
    batch8 = {k: v[:SERVE_BUCKET] for k, v in batch.items()}
    try:
        report["profile"] = {
            f"bucket{SERVE_BUCKET}_forward": profile_breakdown(
                torch, lambda: fwd8(batch8)),
            "batch1_predict": profile_breakdown(
                torch, lambda: sp.predict(samples[0]))}
    except Exception:   # a measurement only: the checks above stand
        traceback.print_exc()
        report["profile"] = "not measured: the profiler failed"
        log("[profile] not measured: the profiler failed")
    return launches


def _kernel_category(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_fwd"
    if "memcpy" in low or "memset" in low:
        return "copies"
    # cuBLAS's GEMMs on Hopper are named nvjet_* (seen in this script's
    # profile), older ones *gemm* / cutlass / xmma
    if any(t in low for t in ("nvjet", "gemm", "cutlass", "xmma")):
        return "gemm"
    return "other"


def profile_breakdown(torch, fn, reps: int = 3):
    """Device time by kernel category, host wall time and the device's idle
    share over `reps` calls of fn, from torch.profiler's CUDA kernel events.
    Reported as not measured where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_cat, by_kernel, n_kernels = {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        cat = _kernel_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3 / reps
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us / 1e3 / reps
        n_kernels += 1
    busy = sum(by_cat.values())
    out = {"wall_ms": wall_ms, "reps": reps}
    if busy <= 0.0:
        out["device"] = "not measured: the profiler recorded no device time"
        log(f"[profile] wall {wall_ms:.2f} ms; device time not measured")
        return out
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out.update(device_busy_ms=busy, device_idle_share=max(0.0, 1 - busy / wall_ms),
               launches_per_call=n_kernels / reps, by_category_ms=by_cat,
               top_kernels_ms=dict(top))
    log(f"[profile] wall {wall_ms:.2f} ms/call, device busy {busy:.2f} ms "
        f"(idle share {out['device_idle_share']:.3f}), "
        f"{n_kernels / reps:.0f} device ops/call; by category "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_cat.items())))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from multimodal_emotion_processing_tpu_torch.utils import native

    report = {}
    failed = []
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    sources = sorted(p.stem for p in native.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    built = native.build(sources)
    report["build_s"] = time.perf_counter() - t0
    report["build"] = built
    log(f"[device] built {sources} in {report['build_s']:.1f} s")
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device] {name}: {line.strip()}")

    kernel_summary, launches = None, None
    for phase, fn in (("kernels", phase_kernels), ("main", phase_main_path)):
        try:
            result = fn(torch, report)
        except Exception:
            traceback.print_exc()
            failed.append(phase)
            continue
        if phase == "kernels":
            kernel_summary = result
        else:
            launches = result

    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    report["failed_phases"] = failed
    OUT_JSON.write_text(json.dumps(report, indent=1, default=str))
    if failed:
        print(f"FAIL: phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "multimodal_emotion_processing_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "multimodal_emotion_processing_tpu/ops/flash_attention.py:208",
        "also_replaces": ["multimodal_emotion_processing_tpu/ops/flash_attention.py:431"],
        "launches": launches,
        "max_abs_err": kernel_summary["max_abs_err"],
        "ms": kernel_summary["ms"], "plain_ms": kernel_summary["plain_ms"],
        "bound_ms": kernel_summary["bound_ms"],
        "bound_by": kernel_summary["bound_by"],
        "library_ms": kernel_summary["library_ms"],
        "timed_at": f"sum over the nine s1024 stream shapes, B={SERVE_BUCKET}, bf16",
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
