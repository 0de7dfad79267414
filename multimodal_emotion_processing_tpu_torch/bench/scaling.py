"""MFU scaling sweep: the flagship `mosei_trans` architecture at its
reference width and at the scale presets, train and inference throughput
as achieved TFLOP/s and as a share of the card's peak (bench/scaling.py of
the JAX package, its points, keys and command line).

    python -m multimodal_emotion_processing_tpu_torch.bench.scaling \
        [--points=ref,s256,s512,s1024] [--impl=xla,flash] \
        [--dtypes=float32,bfloat16] [--remat] [--batch=B] [--device cpu] \
        [--set K=V]

One JSON line per (point, impl, dtype) on stdout; a point that fails
writes its error to stderr and the sweep goes on.  Each row times the
programs the port's users run: train samples/s of the Trainer's captured
step (bench/autotune._measure_train, the program `train` runs) and
inference samples/s of the Ensemble's captured forward
(utils/timing.best_window_ms over its replays).  `compile_s` is the train
program's first call, its eager call and the capture (the port compiles
no programs; null on the CPU, where nothing is captured), `peak_hbm_gb`
the card's peak allocated memory over the point
(`torch.cuda.max_memory_allocated`, reset before it; null on the CPU), and
`peak_tflops` the ceiling the row's MFU divides by (bench/flops.peak_for:
989 in bf16, 67 in f32, 495/3 in f32 where the attention kernels run
split-TF32 products).  The graphs of a point are released before the
next, so a point does not hold the previous one's memory pools.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import traceback

from .. import configs as _configs

# (name -> dim, n_heads, l_len, v_len, a_len, batch): the flagship
# architecture scaled; the raw feature widths stay the reference's
POINTS = {
    "ref": dict(dim=96, n_heads=6, l_len=20, v_len=100, a_len=200, batch=64),
    **{p: dict(dim=s["dim"], n_heads=s["n_heads"], l_len=s["l_len"],
               v_len=s["v_len"], a_len=s["a_len"], batch=s["batch_size"])
       for p, s in _configs.SCALE_POINTS.items()},
}


def _point_config(spec):
    exp = _configs.get("mosei_trans")
    m = dataclasses.replace(
        exp.model, dim=spec["dim"], n_heads=spec["n_heads"],
        l_len=spec["l_len"], v_len=spec["v_len"], a_len=spec["a_len"])
    t = dataclasses.replace(exp.train, batch_size=spec["batch"])
    return dataclasses.replace(exp, model=m, train=t)


def measure_point(name, spec, *, dtype="float32", impl="xla", steps=10,
                  reps=4, remat=False, batch=None, device=None, sets=()):
    import torch

    from . import device_line, flops as fl, with_sets
    from .autotune import _measure_infer, _measure_train, _release
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    exp = _point_config(spec)
    exp = dataclasses.replace(
        exp,
        model=dataclasses.replace(exp.model, remat=remat),
        train=dataclasses.replace(
            exp.train, compute_dtype=dtype,
            **({"batch_size": batch} if batch else {})))
    exp = with_sets(exp, sets)
    b = exp.train.batch_size
    if dev.type == "cuda":
        _release(torch, dev)
        torch.cuda.reset_peak_memory_stats(dev)
    info = {}
    best = _measure_train(exp, impl=impl, device=dev, n_batches=steps,
                          reps=reps, info=info)["train_sps"]
    inf_best = _measure_infer(exp, impl=impl, device=dev, steps=steps,
                              reps=reps)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    f_tr = fl.train_flops_per_sample(exp.model)
    f_inf = fl.forward_flops_per_sample(exp.model)
    peak_tflops = fl.peak_for(dtype, impl,
                              tf32=torch.backends.cuda.matmul.allow_tf32)
    capture_s = info.get("capture_s")
    return {
        "point": name, "impl": impl, "dtype": dtype, "batch": b,
        "remat": bool(remat),
        "peak_hbm_gb": round(peak / 2**30, 2) if peak else None,
        "dim": exp.model.dim,
        "lens": [exp.model.l_len, exp.model.v_len, exp.model.a_len],
        "train_sps": round(best, 1),
        "ms_per_step": round(1e3 * b / best, 2),
        "train_gflops_per_sample": round(f_tr / 1e9, 2),
        "achieved_tflops": round(best * f_tr / 1e12, 2),
        "mfu": round(fl.mfu(best, f_tr, peak_tflops), 4),
        "infer_sps": round(inf_best, 1),
        "infer_ms_per_step": round(1e3 * b / inf_best, 2),
        "infer_achieved_tflops": round(inf_best * f_inf / 1e12, 2),
        "infer_mfu": round(fl.mfu(inf_best, f_inf, peak_tflops), 4),
        "compile_s": None if capture_s is None else round(capture_s, 3),
        "peak_tflops": peak_tflops,
        "device": device_line(dev),
    }


def main(argv=None):
    from . import entry_parser

    ap = entry_parser("train and inference MFU of the flagship architecture "
                      "at its reference width and the scale presets")
    ap.add_argument("--points", default=",".join(POINTS))
    ap.add_argument("--impl", default="xla", help="comma-separated impls")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    rows = []
    for name in args.points.split(","):
        for impl in args.impl.split(","):
            for dtype in args.dtypes.split(","):
                t0 = time.perf_counter()
                try:
                    row = measure_point(name, POINTS[name], dtype=dtype,
                                        impl=impl, steps=args.steps,
                                        reps=args.reps, remat=args.remat,
                                        batch=args.batch, device=args.device,
                                        sets=args.set)
                except Exception as e:  # an out-of-memory point: go on
                    traceback.print_exc()
                    print(f"point {name}/{impl}/{dtype} failed: {e!r}",
                          file=sys.stderr, flush=True)
                    continue
                print(f"point {name}/{impl}/{dtype}: "
                      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                      flush=True)
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
