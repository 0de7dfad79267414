"""Which guards the CUDA-graph capture of `Ensemble.logits` needs while
`data.loader.prefetch_to_device` runs, on a CUDA device.

Each round builds a fresh `Ensemble` of `mosei_trans` members (reference
width, f32, impl=pallas_fused, so the graph holds `fused_block` launches)
and runs `predict_all` over a `Batcher` at the int8 wire: the prefetch
thread casts, pins and copies batches while the first batch's program is
captured, as `pipelines.run_predict` does.  A case switches, in this
process only:

  mode      the capture's `capture_error_mode`: "thread_local" (as
            serve/graphs.py captures) or "global" (PyTorch's default);
  gc_guard  whether the garbage collector is off during a capture (as
            serve/graphs.py does) or left on;
  cycle     whether each round's `Ensemble` is put in a reference cycle
            with its graphed function, so that it outlives the round and
            only a collection frees it and its CUDA graphs;
  collect   whether `gc.collect()` runs inside the capture (a collection
            at that point, made certain instead of left to chance);
  threshold the collector's gen-0 threshold (Python's default 700; lower
            makes collections inside a capture likelier).

A round fails when `predict_all` raises.  The CUDA warnings that the
process prints while a case runs are counted, among them CUDAGraph's
"operation not permitted when stream is capturing (function reset)",
printed when a graph is destroyed during a capture.  Each case runs in a
process of its own, since a failed capture may leave the allocator's
state behind for the next.

    python3 tools/graph_capture_probe.py [--rounds 60] [--n-test 512]

prints one JSON line per case and writes all of them, with the card's
name and power limit, to chiprun_out/capture_probe.json
(`--case NAME` runs one case in this process).  It exits 1 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = (
    # name, mode, gc_guard, cycle, collect, gen-0 threshold
    ("as_shipped", "thread_local", True, False, False, 700),
    ("no_cycle_gc_on", "thread_local", False, False, False, 700),
    ("cycle_gc_guard", "thread_local", True, True, False, 700),
    ("cycle_gc_on", "thread_local", False, True, False, 700),
    ("collect_in_capture_no_cycle", "thread_local", True, False, True, 700),
    ("collect_in_capture_cycle", "thread_local", True, True, True, 700),
    ("cycle_gc_on_threshold_50", "thread_local", False, True, False, 50),
    ("cycle_gc_guard_threshold_50", "thread_local", True, True, False, 50),
    ("global_no_cycle_gc_guard", "global", True, False, False, 700),
    # the design before the guards: PyTorch's default mode, cycles, the
    # collector on during a capture
    ("global_cycle_gc_on", "global", False, True, False, 700),
)


class _NoGuard:
    """Stands in for the `gc` module in serve/graphs.py: the collector
    stays as it is during a capture."""

    @staticmethod
    def isenabled():
        return False

    @staticmethod
    def disable():
        pass

    @staticmethod
    def enable():
        pass


def run_case(torch, members, samples, args, name, mode, gc_guard, cycle,
             collect, threshold):
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble
    from multimodal_emotion_processing_tpu_torch.serve import graphs

    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, pool=None, capture_error_mode="global"):
        return begin(self, pool=pool, capture_error_mode=mode)

    torch.cuda.CUDAGraph.capture_begin = capture_begin
    graphs.gc = gc if gc_guard else _NoGuard()
    old_threshold = gc.get_threshold()
    gc.set_threshold(threshold, *old_threshold[1:])
    # the C++ warnings go to file descriptor 2: count them per case
    sys.stderr.flush()
    saved_fd = os.dup(2)
    log = tempfile.TemporaryFile()
    os.dup2(log.fileno(), 2)
    failures, messages, t0 = 0, {}, time.perf_counter()
    try:
        for _ in range(args.rounds):
            ens = Ensemble(members, impl="pallas_fused")
            if cycle:
                ens.program.owner = ens
            if collect:
                inner = ens.program.fn

                def fn(batch, inner=inner):
                    if torch.cuda.is_current_stream_capturing():
                        gc.collect()
                    return inner(batch)

                ens.program.fn = fn
            try:
                out = ens.predict_all(Batcher(samples, args.batch,
                                              shuffle=False),
                                      transfer_dtype="int8")
                if out.shape[0] != len(samples) or ens.program.captures != 1:
                    raise AssertionError(f"{out.shape}, "
                                         f"{ens.program.captures} captures")
            except Exception as e:   # counted: the probe measures failures
                failures += 1
                cause = e.__cause__ or e
                msg = f"{type(cause).__name__}: {str(cause)[:160]}"
                messages[msg] = messages.get(msg, 0) + 1
            del ens
            torch.cuda.synchronize()
    finally:
        sys.stderr.flush()
        os.dup2(saved_fd, 2)
        os.close(saved_fd)
        torch.cuda.CUDAGraph.capture_begin = begin
        graphs.gc = gc
        gc.set_threshold(*old_threshold)
        gc.collect()
        torch.cuda.synchronize()
    log.seek(0)
    text = log.read().decode(errors="replace")
    return {"case": name, "capture_error_mode": mode, "gc_guard": gc_guard,
            "cycle": cycle, "collect_in_capture": collect,
            "gen0_threshold": threshold, "rounds": args.rounds,
            "failures": failures, "messages": messages,
            "function_reset_warnings": text.count("(function reset)"),
            "not_permitted_lines": text.count("not permitted when stream "
                                              "is capturing"),
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--n-test", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--case", choices=[c[0] for c in CASES])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "capture_probe.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_emotion_processing_tpu_torch.utils import native

    if args.case is None:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        native.build(["fused_block"])
        results = []
        for case in CASES:
            proc = subprocess.run(
                [sys.executable, __file__, "--case", case[0], "--rounds",
                 str(args.rounds), "--n-test", str(args.n_test), "--batch",
                 str(args.batch), "--members", str(args.members)],
                capture_output=True, text=True, timeout=900)
            lines = proc.stdout.strip().splitlines()
            r = (json.loads(lines[-1]) if proc.returncode == 0 and lines
                 else {"case": case[0], "returncode": proc.returncode,
                       "stderr_tail": proc.stderr[-2000:]})
            results.append(r)
            print(json.dumps(r), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": smi,
                                              "cases": results}, indent=1))
        print(smi)
        return 0 if all("failures" in r for r in results) else 1

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model

    exp = configs.get("mosei_trans")
    members = [build_model(exp, device="cuda", seed=i)
               for i in range(args.members)]
    samples = synthetic_dataset(exp.name, exp.model, args.n_test, seed=3)
    case = next(c for c in CASES if c[0] == args.case)
    print(json.dumps(run_case(torch, members, samples, args, *case)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
