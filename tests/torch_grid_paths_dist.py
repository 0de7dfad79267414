"""What test_torch_grid_paths's gloo ranks run (spawned on the CPU, one
intra-op thread each; torch and the port only, never JAX): the step-1
gradients of a combination the port newly builds under tensor parallelism
(tp=2) against one process, and `run_predict(dp=2, stacked=True)` from a
checkpoint store against one process's unstacked `run_predict`."""

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_dist_common as tdc
from multimodal_emotion_processing_tpu_torch.parallel import mesh as pm


def _entry(rank, world, port, path):
    torch.set_num_threads(1)
    pm.initialize_multihost(device="cpu",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
        out = _task(rank, world, inp)
        torch.save(out, os.path.join(path, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _task(rank, world, inp):
    from multimodal_emotion_processing_tpu_torch.pipelines import run_predict

    case = inp["tp_case"]
    out = {"tp": {"mesh": tdc.port_grads(case, pm.make_mesh(
        n_data=1, n_model=world, device="cpu"))}}
    kw = dict(inp["predict"])
    name = kw.pop("name")
    out["predict"] = run_predict(name, dp=world, stacked=True, quiet=True,
                                 device="cpu", **kw)["logits"]
    if rank == 0:
        out["tp"]["single"] = tdc.port_grads(case)
        out["predict_single"] = run_predict(name, quiet=True, device="cpu",
                                            **kw)["logits"]
    return out


def spawn(world: int, tmp_path, inputs):
    """Run `_task` on `world` gloo ranks; returns each rank's output."""
    torch.save(inputs, os.path.join(tmp_path, "inputs.pt"))
    mp.spawn(_entry, args=(world, tdc.free_port(), str(tmp_path)),
             nprocs=world, join=True)
    return [torch.load(os.path.join(tmp_path, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]
