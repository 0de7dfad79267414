"""What test_torch_lockstep_mesh's gloo ranks run (spawned on the CPU, one
intra-op thread each; torch and the port only, never JAX): the lockstep
k-fold drivers (train/vmap_kfold.py) on a ('data', 'model') mesh against
the single-process port driver of the same kind, the grid's merged and
stacked paths under tensor parallelism against the unrolled tp path, the
meshed drivers from JAX's weights on JAX's shuffles (the parent holds
them against JAX's meshed drivers), and `cli train --dp [--tp]` with
--device-resident and --one-dispatch.

Each rank runs `_task` and writes what it computed (`out_<rank>.pt`);
rank 0 also runs every single-process reference.  The ranks are started
without waiting (`start`), so that the parent computes JAX's references
meanwhile, and joined by `finish`."""

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_dist_common as tdc
from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
from multimodal_emotion_processing_tpu_torch.models import build_model, grid
from multimodal_emotion_processing_tpu_torch.parallel import mesh as pm
from multimodal_emotion_processing_tpu_torch.train import engine
from multimodal_emotion_processing_tpu_torch.train import vmap_kfold as vk
from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore

TINY = dict(l_len=4, v_len=6, a_len=8, dim=12, n_heads=2, l_dim=5, v_dim=4,
            a_dim=3)
RF = dict(l_len=4, v_len=4, a_len=4, dim=12, n_heads=2, l_dim=5, v_dim=4,
          a_dim=3, p_len=2)
REN = dict(TINY, dim=16, dropout=0.1)


class Cut(Exception):
    """A run stopped from outside at the start of an epoch."""


def f64(samples):
    return [{k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
             for k, v in s.items()} for s in samples]


def perturb(model, seed: int) -> None:
    """Gates a, b, c from U(0.25, 1) (at their init of 0 the attention
    cannot reach the logits) and LayerNorm biases moved by 0.1·N(0, 1)
    (no exact max-pool ties across blocks), from a generator of `seed`."""
    g = torch.Generator().manual_seed(1000 + seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("a", "b", "c"):
                p.copy_(0.25 + 0.75 * torch.rand(p.shape, generator=g,
                                                  dtype=p.dtype))
            elif leaf == "bias" and "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=p.dtype))


@contextlib.contextmanager
def patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _inits(weights=None):
    """engine.init_state with every member perturbed (`perturb`), or
    loaded from `weights` {seed: state dict} (JAX's init)."""
    real = engine.init_state

    def init(cfg, tcfg, seed, **kw):
        st = real(cfg, tcfg, seed, **kw)
        if weights is None:
            perturb(st.model, seed)
        else:
            st.model.load_state_dict(weights[seed])
        return st

    return init


def _shuffles(perms):
    """vmap_kfold.epoch_permutation drawing the given per-epoch stacks."""
    def draw(key_seed, epoch, n, device, members=None):
        return perms[epoch].to(device)
    return draw


def _cut_at(epoch):
    real = vk.epoch_permutation

    def draw(key_seed, e, n, device, members=None):
        if e == epoch:
            raise Cut
        return real(key_seed, e, n, device, members=members)
    return draw


def run(spec, mesh, tp=False, store=None, **extra):
    """One driver run of `spec` (config, model and train overrides, the
    driver kind "host" | "resident" | "one", its keywords): histories,
    best losses and parameters, the final parameters (whole), and the
    learning rates the host set in order and the members' last."""
    exp = tdc.exp_of(spec["name"], spec["model"], spec["train"])
    samples = synthetic_dataset(spec["name"], exp.model, spec["n"],
                                seed=spec["seed"])
    if spec.get("f64"):
        samples = f64(samples)
    kw = dict(spec.get("kw", {}), **extra)
    lrs = []

    def recording(state, lr):
        lrs.append(float(lr))
        return real(state, lr)

    bs, dup = exp.train.batch_size, exp.train.rdrop_kl

    def make(train, valid):
        return (Batcher(train, bs, seed=1, duplicate=dup),
                Batcher(valid, bs, duplicate=dup, shuffle=False))

    dtype = torch.float64 if spec.get("f64") else torch.float32
    with patched(vk, "set_learning_rate", recording) as real, \
            default_dtype(dtype):
        common = dict(device="cpu", mesh=mesh, tp=tp, store=store,
                      impl=spec.get("impl", "xla"), **kw)
        if spec["kind"] == "one":
            states, hists, best, losses = vk.run_kfold_fully_compiled(
                samples, exp, exp.train, duplicate=dup, **common)
        else:
            states, hists, best, losses = vk.run_kfold_vmapped(
                samples, make if spec["kind"] == "host" else None, exp,
                exp.train, device_resident=spec["kind"] == "resident",
                duplicate=dup, **common)
        final = [vk._params(st) for st in states]
    return {"hist": [[(e.train_loss, e.valid_loss, e.steps, e.samples)
                      for e in h] for h in hists],
            "best": best, "losses": losses, "final": final, "lrs": lrs,
            "last_lrs": [st.optimizer.lr for st in states]}


def _grid_grads(spec, mesh):
    """Step-1 loss, whole gradients and clip norm of `spec`'s model on the
    mesh, the grid's fast path switched on (`spec["path"]`) and off."""
    exp = tdc.exp_of(spec["name"], spec["model"])
    with default_dtype(torch.float64):
        model = build_model(exp, device="cpu", seed=0)
    perturb(model, 0)
    samples = f64(synthetic_dataset(spec["name"], exp.model, 8, seed=3))
    case = {"name": spec["name"], "model": spec["model"],
            "batch": next(iter(Batcher(samples, 8, shuffle=False)())),
            "dtype": torch.float64,
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()}}
    calls = []
    method = {"merged": "_merged_minus", "stacked": "_stacked_realformer"}[
        spec["path"]]
    real = getattr(grid.Grid, method)

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    out = {}
    with patched(grid.Grid, method, counted):
        out["unrolled"] = tdc.port_grads(case, mesh)
        assert not calls
        flag = {"merged": "MERGED_FAST_PATH",
                "stacked": "REALFORMER_STACKED"}[spec["path"]]
        with patched(grid, flag, True):
            out["fast"] = tdc.port_grads(case, mesh)
    out["fast_calls"] = len(calls)
    return out


def _guards():
    """The errors of a mesh whose ranks would split R-Drop's pairs (batch
    3 on dp=2: 3 rows a rank): run_experiment and the lockstep refuse it."""
    from multimodal_emotion_processing_tpu_torch.pipelines import (
        run_experiment)

    out = {}
    exp = tdc.exp_of("ren_mme", REN, {"batch_size": 3, "n_folds": 2})
    samples = synthetic_dataset("ren_mme", exp.model, 12, seed=0)
    calls = {
        "run_experiment": lambda: run_experiment(
            "ren_mme", dp=2, device="cpu", quiet=True, epochs=1, n_train=12,
            n_test=4, overrides={"model": REN, "train": {"batch_size": 3,
                                                         "n_folds": 2}}),
        "lockstep": lambda: vk.run_kfold_vmapped(
            samples, None, exp, exp.train, device="cpu", epochs=1,
            device_resident=True, duplicate=True,
            mesh=pm.make_mesh(n_data=2, device="cpu"))}
    for key, call in calls.items():
        try:
            call()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def _cli(argv, world, rank):
    """`cli train` on this world: rank 0's stderr and stdout."""
    from multimodal_emotion_processing_tpu_torch.cli import main

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        main(argv)
    return {"err": err.getvalue(), "out": out.getvalue()}


def _task(rank, world, inp):
    n_model = inp["n_model"]
    mesh = pm.make_mesh(n_data=2, n_model=n_model, device="cpu")
    tp = n_model > 1
    out = {"runs": {}, "single": {}}
    with patched(engine, "init_state", _inits()):
        for key, spec in inp["runs"].items():
            store = None
            if spec.get("store"):
                store = CheckpointStore(os.path.join(inp["root"], key))
            out["runs"][key] = run(spec, mesh, tp, store=store)
            if rank == 0:
                out["single"][key] = run(spec, None)
        if "resume" in inp:
            spec = inp["resume"]
            path = os.path.join(inp["root"], "resume")
            try:
                with patched(vk, "epoch_permutation", _cut_at(spec["cut"])):
                    run(spec, mesh, tp, store=CheckpointStore(path))
            except Cut:
                pass
            dist.barrier()   # rank 0's resume points have landed
            out["cut_epochs"] = CheckpointStore(path).last_epochs("model_1")
            out["resumed"] = run(spec, mesh, tp, store=CheckpointStore(path),
                                 resume=True)
            out["store_files"] = sorted(os.listdir(path))
    for key, grads in inp.get("grids", {}).items():
        out.setdefault("grids", {})[key] = _grid_grads(grads, mesh)
    if "jax_start" in inp:
        js = inp["jax_start"]
        with patched(engine, "init_state", _inits(js["weights"])), \
                patched(vk, "epoch_permutation", _shuffles(js["perms"])):
            out["jax_start"] = run(js["spec"], mesh, tp)
    if inp.get("guards"):
        out["guards"] = _guards()
    out["cli"] = {}
    for key, argv in inp.get("cli", {}).items():
        out["cli"][key] = _cli(argv, world, rank)
    return out


def _entry(rank, world, port, path):
    torch.set_num_threads(1)
    pm.initialize_multihost(device="cpu",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
        out = _task(rank, world, dict(inp, root=path))
        torch.save(out, os.path.join(path, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(world: int, path, inputs):
    """Start `_task` on `world` gloo ranks; `finish` joins them."""
    torch.save(inputs, os.path.join(path, "inputs.pt"))
    return mp.start_processes(_entry, args=(world, tdc.free_port(), str(path)),
                              nprocs=world, join=False, start_method="spawn")


def finish(ctx, world: int, path):
    """Wait for the ranks; returns each rank's output."""
    while not ctx.join():
        pass
    return [torch.load(os.path.join(path, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def spec(name, kind, *, model, n, seed=0, impl="xla", f64=True, kw=None,
         **train):
    """A driver run: config `name` with `model` and `train` overrides, `n`
    synthetic samples of `seed`, the driver's keywords `kw`."""
    return {"name": name, "kind": kind, "model": model, "n": n, "seed": seed,
            "impl": impl, "f64": f64, "train": train, "kw": kw or {}}
