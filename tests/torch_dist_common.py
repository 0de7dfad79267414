"""What the port's multi-rank tests share (test_torch_parallel,
test_torch_context_parallel, test_torch_multihost): ranks spawned on the
CPU over gloo, one intra-op thread each, every check of one configuration
bundled into one spawn.  The parent writes the inputs (`inputs.pt`: the
weights the JAX package initialised, seeded numpy batches), each rank
runs a task of `TASKS` and writes what it computed (`out_<rank>.pt`).

This module imports torch and the port only: the spawned ranks import it
to find their task, and never import JAX."""

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_emotion_processing_tpu_torch import configs
from multimodal_emotion_processing_tpu_torch.parallel import mesh as pm
from multimodal_emotion_processing_tpu_torch.train import engine


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(task: str, world: int, tmp_path, inputs=None):
    """Run TASKS[task] on `world` gloo ranks; returns each rank's output."""
    torch.save(inputs or {}, os.path.join(tmp_path, "inputs.pt"))
    mp.spawn(_entry, args=(world, free_port(), task, str(tmp_path)),
             nprocs=world, join=True)
    return [torch.load(os.path.join(tmp_path, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(rank, world, port, task, path):
    torch.set_num_threads(1)
    pm.initialize_multihost(device="cpu",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
        out = TASKS[task](rank, world, inp)
        torch.save(out, os.path.join(path, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def exp_of(name, model=None, train=None):
    exp = configs.get(name)
    return dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, **(model or {})),
        train=dataclasses.replace(exp.train, **(train or {})))


def _as(batch, dtype):
    return {k: (torch.as_tensor(np.asarray(v)).to(dtype)
                if np.asarray(v).dtype.kind == "f" else torch.as_tensor(v))
            for k, v in batch.items()}


def _state(case, mesh):
    exp = exp_of(case["name"], case.get("model"), case.get("train"))
    dtype = case["dtype"]
    torch.set_default_dtype(dtype)   # the optimizer's moments and scalars
    try:
        state = engine.init_state(exp, exp.train, 0, device="cpu")
    finally:
        torch.set_default_dtype(torch.float32)
    state.model.load_state_dict(case["state_dict"])
    state.model.to(dtype)
    if mesh is not None:
        pm.place_state(state, mesh, tp=mesh.shape["model"] > 1)
        batch = _as(pm.local_rows(case["batch"], mesh), dtype)
    else:
        batch = _as(case["batch"], dtype)
    return exp, state, batch


def _whole(state, tensors):
    names = [n for n, _ in state.model.named_parameters()]
    if state.parallel is None:
        return dict(zip(names, (t.detach() for t in tensors)))
    return {n: pm.gather_tensor(t.detach(), state.spec[n],
                                state.parallel.model_group)
            for n, t in zip(names, tensors)}


def port_steps(case, mesh=None):
    """(step losses, whole parameters after them) of `case["steps"]`
    optimizer steps (engine.member_step: the clip, Adam(W)) on the same
    batch."""
    exp, state, batch = _state(case, mesh)
    losses = [float(engine.member_step(state, exp.train, batch,
                                       impl=case.get("impl", "xla")))
              for _ in range(case["steps"])]
    return losses, _whole(state, state.optimizer.params)


def port_grads(case, mesh=None):
    """(loss, {name: gradient}, the clip's global norm) of one batch_loss
    at the case's weights, dtype and impl; on a mesh summed over 'data'
    and gathered whole."""
    exp, state, batch = _state(case, mesh)
    if case.get("train_mode"):
        state.model.train()
    else:
        state.model.eval()
    gen = (engine.dropout_generator(7, "cpu") if case.get("train_mode")
           else None)
    loss = engine.batch_loss(state.model, exp.train, batch,
                             impl=case.get("impl", "xla"), generator=gen,
                             parallel=state.parallel)
    params = [p for _, p in state.model.named_parameters()]
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(loss, params, allow_unused=True), params)]
    if state.parallel is not None:
        loss, grads = state.parallel.reduce(loss, grads)
    norm = float(state.optimizer._global_norm(grads))
    return float(loss.detach()), _whole(state, grads), norm


def _grads_task(rank, world, inp):
    """Each case's gradients on its mesh, and on rank 0 the single-process
    port's from the same inputs."""
    out = {}
    for key, case in inp["cases"].items():
        n_data, n_model = case["mesh"]
        mesh = pm.make_mesh(n_data, n_model, device="cpu")
        run = port_steps if case.get("steps") else port_grads
        out[key] = {"mesh": run(case, mesh)}
        if rank == 0:
            out[key]["single"] = run(case)
    if "ensemble" in inp:
        out["ensemble"] = _ensemble_checks(inp["ensemble"])
    return out


def _ensemble_checks(inp):
    """Ensemble(mesh=) at dp over the world against one rank's Ensemble;
    its errors on a batch that does not divide the data axis and on
    staged prediction."""
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import Ensemble
    from multimodal_emotion_processing_tpu_torch.models import build_model

    exp = exp_of(inp["name"], inp["model"])
    members = []
    for sd in inp["members"]:
        m = build_model(exp, device="cpu")
        m.load_state_dict(sd)
        members.append(m)
    mesh = pm.make_mesh(device="cpu")
    loader = Batcher(inp["samples"], inp["batch_size"], shuffle=False)
    out = {"mesh": Ensemble(members, mesh=mesh).predict_all(loader),
           "single": Ensemble(members).predict_all(loader)}
    odd = {k: v[:inp["batch_size"] - 1]
           for k, v in next(iter(loader())).items()}
    for key, call in (("odd_batch", lambda: Ensemble(members, mesh=mesh)
                       .logits(odd)),
                      ("staged", lambda: Ensemble(members, mesh=mesh)
                       .predict_all_staged(inp["samples"], 4))):
        try:
            call()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def _cp_task(rank, world, inp):
    """Each CP case (ops/context_parallel.py) over a ("context",) mesh of
    every rank: outputs, and the gradients of a loss where asked."""
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.ops import context_parallel as cp
    from multimodal_emotion_processing_tpu_torch.ops.attention import (
        scored_attention)

    mesh = pm.world_mesh((world,), ("context",), "cpu")
    fns = {"psum": cp.scored_attention_cp, "ring": cp.ring_scored_attention}
    out = {}
    for key, case in inp["attention"].items():
        fn = fns[case["mode"]]
        kw = dict(n_heads=case["h"], mesh=mesh, **case.get("kw", {}))
        args = [torch.as_tensor(a) for a in case["args"]]
        q, k, v, m, prev, c = args
        if case.get("no_mask_prev"):
            m = prev = None
        try:
            if case.get("grad"):
                leaves = [t.clone().requires_grad_() for t in (q, k, v, c)]
                q_, k_, v_, c_ = leaves

                def two_blocks(f, **kw2):
                    ctx1, s1 = f(q_, k_, v_, m, None, c_, n_heads=case["h"],
                                 **kw2)
                    ctx2, _ = f(ctx1, k_, v_, m, s1, c_, n_heads=case["h"],
                                **kw2)
                    return (ctx2 ** 2).sum() + 0.1 * (ctx1 ** 2).sum()

                loss = two_blocks(fn, mesh=mesh)
                grads = torch.autograd.grad(loss, leaves)
                out[key] = {"loss": float(loss.detach()),
                            "grads": [g.detach() for g in grads]}
            elif case.get("chain"):
                ctx1, s1 = fn(q, k, v, m, None, c, **kw)
                ctx, s = fn(ctx1, k, v, m, s1, c, **kw)
                out[key] = {"ctx": ctx, "scores": s}
            elif case.get("grad_noemit"):
                dq = {}
                for emit in (False, True):
                    q_ = q.clone().requires_grad_()
                    ctx, s = fn(q_, k, v, m, prev, c, emit_scores=emit, **kw)
                    dq[emit] = torch.autograd.grad((ctx ** 2).sum(), q_)[0]
                    out.setdefault(key, {})[f"ctx_{emit}"] = ctx.detach()
                    out[key][f"scores_{emit}"] = (None if s is None
                                                  else s.detach())
                out[key]["dq"] = dq
            else:
                ctx, s = fn(q, k, v, m, prev, c, **kw)
                out[key] = {"ctx": ctx, "scores": s}
        except ValueError as e:
            out[key] = {"error": str(e)}
    for key, case in inp.get("model", {}).items():
        exp = exp_of(case["name"], case["model"])
        model = build_model(exp, device="cpu")
        model.load_state_dict(case["state_dict"])
        model.eval()
        batch = _as(case["batch"], torch.float32)
        with torch.no_grad(), cp.cp_context(mesh, mode=case["mode"]):
            out[key] = {"logits": model(batch, impl="cp")}
    return out


def _fit_task(rank, world, inp):
    """JAX's two-process fit: every rank assembles the same seeded global
    batches, the Trainer's mesh feeds each its rows; the epoch losses and
    this rank's batch slices."""
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher

    exp = exp_of(inp["name"], inp["model"], inp["train"])
    samples = inp["samples"]

    def loader():
        return iter(Batcher(samples, exp.train.batch_size, shuffle=True,
                            seed=1)())

    mesh = pm.make_mesh(n_data=world, device="cpu")
    saves = []
    tr = engine.Trainer(exp, exp.train, device="cpu", mesh=mesh,
                        checkpoint_cb=lambda state, epoch, vl: saves.append(
                            epoch))
    _, hist = tr.fit(loader, loader, epochs=inp["epochs"])
    out = {"history": [[e.train_loss, e.valid_loss] for e in hist],
           "samples": [e.samples for e in hist], "saves": saves,
           "slice": pm.process_batch_slice(8, mesh),
           "world_slice": pm.process_batch_slice(8)}
    out["experiments"] = _experiments(inp["experiments"])
    return out


def _experiments(runs):
    """run_experiment on the world's mesh, each with its checkpoint store:
    the fold histories and the ensemble's test logits."""
    from multimodal_emotion_processing_tpu_torch.pipelines import (
        run_experiment)

    out = {}
    for key, kw in runs.items():
        res = run_experiment(kw["name"], device="cpu", quiet=True,
                             **{k: v for k, v in kw.items() if k != "name"})
        out[key] = {"histories": [[[e.train_loss, e.valid_loss] for e in h]
                                  for h in res.fold_histories],
                    "logits": res.logits,
                    "manifest": sorted(res.store.manifest)}
    return out


TASKS = {"grads": _grads_task, "cp": _cp_task, "fit": _fit_task}
