"""Training engine (train/engine.py of the JAX package): the loss contract,
the optimizer, the train and eval steps, the epoch driver, and the
compute-dtype casts of the inference path.

A step is a plain function: forward, ZLPR loss (+ the R-Drop KL under
`rdrop_kl`), backward, global-norm clip, Adam(W) update, with no host
round trip; the per-step losses stay on the device until the epoch ends.
The learning rate is a 0-d tensor of the optimizer that the host-side
plateau controller (schedule.py) sets in place between epochs (or, in
the one-dispatch drivers, the controller on the device). Dropout draws
its masks from the `TrainState`'s own `torch.Generator` (JAX's `k_rng`),
seeded from the state's seed; the eval step draws none.

A batch may arrive in a wire format (`Trainer(transfer_dtype=)`,
data/loader.cast_for_transfer); every step restores f32 (`upcast_wire`),
or under bf16 compute goes straight to bf16 (`wire_to_bf16`), before any
math.

A step is `member_step`: the whole step with no host-side bookkeeping, so
that `Trainer` and the drivers capture it into a CUDA graph
(serve/graphs.GraphedFunction): the optimizer keeps its step count,
learning rate and β factors as 0-d tensors on the device, and an eager
step does the same arithmetic as a replay.  `train_step(accum_steps=)`
and `Trainer(accum_steps=)` accumulate the gradient over micro-batches
(`accum_value_and_grad`, R-Drop included); `Trainer` replays captured
steps over static device buffers (`StepBuffer`), `scan_steps` of them
back to back.  The whole-run drivers
(train/device_epochs.py, vmap_kfold.py, sweep.py) build on the same
pieces.

On a mesh (parallel/mesh.py, `Trainer(mesh=, tp=)`) every rank runs the
same step on its own rows: the loss's denominators are global sums over
'data', the loss and gradients are summed over 'data' in one flat buffer
(`DataParallel.reduce`), the global-norm clip counts a replicated
gradient once and sums a shard's squares over 'model', and on NCCL the
step, collectives included, is still one captured graph.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.loss import symmetric_sigmoid_kl, zlpr_loss
from ..parallel import comm
from ..utils.logging import profile_trace
from . import schedule

# loss-side weight vectors stay f32 under bf16 compute: a bf16 sum of the
# sample weights rounds above 256 and would mis-scale the weighted mean
_KEEP_F32 = {"sample_weight", "clip_mask"}


def _check_dtype(dtype: str) -> None:
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute dtype {dtype!r}: expected float32 or bfloat16")


def cast_batch(batch, dtype: str):
    """Every floating batch entry outside the keep-set at `dtype`."""
    _check_dtype(dtype)
    if dtype == "float32":
        return batch
    return {k: (v if k in _KEEP_F32 or not v.is_floating_point()
                else v.to(torch.bfloat16))
            for k, v in batch.items()}


def infer_cast(model, batch, dtype: str):
    """bf16 compute for the inference path: returns (model, batch) with the
    parameters and every floating batch entry outside the keep-set at
    bfloat16.  The model is copied, so the caller's stays f32; either of
    the two may be None.  "float32" returns both unchanged.  The logit
    upcast is the caller's job (`infer_upcast`), so score and threshold math
    never runs in bf16."""
    _check_dtype(dtype)
    if dtype == "float32":
        return model, batch
    if model is not None:
        model = copy.deepcopy(model).to(torch.bfloat16)
    if batch is not None:
        batch = cast_batch(batch, dtype)
    return model, batch


def infer_upcast(logits: torch.Tensor) -> torch.Tensor:
    return logits.float() if logits.dtype == torch.bfloat16 else logits


def _dequantized(batch, k, v):
    """v as f32, times its '<k>__wire_scale' rows where the int8 wire
    gave it some, else None."""
    from ..data.loader import WIRE_SCALE_SUFFIX

    s = batch.get(k + WIRE_SCALE_SUFFIX)
    if s is None:
        return None
    return v.float() * s.reshape(tuple(s.shape) + (1,) * (v.ndim - s.ndim))


def upcast_wire(batch):
    """Undo the loader's wire format (data/loader.cast_for_transfer): the
    half-precision leaves were a transfer format, never a compute dtype, so
    they return to float32 before any math; int8 leaves dequantize against
    their '<key>__wire_scale' rows (the scale keys are consumed and
    dropped).  A float32 batch comes back as it went in."""
    from ..data.loader import WIRE_SCALE_SUFFIX

    out = {}
    for k, v in batch.items():
        if k.endswith(WIRE_SCALE_SUFFIX):
            continue
        x = _dequantized(batch, k, v)
        if x is not None:
            out[k] = x
        elif v.dtype in (torch.float16, torch.bfloat16):
            out[k] = v.float()
        else:
            out[k] = v
    return out


def wire_to_bf16(batch):
    """`upcast_wire` fused with the bf16 compute cast: every floating wire
    leaf lands in bf16 directly (the same value as through f32: one
    rounding either way; the int8 dequantizing product stays f32), and the
    keep-set vectors in f32, as `cast_batch` leaves them."""
    from ..data.loader import WIRE_SCALE_SUFFIX

    out = {}
    for k, v in batch.items():
        if k.endswith(WIRE_SCALE_SUFFIX):
            continue
        x = _dequantized(batch, k, v)
        if x is None and not v.is_floating_point():
            out[k] = v
            continue
        x = v if x is None else x
        out[k] = x.to(torch.float32 if k in _KEEP_F32 else torch.bfloat16)
    return out


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adamw | adam) of the JAX
    package's `make_optimizer`, over a model's parameters, with optax's
    arithmetic: g·min(1, clip/‖g‖) with the global L2 norm over every
    parameter (not `clip_grad_norm_`, which divides by ‖g‖ + 1e-6); then
    Adam with β 0.9 / 0.999, eps 1e-8 outside the square root and bias
    correction 1 − β^count computed in f32 on the device, as optax does;
    AdamW adds the decoupled decay wd·p to the update, for every
    parameter, before the −lr scale.  A parameter without a gradient
    (the terminal blocks' gate c) counts as a zero gradient, as JAX gives
    it.  The update runs as PyTorch multi-tensor (`_foreach`) ops over the
    per-parameter list, whatever `TrainConfig.fused_optimizer` says: JAX's
    flat vector saves kernel launches there, the foreach ops save them
    here without copying the parameters in and out of one vector, and the
    math is the same either way.

    Everything a step reads lives on the parameters' device: the step
    count `count_t` (int32) and the learning rate `lr_t` (f32) are 0-d
    tensors advanced or set in place, the β factors and the weight decay
    `wd_t` are 0-d tensors too, so a step captured into a CUDA graph
    reads them at every replay, and an eager step does the same
    arithmetic (a replay is bit-equal to it).  `lr` and `count` read and
    set them from the host (`lr` keeps the host's float; `count` reads the
    device).  `step(active=)` masks the step of a member that has stopped
    in a lockstep driver: with `active` False its parameters, moments and
    count stay as they were; with it True the step is the unmasked one, bit
    for bit."""

    B1, B2, EPS = 0.9, 0.999, 1e-8
    # under tensor parallelism (parallel/mesh.place_state): which params
    # are shards, and the group their squared norms are summed over
    sharded = None
    model_group = None

    def __init__(self, params, tcfg):
        if tcfg.optimizer not in ("adamw", "adam"):
            raise ValueError(f"optimizer {tcfg.optimizer!r}: expected adamw or adam")
        self.params = list(params)
        self.decoupled = tcfg.optimizer == "adamw"
        self.weight_decay = (float(getattr(tcfg, "weight_decay", 0.01))
                             if self.decoupled else 0.0)
        self.grad_clip = float(tcfg.grad_clip)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device

        def scalar(value):
            return torch.full((), value, dtype=torch.float32, device=dev)

        self._lr = float(tcfg.lr)
        self.lr_t = scalar(self._lr)
        self.wd_t = scalar(self.weight_decay)
        self.count_t = torch.zeros((), dtype=torch.int32, device=dev)
        self._b1, self._c1 = scalar(self.B1), scalar(1.0 - self.B1)
        self._b2, self._c2 = scalar(self.B2), scalar(1.0 - self.B2)
        self._one, self._zero = scalar(1.0), scalar(0.0)

    @property
    def lr(self) -> float:
        """The learning rate as the host last set it."""
        return self._lr

    @lr.setter
    def lr(self, value: float) -> None:
        self._lr = float(value)
        self.lr_t.fill_(self._lr)

    @property
    def count(self) -> int:
        """The step count (read from the device)."""
        return int(self.count_t)

    def set_weight_decay(self, wd: float) -> None:
        """AdamW's decay rate (the sweep's wd axis); Adam ignores it."""
        if self.decoupled:
            self.weight_decay = float(wd)
            self.wd_t.fill_(self.weight_decay)

    @torch.no_grad()
    def step(self, grads=None, *, active: Optional[torch.Tensor] = None) -> None:
        """Update the parameters from `grads` (one per parameter, None for
        none), by default from their `.grad`, which is cleared.  `active`
        (a 0-d bool tensor on the device) masks the step, as above."""
        if grads is None:
            grads = [p.grad for p in self.params]
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, self.params)]
        norm = self._global_norm(grads)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        grads = torch._foreach_mul(grads, scale)
        b1, c1, b2, c2, lr = self._b1, self._c1, self._b2, self._c2, self.lr_t
        if active is None:
            self.count_t.add_(1)
        else:
            b1 = torch.where(active, b1, self._one)
            c1 = torch.where(active, c1, self._zero)
            b2 = torch.where(active, b2, self._one)
            c2 = torch.where(active, c2, self._zero)
            lr = torch.where(active, lr, self._zero)
            self.count_t.add_(active.to(torch.int32))
        # optax's bias corrections: 1 - beta**count in f32 (a member masked
        # before its first step keeps count 0; its update is scaled by 0)
        count = self.count_t.clamp(min=1).to(torch.float32)
        bc1 = 1.0 - torch.pow(self._b1, count)
        bc2 = 1.0 - torch.pow(self._b2, count)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, c1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), c2))
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(mu_hat, denom)
        if self.decoupled:
            torch._foreach_add_(update, torch._foreach_mul(self.params,
                                                           self.wd_t))
        torch._foreach_add_(self.params, torch._foreach_mul(update,
                                                            torch.neg(lr)))
        for p in self.params:
            p.grad = None

    def _global_norm(self, grads) -> torch.Tensor:
        """‖g‖ over every parameter: a replicated gradient counted once,
        a shard's squared norm summed over the model axis."""
        norms = torch._foreach_norm(grads)
        if not self.sharded or not any(self.sharded):
            return torch.linalg.vector_norm(torch.stack(norms))
        rep = [n for n, s in zip(norms, self.sharded) if not s]
        sq = comm.all_reduce(torch.stack(
            [n for n, s in zip(norms, self.sharded) if s]).square().sum(),
            self.model_group)
        if rep:
            sq = sq + torch.stack(rep).square().sum()
        return torch.sqrt(sq)

    def state_dict(self) -> dict:
        """The moments `mu` and `nu` (one tensor per parameter, in the
        order of `params`; references, as `nn.Module.state_dict` gives),
        the step `count` (an int) and the learning rate `lr` (a float)."""
        return {"mu": list(self.mu), "nu": list(self.nu),
                "count": self.count, "lr": self.lr}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore a `state_dict()` in place; a moment of another count or
        shape than the parameters' raises."""
        for key in ("mu", "nu"):
            got = sd[key]
            if len(got) != len(self.params):
                raise ValueError(f"optimizer state {key}: {len(got)} tensors "
                                 f"for {len(self.params)} parameters")
            for dst, src in zip(getattr(self, key), got):
                if dst.shape != src.shape:
                    raise ValueError(f"optimizer state {key}: shape "
                                     f"{tuple(src.shape)} for a parameter of "
                                     f"shape {tuple(dst.shape)}")
                dst.copy_(src)
        self.count_t.fill_(int(sd["count"]))
        self.lr = float(sd["lr"])


def make_optimizer(tcfg, params) -> Optimizer:
    """Global-norm clip then AdamW (or Adam) over `params`."""
    return Optimizer(params, tcfg)


def batch_loss(model, tcfg, batch, *, impl: str = "xla",
               generator: Optional[torch.Generator] = None,
               parallel=None) -> torch.Tensor:
    """The reference loss contract: the ZLPR loss, averaged with the
    optional `sample_weight` (1 for real rows, 0 for padding) as
    Σ w·loss / max(Σ w, 1), so a zero-padded batch gives the reference's
    mean over its real rows.  The paragraph model's per-clip loss (B, P) is
    multiplied by `clip_mask` under `clip_mask_loss`
    (others/realformer.py:312) and averaged as Σ w·loss / max(Σ w·P, 1): the
    denominator counts every clip of a real row, masked or not, as JAX's
    `batch_loss` does.  Under `rdrop_kl`, with the model in training mode,
    `symmetric_sigmoid_kl` over the adjacent duplicate rows is added,
    weighted by w[::2] (Ren-MME/run.py:332-334).  `generator` feeds the
    model's dropout sites; it is passed on only when given, so that any
    callable of (batch, impl) without dropout can stand as the model.

    Under `compute_dtype="bfloat16"` the f32 parameters are cast to bf16
    inside the graph (`functional_call` with `p.to(bfloat16)`), so their
    gradients land in the f32 masters; batch floats go to bf16 except the
    keep-set, and the logits are upcast before the loss.  A batch in a wire
    format is restored first (`upcast_wire`, or `wire_to_bf16` under bf16
    compute).

    `parallel` (parallel/mesh.DataParallel): the batch holds this rank's
    rows of a data-parallel step.  The denominators are the global batch's
    (Σ w summed over 'data'; the rows times n_data), so each rank's loss is
    its rows' share of the global mean and their sum is the single
    device's loss; shards may hold different counts of real rows, where a
    mean of per-rank means would be wrong.  Dropout draws the global
    batch's masks and keeps the rank's rows."""
    dtype = getattr(tcfg, "compute_dtype", "float32")
    _check_dtype(dtype)
    batch = wire_to_bf16(batch) if dtype == "bfloat16" else upcast_wire(batch)
    kwargs = {"impl": impl}
    if generator is not None:
        kwargs["generator"] = generator
    with parallel.rows() if parallel is not None else contextlib.nullcontext():
        if dtype == "bfloat16":
            params = {n: p.to(torch.bfloat16)
                      for n, p in model.named_parameters()}
            logits = torch.func.functional_call(model, params, (batch,), kwargs)
        else:
            logits = model(batch, **kwargs)
    logits = infer_upcast(logits)
    per_sample = zlpr_loss(logits, batch["label"])
    if tcfg.clip_mask_loss:
        per_sample = per_sample * batch["clip_mask"]            # (B, P)
    w = batch.get("sample_weight")

    def total(local):   # a denominator summed over the data axis
        return local if parallel is None else parallel.total(local)

    n_data = 1 if parallel is None else parallel.n_data
    if w is None:
        loss = (per_sample.mean() if n_data == 1
                else per_sample.sum() / (per_sample.numel() * n_data))
    elif per_sample.ndim == 2:
        loss = ((per_sample * w[:, None]).sum()
                / torch.clamp(total(w.sum()) * per_sample.shape[1], min=1.0))
    else:
        loss = (per_sample * w).sum() / torch.clamp(total(w.sum()), min=1.0)
    if tcfg.rdrop_kl and model.training:
        pw = None if w is None else w[::2]
        denom = None
        if parallel is not None:
            denom = (logits.shape[0] // 2 * n_data if pw is None
                     else torch.clamp(total(pw.sum()), min=1.0))
        loss = loss + symmetric_sigmoid_kl(logits, pair_weight=pw,
                                           denominator=denom)
    return loss


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator   # dropout masks, on the model's device
    step: int = 0
    # on a mesh (parallel/mesh.place_state): the step's DataParallel and
    # the parameters' placements
    parallel: Optional[object] = None
    spec: Optional[dict] = None

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as host tensors and numbers: the
        model's `state_dict()` (the reference key names), the optimizer's
        moments, count and learning rate, the dropout generator's state and
        the step (JAX's params, opt_state, rng and step)."""
        opt = self.optimizer.state_dict()
        return {"model": {k: v.detach().cpu()
                          for k, v in self.model.state_dict().items()},
                "optimizer": {**opt, "mu": [t.cpu() for t in opt["mu"]],
                              "nu": [t.cpu() for t in opt["nu"]]},
                "generator": self.generator.get_state(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> "TrainState":
        """Restore a `state_dict()` in place, onto this state's devices; a
        model or optimizer of another structure raises."""
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"])
        self.step = int(sd["step"])
        return self


def dropout_generator(seed: int, device) -> torch.Generator:
    """The dropout stream of a state built from `seed`, on `device`: seeded
    from numpy's SeedSequence((seed, 1)), apart from the init stream that
    `build_model` seeds with `seed` itself."""
    gseed = int(np.random.SeedSequence((seed, 1)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(gseed)


def init_state(cfg, tcfg, seed: int, *, device=None) -> TrainState:
    """A model built from `seed` (`build_model`) on `device` ("cuda" unless
    "cpu" is asked for), a fresh optimizer over its parameters and the
    dropout generator of `seed`."""
    from ..models import build_model

    model = build_model(cfg, device=device, seed=seed)
    dev = next(model.parameters()).device
    return TrainState(model, make_optimizer(tcfg, model.parameters()),
                      dropout_generator(seed, dev))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the state's learning rate in place on its device (the host-side
    plateau controller, between epochs)."""
    state.optimizer.lr = lr
    return state


def accum_value_and_grad(model, tcfg, batch, *, impl: str = "xla",
                         accum_steps: int,
                         generator: Optional[torch.Generator] = None):
    """Gradient accumulation (JAX `engine._accum_value_and_grad`): the
    batch split into `accum_steps` micro-batches taken in turn, recombined
    exactly to the full-batch loss and gradient.  `batch_loss` is a
    weighted mean whose denominators are all proportional to the
    micro-batch's sample-weight total d_i (a plain mean: d_i = rows; a
    padded one: Σw times a constant; the R-Drop KL's pair denominator is
    d_i / 2), so each micro-batch's loss and gradient weighted by d_i and
    divided by Σ d_i give the full-batch value, zero-weight padding rows
    included.  Dropout draws the one stream of `generator` in micro-batch
    order.  Returns (loss, gradients, one per parameter, None where a
    parameter has none)."""
    batch = upcast_wire(batch)  # the d_i sums in f32, whatever the wire
    rows = batch["label"].shape[0]
    if rows % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the batch "
                         f"rows ({rows})")
    micro_rows = rows // accum_steps
    if tcfg.rdrop_kl and micro_rows % 2:
        raise ValueError("R-Drop needs even micro-batches (adjacent "
                         f"duplicate pairs); rows/accum_steps = {micro_rows}")
    params = list(model.parameters())
    lsum = gsum = dsum = None
    for i in range(accum_steps):
        mb = {k: v[i * micro_rows:(i + 1) * micro_rows]
              for k, v in batch.items()}
        w = mb.get("sample_weight")
        # torch.full, not torch.tensor: a fill kernel, so that the step
        # captures into a CUDA graph with no sample_weight too
        d = (w.sum() if w is not None
             else torch.full((), float(micro_rows), device=mb["label"].device))
        loss_i = batch_loss(model, tcfg, mb, impl=impl, generator=generator)
        g_i = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(loss_i, params, allow_unused=True), params)]
        g_i = torch._foreach_mul(g_i, d)
        if gsum is None:
            lsum, gsum, dsum = d * loss_i.detach(), g_i, d
        else:
            lsum = lsum + d * loss_i.detach()
            torch._foreach_add_(gsum, g_i)
            dsum = dsum + d
    denom = torch.clamp(dsum, min=1.0)  # an all-padding batch: 0 loss, 0 grads
    return lsum / denom, torch._foreach_div(gsum, denom)


def member_step(state: TrainState, tcfg, batch, *, impl: str = "xla",
                accum_steps: int = 1,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The body of one optimizer step, with no host-side bookkeeping (so
    that it can be captured into a CUDA graph): forward with dropout from
    the state's generator, the loss, the gradients (over `accum_steps`
    micro-batches when > 1), the optimizer update (masked by `active`,
    Optimizer.step).  On a mesh (`state.parallel`) the loss and gradients
    are summed over 'data' before the update.  Returns the loss, detached,
    on the device."""
    model = state.model
    model.train()
    if accum_steps > 1:
        loss, grads = accum_value_and_grad(model, tcfg, batch, impl=impl,
                                           accum_steps=accum_steps,
                                           generator=state.generator)
    else:
        loss = batch_loss(model, tcfg, batch, impl=impl,
                          generator=state.generator, parallel=state.parallel)
        grads = torch.autograd.grad(loss, state.optimizer.params,
                                    allow_unused=True)
    if state.parallel is not None:
        loss, grads = state.parallel.reduce(loss, [
            torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, state.optimizer.params)])
    state.optimizer.step(grads, active=active)
    return loss.detach()


def train_step(state: TrainState, tcfg, batch, *, impl: str = "xla",
               accum_steps: int = 1) -> torch.Tensor:
    """One optimizer step on `batch` (a dict of tensors on the model's
    device), dropout drawn from the state's generator, the gradient
    accumulated over `accum_steps` micro-batches when > 1
    (`accum_value_and_grad`); returns the loss, detached, on the device."""
    loss = member_step(state, tcfg, batch, impl=impl, accum_steps=accum_steps)
    state.step += 1
    return loss


def eval_loss(model, tcfg, batch, *, impl: str = "xla",
              parallel=None) -> torch.Tensor:
    """The eval-mode loss without autograd: the body of `eval_step`, with
    no host-side work, so that it can be captured; on a mesh the global
    batch's, summed over 'data'."""
    with torch.no_grad():
        model.eval()
        loss = batch_loss(model, tcfg, batch, impl=impl, parallel=parallel)
        if parallel is not None:
            loss = comm.all_reduce(loss, parallel.data_group)
        return loss


class StepBuffer:
    """Static device buffers for `slots` steps of `groups` batches each
    (one group per fold in a lockstep driver, 1 in the sequential one) and
    a device slot index that a captured step advances, so that a replay
    reads its batches with no input from the host.  `load` copies host-fed
    batches in (device to device) and zeroes the index; `read`, inside the
    step, gives a dict of (groups, rows, ...) tensors and advances the
    index."""

    def __init__(self, like: dict, slots: int, groups: int, device):
        self.slots, self.groups = slots, groups
        self.keys = list(like)
        self.bufs = {k: torch.empty((slots, groups) + tuple(v.shape),
                                    dtype=v.dtype, device=device)
                     for k, v in like.items()}
        self.slot = torch.zeros((), dtype=torch.int64, device=device)

    def load(self, steps) -> None:
        """`steps`: a list of at most `slots` lists of `groups` batch dicts
        on the device, with this buffer's keys and shapes."""
        if len(steps) > self.slots:
            raise ValueError(f"{len(steps)} steps for {self.slots} slots")
        for j, group in enumerate(steps):
            for f, batch in enumerate(group):
                if sorted(batch) != sorted(self.keys):
                    raise ValueError(f"batch keys {sorted(batch)}; the "
                                     f"captured step reads {sorted(self.keys)}")
                for k in self.keys:
                    dst = self.bufs[k][j, f]
                    if dst.shape != batch[k].shape or dst.dtype != batch[k].dtype:
                        raise ValueError(
                            f"batch {k!r} is {tuple(batch[k].shape)} "
                            f"{batch[k].dtype}; the captured step reads "
                            f"{tuple(dst.shape)} {dst.dtype}")
                    dst.copy_(batch[k], non_blocking=True)
        self.slot.zero_()

    def read(self) -> dict:
        if self.slots == 1:
            out = {k: v[0] for k, v in self.bufs.items()}
        else:
            # modulo the slots: a replay past the last one rereads a slot
            # rather than reading out of bounds
            j = torch.remainder(self.slot, self.slots).view(1)
            out = {k: v.index_select(0, j).squeeze(0)
                   for k, v in self.bufs.items()}
            self.slot.add_(1)
        return out


def eval_step(model, tcfg, batch, *, impl: str = "xla") -> torch.Tensor:
    """The loss in eval mode: no dropout mask drawn, no R-Drop KL."""
    return eval_loss(model, tcfg, batch, impl=impl)


@dataclasses.dataclass
class EpochStats:
    train_loss: float
    valid_loss: float
    steps: int
    samples: int  # real samples: zero-weight padding rows excluded
    seconds: float
    step_losses: Tuple[float, ...] = ()

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.seconds, 1e-9)


def chunks(it, size: int):
    """Lists of `size` consecutive items of `it`; the last may be shorter."""
    buf = []
    for x in it:
        buf.append(x)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


class Trainer:
    """Epoch driver: fresh loaders per epoch, plateau LR, early stop,
    best-checkpoint callback (JAX `Trainer`).

    `cfg` is the ModelConfig (or an ExperimentConfig) the states are built
    from; `train_loader` / `valid_loader` of `fit` are zero-arg callables
    returning an iterable of numpy batch dicts (a `data.loader.Batcher`).
    On a CUDA device the batches are fed by `prefetch_to_device`, PREFETCH
    batches ahead; on the CPU they are converted in the loop.

    `transfer_dtype` ("float16", "bfloat16" or "int8"): the batches travel
    in that wire format (data/loader.cast_for_transfer, in the prefetch
    thread) and every step restores f32 before any math: half the bytes
    of a batch, or a quarter of its features', at ~1e-3 relative rounding
    of the features (f16), or ~0.4 % of each row's largest value (int8);
    masks, labels and weights stay exact.  None (the default) ships f32.

    `accum_steps`: gradient accumulation, each batch split into this many
    micro-batches with the exact full-batch loss and gradient
    (`accum_value_and_grad`): a memory knob.

    On a CUDA device each train step and each eval step is one replay of
    a captured CUDA graph (serve/graphs.GraphedFunction, one per fit, the
    dropout generator registered), as JAX jits them, that reads its batch
    from static device buffers (`StepBuffer`); on the CPU the same steps
    are plain calls.  `scan_steps` > 1 (JAX's `lax.scan` of that many
    steps): the loader's batches are taken that many at a time, copied
    into the buffers together, and that many replays are launched back to
    back; the math and the dropout order are those of `scan_steps=1`.

    `profile_dir`: a torch.profiler trace (utils/logging.profile_trace) of
    the first epoch after the captures, counted from the fit's start
    epoch (a fit of one epoch traces that one, captures included), into
    this directory, one file a fit.

    `mesh` (parallel/mesh.make_mesh, JAX's `Trainer(mesh=)`): each rank
    feeds its rows of every global batch (`prefetch_to_device(mesh=)`),
    the state is placed onto the mesh (`place_state`: replicated, or with
    `tp` sharded by JAX's `tp_param_spec`; a resumed state too), and the
    step is the single device's (engine `batch_loss(parallel=)`,
    `member_step`); the batch rows must divide the data axis, and under
    R-Drop so must `batch_size`, so that no rank splits a duplicate pair
    (checked here, before any collective).  On NCCL
    each step is still one captured graph, its collectives inside (the
    first, eager call warms them up); gloo drives its collectives from the
    host, so on gloo with a CUDA device the steps run eagerly, as the log
    says.  Checkpoints are gathered whole (`WholeState`), so they reload
    on one card.
    `accum_steps > 1` with a mesh raises, as in JAX.  In any world of
    several ranks (a mesh, or `impl="cp"`) rank 0 alone checkpoints and
    logs."""

    PREFETCH = 2

    def __init__(self, cfg, tcfg, *, impl: str = "xla", device=None,
                 checkpoint_cb: Optional[Callable] = None,
                 log_cb: Optional[Callable] = None, transfer_dtype=None,
                 accum_steps: int = 1, scan_steps: int = 1,
                 profile_dir: Optional[str] = None, mesh=None,
                 tp: bool = False):
        from ..data.loader import resolve_transfer_dtype
        from ..parallel.mesh import captured_on, is_rank0
        from ..utils.device import resolve_device

        if accum_steps < 1 or scan_steps < 1:
            raise ValueError(f"accum_steps ({accum_steps}) and scan_steps "
                             f"({scan_steps}) must be >= 1")
        if scan_steps > 1 and accum_steps > 1:
            raise ValueError("accum_steps > 1 does not compose with "
                             "scan_steps > 1 (pick one dispatch-shape knob)")
        if accum_steps > 1 and mesh is not None:
            raise ValueError("accum_steps > 1 is single-device only "
                             "(the mesh's data axis already shrinks the "
                             "per-device batch)")
        if tp and mesh is None:
            raise ValueError("tp=True needs a mesh with a 'model' axis")
        if (mesh is not None and tcfg.rdrop_kl
                and tcfg.batch_size % mesh.shape["data"]):
            # a rank's rows would end inside a pair: its R-Drop term would
            # pair rows of two samples, or none (pipelines.run_experiment)
            raise ValueError(
                f"R-Drop's duplicate pairs must stay whole on a rank: "
                f"batch_size ({tcfg.batch_size}) must divide the data "
                f"axis ({mesh.shape['data']}) — adjust --dp or "
                "train.batch_size")
        self.transfer_dtype = resolve_transfer_dtype(transfer_dtype)
        self.cfg = getattr(cfg, "model", cfg)
        self.tcfg = tcfg
        self.impl = impl
        self.mesh = mesh
        self.tp = tp
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.writer = is_rank0()
        self.checkpoint_cb = self._whole(checkpoint_cb)
        self.log_cb = log_cb if self.writer else None
        self.accum_steps = accum_steps
        self.scan_steps = scan_steps
        self.profile_dir = profile_dir
        self.captured = captured_on(mesh, "Trainer")

    def _whole(self, cb):
        """`cb(state, ...)` as several ranks run it: under tensor
        parallelism every rank gathers the state whole (a collective),
        and rank 0 alone calls `cb` (with or without a mesh: `impl="cp"`
        runs every rank on the same state)."""
        from ..parallel.mesh import WholeState, world_size

        if cb is None or world_size() == 1:
            return cb

        def call(state, *args):
            whole = WholeState(state) if self.tp else state
            if self.writer:
                cb(whole, *args)

        return call

    def _iter(self, loader, counter: Optional[dict] = None):
        """Batches of one epoch on the device; `counter["n"]` counts the
        real samples from the numpy sample_weight, before the copy."""
        from ..data.loader import (cast_for_transfer, prefetch_to_device,
                                   to_device)

        def counting(it):
            for b in it:
                if counter is not None:
                    w = b.get("sample_weight")
                    counter["n"] += (int(np.asarray(w).sum()) if w is not None
                                     else int(b["label"].shape[0]))
                yield b

        it = counting(iter(loader()))
        if self.device.type == "cuda":
            return prefetch_to_device(it, device=self.device, size=self.PREFETCH,
                                      transfer_dtype=self.transfer_dtype,
                                      mesh=self.mesh)
        if self.mesh is not None:
            from ..parallel.mesh import put_global_batch

            return (put_global_batch(cast_for_transfer(b, self.transfer_dtype),
                                     self.mesh) for b in it)
        return (to_device(cast_for_transfer(b, self.transfer_dtype), self.device)
                for b in it)

    def _programs(self, state: TrainState):
        """(train, eval): functions of one epoch's device batches returning
        their losses, each step one replay of its captured program."""
        from ..serve.graphs import GraphedFunction

        tcfg, impl, dev = self.tcfg, self.impl, self.device
        progs = {}
        self.programs = {}   # kind -> the captured program

        def run(kind, batches):
            out = []
            for group in chunks(batches, self.scan_steps):
                if kind not in progs:
                    buf = StepBuffer(group[0], self.scan_steps, 1, dev)
                    if kind == "train":
                        def body(buf=buf):
                            return member_step(
                                state, tcfg, {k: v[0] for k, v in
                                              buf.read().items()},
                                impl=impl, accum_steps=self.accum_steps)
                        gens = (state.generator,)
                    else:
                        def body(buf=buf):
                            return eval_loss(state.model, tcfg,
                                             {k: v[0] for k, v in
                                              buf.read().items()}, impl=impl,
                                             parallel=state.parallel)
                        gens = ()
                    progs[kind] = (buf, GraphedFunction(
                        body, dev, name=f"Trainer.{kind}_step[{impl}]",
                        generators=gens))
                    self.programs[kind] = progs[kind][1]
                buf, prog = progs[kind]
                buf.load([[b] for b in group])
                call = prog if self.captured else prog.fn
                for _ in group:
                    out.append(call().clone())
                    if kind == "train":
                        state.step += 1
            return out

        return (lambda it: run("train", it)), (lambda it: run("eval", it))

    def fit(self, train_loader, valid_loader, *,
            state: Optional[TrainState] = None, epochs: Optional[int] = None,
            seed: Optional[int] = None, start_epoch: int = 0,
            plateau: Optional[schedule.PlateauState] = None,
            stopper: Optional[schedule.EarlyStop] = None,
            last_cb: Optional[Callable] = None):
        """Returns (state, history of EpochStats).  `start_epoch`, `plateau`
        and `stopper` inject a restored resume point
        (`CheckpointStore.restore_last`); `last_cb(state, epoch, plateau,
        stopper)` fires after every epoch, so the caller can persist one."""
        tcfg = self.tcfg
        if state is None:
            state = init_state(self.cfg, tcfg, tcfg.seed if seed is None else seed,
                               device=self.device)
        if self.mesh is not None and state.parallel is None:
            from ..parallel.mesh import place_state

            place_state(state, self.mesh, tp=self.tp)
        last_cb = self._whole(last_cb)
        plateau = plateau or schedule.PlateauState(
            lr=tcfg.lr, factor=tcfg.plateau_factor,
            patience=tcfg.plateau_patience)
        stopper = stopper or schedule.EarlyStop(patience=tcfg.early_stop,
                                                save_guard=tcfg.save_guard)
        history = []
        # a restored stopper that already fired trains no further: the
        # uninterrupted run stopped at that epoch.  Only a resume carries
        # one; a fresh stopper with patience 0 starts at bad == patience
        # and must still train
        if start_epoch > 0 and stopper.bad >= stopper.patience:
            return state, history
        run_train, run_eval = self._programs(state)
        n_epochs = tcfg.epochs if epochs is None else epochs
        profile_epoch = (start_epoch + 1 if n_epochs - start_epoch > 1
                         else start_epoch)
        for epoch in range(start_epoch, n_epochs):
            with profile_trace(self.profile_dir if epoch == profile_epoch
                               else None, name="trainer"):
                t0 = time.perf_counter()
                counter = {"n": 0}
                # losses stay on the device until the epoch ends: fetching
                # per step would make the host wait for the card every step
                losses = run_train(self._iter(train_loader, counter))
                va = run_eval(self._iter(valid_loader))
                step_losses = (tuple(torch.stack(losses).cpu().tolist())
                               if losses else ())
                va_losses = torch.stack(va).cpu().tolist() if va else []
            stats = EpochStats(
                train_loss=sum(step_losses) / max(len(step_losses), 1),
                valid_loss=sum(va_losses) / max(len(va_losses), 1),
                steps=len(step_losses), samples=counter["n"],
                seconds=time.perf_counter() - t0, step_losses=step_losses)
            history.append(stats)
            if self.log_cb:
                self.log_cb(epoch, stats)
            set_learning_rate(state, plateau.step(stats.valid_loss))
            save, stop = stopper.step(stats.valid_loss)
            if save and self.checkpoint_cb:
                self.checkpoint_cb(state, epoch, stats.valid_loss)
            if last_cb:
                last_cb(state, epoch, plateau, stopper)
            if stop:
                break
        return state, history
