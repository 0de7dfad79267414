"""Device mesh and sharding (parallel/mesh.py of the JAX package), over
`torch.distributed`.

The JAX package is one process over many devices, and GSPMD inserts the
collectives.  PyTorch runs one process per card, so here every rank runs
the same program on its own device and the collectives are written out
(`parallel/comm.py`):

  * `data`: the batch is sharded over this axis.  Every rank builds the
    same seeded global batch and copies only its own rows to its device
    (`process_batch_slice`, `put_global_batch`; ranks of one data slice
    take the same rows); the gradients are summed over the axis in one
    flat buffer a step (`DataParallel.reduce`), the loss's denominators
    are global sums, and dropout draws the global batch's masks and keeps
    the rank's rows (`models/layers.batch_rows`), so the step is the
    single device's;
  * `model`: tensor parallelism.  `tp_param_spec` places every 2-D weight
    as JAX's `tp_param_spec` does, rule for rule: the realformer's Q/K/V
    and first FFN products are column-parallel, its `proj` and second FFN
    row-parallel; a minus block's `proj` is column-parallel and its
    `minus` row-parallel; a classifier's input axis is sharded.  A torch
    Linear keeps (out, in), so JAX's `P(None, 'model')` on (in, out) is
    `Shard(0)` here and `P('model', None)` is `Shard(1)`.  `shard_params`
    keeps each rank's shard and tells the blocks (`TensorParallel`).

A world of one rank is JAX's one-device mesh: the same code, with every
collective over one rank.  Nothing here reads a cluster's environment
beyond torchrun's variables; `initialize_multihost` takes them explicitly
too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from . import comm

DATA, MODEL = "data", "model"

_DEVICE: list = []   # the device initialize_multihost bound this rank to


def initialize_multihost(*, backend: Optional[str] = None, device=None,
                         init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None) -> torch.device:
    """`torch.distributed.init_process_group` for this rank, once; returns
    the rank's device.  Rank and world size come from the arguments, else
    from torchrun's RANK / WORLD_SIZE (and MASTER_ADDR / MASTER_PORT
    through init_method "env://"), else a world of one rank on an
    in-memory store; the local rank from LOCAL_RANK, else the rank.  The device is cuda:LOCAL_RANK
    (NCCL) unless `device="cpu"` asks for the CPU (gloo), as the tests do;
    NCCL gets `device_id` so that it builds its communicator now: one
    first made inside a CUDA-graph capture fails the capture.  `backend`
    may name gloo for CUDA tensors too (its collectives then stage through
    the host, parallel/comm.py)."""
    from ..utils.device import resolve_device

    if dist.is_initialized():
        return local_device()
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    if init_method is None and "MASTER_ADDR" not in env:
        if world_size != 1:
            raise ValueError(
                f"a world of {world_size} ranks needs init_method= or "
                "torchrun's MASTER_ADDR / MASTER_PORT")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kw)
    _DEVICE[:] = [dev]
    return dev


def local_device() -> torch.device:
    """This rank's device: initialize_multihost's, or for a group made
    elsewhere the current CUDA device under NCCL, else the CPU."""
    if _DEVICE:
        return _DEVICE[0]
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost first")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank0() -> bool:
    """Whether this process writes reports, predictions, logs and
    checkpoints (rank 0, or no process group)."""
    return rank() == 0


@contextlib.contextmanager
def world(device=None):
    """The process group for the block: the caller's, or one of a single
    rank on `device` made here and destroyed on exit (an entry point asked
    for a mesh or `impl="cp"` without torchrun)."""
    if dist.is_initialized():
        yield local_device()
        return
    dev = initialize_multihost(device=device)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
        _DEVICE.clear()


class Mesh:
    """Ranks on named axes (JAX's `Mesh`): `shape[axis]`, this rank's
    index on an axis (`index`) and the process group along it (`group`),
    over a `torch.distributed.device_mesh.DeviceMesh`.  `device` is the
    rank's device."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: device_mesh.size(i)
                      for i, a in enumerate(self.axis_names)}
        self.size = device_mesh.size()

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def world_mesh(shape, names, device=None) -> Mesh:
    """A mesh of `shape` over every rank of the world, axes `names`, rank
    order row-major (JAX's `devices.reshape(shape)`)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = initialize_multihost(device=device)
    n = int(np.prod(shape))
    have = world_size()
    if n > have:
        raise ValueError(f"need {n} devices, have {have}")
    if n < have:
        raise ValueError(f"a mesh of {n} ranks in a world of {have}: launch "
                         f"{n} processes")
    # the DeviceMesh only names the groups: gloo's are host groups whatever
    # the tensors' device
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names)),
                dev)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *,
              device=None) -> Mesh:
    """The ('data', 'model') mesh over every rank (JAX `make_mesh`):
    `n_data` defaults to world // n_model."""
    initialize_multihost(device=device)
    if n_data is None:
        n_data = world_size() // n_model
    return world_mesh((n_data, n_model), (DATA, MODEL), device)


def captured_on(mesh, name: str) -> bool:
    """Whether a step with `mesh`'s collectives inside can be captured into
    a CUDA graph: not on gloo with a CUDA device, whose collectives run on
    the host (rank 0 logs that the steps of `name` then run eagerly)."""
    import sys

    if mesh is None or mesh.device.type != "cuda" or (
            dist.get_backend() != "gloo"):
        return True
    if is_rank0():
        print(f"[{name}] gloo mesh on a CUDA device: the steps run eagerly "
              "(gloo drives its collectives from the host)", file=sys.stderr,
              flush=True)
    return False


def process_batch_slice(global_batch_size: int, mesh: Optional[Mesh] = None
                        ) -> slice:
    """This rank's rows of a global batch: its slice of the mesh's data
    axis (ranks of one data slice share it), or without a mesh its slice
    among all the ranks.  The batch must divide evenly: dropping rows
    would lose data and change the global shape."""
    if mesh is not None:
        n, i = mesh.shape[DATA], mesh.index(DATA)
    else:
        n, i = world_size(), rank()
    if global_batch_size % n:
        raise ValueError(f"global_batch_size ({global_batch_size}) must be "
                         f"divisible by process_count ({n})")
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def local_rows(batch: Dict, mesh: Optional[Mesh]) -> Dict:
    """The host batch cut to this rank's rows."""
    return {k: v[process_batch_slice(v.shape[0], mesh)]
            for k, v in batch.items()}


def put_global_batch(batch: Dict, mesh: Optional[Mesh] = None) -> Dict:
    """A global host batch (every rank assembles the same, seeded) onto
    this rank's device: only the rank's rows are copied
    (`process_batch_slice`), so each rank moves 1/n_data of the bytes and
    no rank exchanges data."""
    from ..data.loader import to_device

    dev = mesh.device if mesh is not None else local_device()
    return to_device(local_rows(batch, mesh), dev)


# ---- tensor parallelism ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What a tensor-parallel module needs: the model axis's group, its
    size and this rank's index on it (the shard it holds)."""
    group: object
    size: int
    index: int


def _blocks(model):
    from ..models.layers import MinusBlock, RealformerBlock

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (MinusBlock, RealformerBlock))]


def tp_param_spec(model, enable: bool = True) -> Dict[str, object]:
    """The placement of every parameter (name -> `Shard(dim)` or
    `Replicate()`), JAX's rules on torch's (out, in) weights: in a block,
    `w_qkv.*` and `ffn.0` weights `Shard(0)` (column-parallel), `proj`
    `Shard(1)` in a realformer block (its context arrives head-sharded)
    and `Shard(0)` in a minus block (its context is replicated), `minus`
    and `ffn.2` `Shard(1)` (row-parallel); any `classifier` weight
    `Shard(1)`, its input axis (the logits stay whole); everything else,
    every bias and every 1-D or 3-D tensor replicated."""
    from ..models.layers import RealformerBlock

    qkv = {n for n, m in _blocks(model) if isinstance(m, RealformerBlock)}
    block_names = {n for n, _ in _blocks(model)}
    spec = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf, parent = parts[-1], (parts[-2] if len(parts) >= 2 else "")
        place = Replicate()
        if enable and p.ndim == 2 and leaf == "weight":
            owner = next((b for b in block_names
                          if name.startswith(b + ".")), None)
            local = name[len(owner) + 1:] if owner else ""
            if owner and local.startswith(("w_qkv.", "ffn.0.")):
                place = Shard(0)
            elif owner and local == "proj.weight":
                place = Shard(1) if owner in qkv else Shard(0)
            elif owner and local in ("minus.weight", "ffn.2.weight"):
                place = Shard(1)
            elif parent == "classifier":
                place = Shard(1)
        spec[name] = place
    return spec


def _tp_modules(model):
    from ..models.grid import Grid
    from ..models.heads import StateTransfer

    return [m for _, m in _blocks(model)] + [
        m for m in model.modules() if isinstance(m, (Grid, StateTransfer))]


def shard_params(mesh: Mesh, model, *, tp: bool = False):
    """Place `model` on the mesh in place: with `tp`, each sharded
    parameter keeps this rank's chunk (`tp_param_spec`) and the blocks,
    grids and heads learn the model axis (`TensorParallel`); without it,
    every parameter is replicated and nothing changes.  Returns the spec."""
    spec = tp_param_spec(model, enable=tp)
    if not tp:
        return spec
    info = TensorParallel(mesh.group(MODEL), mesh.shape[MODEL],
                          mesh.index(MODEL))
    with torch.no_grad():
        for name, p in model.named_parameters():
            place = spec[name]
            if isinstance(place, Shard):
                if p.shape[place.dim] % info.size:
                    raise ValueError(
                        f"{name} {tuple(p.shape)}: dim {place.dim} does not "
                        f"divide the model axis ({info.size})")
                p.data = p.data.chunk(info.size, place.dim)[info.index].clone()
    for m in _tp_modules(model):
        m.tp = info
    return spec


def gather_tensor(t: torch.Tensor, place, group) -> torch.Tensor:
    """The whole tensor of a shard (`Shard(dim)`), or `t` (`Replicate`)."""
    if isinstance(place, Shard):
        return comm.all_gather(t, group, place.dim)
    return t


# ---- the data-parallel step -----------------------------------------------

class DataParallel:
    """The pieces of a step on a mesh (JAX's sharded step, written out):
    the global denominators of the loss, the keep masks' rows, the flat
    all-reduce of the loss and the gradients over 'data', and the
    global-norm clip's sum over 'model'.  Every collective runs even over
    one rank (an all-reduce of one rank is exact), so a world of one rank
    gives the single device's bits."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_data = mesh.shape[DATA]
        self.data_index = mesh.index(DATA)
        self.data_group = mesh.group(DATA)
        self.model_group = mesh.group(MODEL)
        self.flat_bytes = 0   # the last step's all-reduce buffer

    def total(self, local: torch.Tensor) -> torch.Tensor:
        """The sum of a per-rank denominator over 'data' (no gradient)."""
        return comm.all_reduce(local, self.data_group)

    def rows(self):
        """The dropout sites' context: masks of the global batch, this
        rank's rows kept."""
        from ..models.layers import batch_rows

        return batch_rows(self.n_data, self.data_index)

    def reduce(self, loss: torch.Tensor, grads):
        """(loss, grads) summed over 'data' in one flat buffer: each rank's
        loss is its rows' share of the global mean, so the sums are the
        global loss and gradient.  Each gradient comes back as a view of
        the buffer at an offset aligned to 16 bytes (the padding between
        them is never read): the optimizer's multi-tensor kernels take the
        same vectorized path over it as over tensors of their own, and sum
        the clip's global norm in the same order."""
        dtype, device = grads[0].dtype, grads[0].device
        align = max(16 // grads[0].element_size(), 1)
        offsets, end = [], align          # the loss sits in the first slot
        for g in grads:
            offsets.append(end)
            end += -(-g.numel() // align) * align
        flat = torch.empty(end, dtype=dtype, device=device)
        views = [flat[o:o + g.numel()].view_as(g)
                 for o, g in zip(offsets, grads)]
        flat[:1].copy_(loss.detach().reshape(1))
        torch._foreach_copy_(views, list(grads))
        self.flat_bytes = flat.numel() * flat.element_size()
        comm.all_reduce(flat, self.data_group, inplace=True)
        return flat[0].to(loss.dtype), views


def place_state(state, mesh: Mesh, *, tp: bool = False):
    """A TrainState placed onto the mesh in place (JAX `place_state`): the
    model sharded by `shard_params` with the optimizer's moments cut the
    same way, the clip told which gradients are shards.  A state restored
    whole from a checkpoint goes through here too."""
    model = state.model
    spec = shard_params(mesh, model, tp=tp)
    opt = state.optimizer
    if tp:
        names = [n for n, _ in model.named_parameters()]
        info = next(m.tp for m in _tp_modules(model))
        with torch.no_grad():
            for moments in (opt.mu, opt.nu):
                for j, n in enumerate(names):
                    place = spec[n]
                    if (isinstance(place, Shard)
                            and moments[j].shape != opt.params[j].shape):
                        moments[j] = moments[j].chunk(
                            info.size, place.dim)[info.index].clone()
        opt.sharded = [isinstance(spec[n], Shard) for n in names]
        opt.model_group = mesh.group(MODEL)
    state.parallel = DataParallel(mesh)
    state.spec = spec
    return state


class WholeState:
    """A TrainState gathered whole (every shard all-gathered over
    'model'), as a checkpoint stores it: `state_dict()` gives what a
    one-card state's does, so the checkpoint reloads on one card.  Every
    rank of the model axis must build it (a collective)."""

    def __init__(self, state):
        self.model = state.model
        self.step = state.step
        spec = state.spec or {}
        group = state.parallel.model_group if state.parallel else None
        names = [n for n, _ in state.model.named_parameters()]
        places = {n: spec.get(n, Replicate()) for n in names}
        sd = state.state_dict()
        sd["model"] = {k: gather_tensor(v, places.get(k, Replicate()),
                                        group).cpu()
                       for k, v in state.model.state_dict().items()}
        for key in ("mu", "nu"):
            sd["optimizer"][key] = [
                gather_tensor(t, places[n], group).cpu()
                for t, n in zip(getattr(state.optimizer, key), names)]
        self._sd = sd

    def state_dict(self) -> dict:
        return self._sd
