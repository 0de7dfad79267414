"""Ensembling and threshold selection (eval/ensemble.py of the JAX package).

The reference reloads k loss-tagged checkpoints and combines their logits
at test time (cmu-mosei/run.py:446-477: mean of 4; others/realformer.py:420:
a 0.6/0.4 blend; Ren-MME/run.py:727: sum).  Its realformer threshold sweep
re-runs the whole inference 400 times (others/realformer.py:411-441); here
the logits are computed once and every threshold is scored from them.

`Ensemble` runs its k members one after another in a Python loop, as
serving does (serve/stream.py): each forward launches the CUDA kernels
through ctypes, which `torch.func.vmap` cannot trace through.  On a CUDA
device the combination of one batch is one captured CUDA graph per batch
shape (serve/graphs.py), as JAX jits it once; `predict_all`'s loader pads
the final batch, so a pass replays one program.

`predict_all_staged` stages the whole split on the card once and replays
one captured program per batch, each reading its rows through a
device-side batch index: no per-batch gather, pinning or copy.

`Ensemble(stacked=True)` runs the members' grids on the stacked
RealFormer path (models/grid.py; taken at impl "xla" by RealFormer blocks,
ignored elsewhere), fixed when the ensemble is built.

`Ensemble(tower=)` (models/tower.TowerFeed) reads the text modality from
a frozen language model: each batch's transcripts are packed on the host
(in the feed thread), the tower runs once on the card, each sentence's
hidden states become the batch's `l` / `l_mask`, and every member reads
that one output; the members' combination is then the same captured
program.

`Ensemble(mesh=)` shards batch inference over the mesh's 'data' axis:
the members are replicated, each rank replays its captured program on
its own rows of every batch, and the logits are all-gathered, the same
as one device's (no model family mixes samples).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel import comm
from ..serve.graphs import GraphedFunction
from ..train import metrics
from ..train.engine import infer_cast, infer_upcast, upcast_wire
from ..utils import spans


class Ensemble:
    """k same-architecture `nn.Module` members and their combination
    weights: 1/k each for `combine="mean"`, 1 each for `"sum"` (Ren-MME),
    or the explicit `weights` (the realformer's 0.6/0.4).

    `dtype="bfloat16"` runs the forwards in bf16 on bf16 copies of the
    members, cast once here (`infer_cast`; the caller's stay f32), with the
    batches cast per call; each member's logits are upcast to f32 before
    they are combined, so the threshold and score math stays f32.  The
    members run in eval mode (no dropout) on the device of their
    parameters.

    `mesh` (parallel/mesh.make_mesh): every rank holds the same members
    and the same global batches; each runs its rows of the 'data' axis
    (a batch that does not divide the axis raises, as JAX's does) and the
    logits are all-gathered over it, outside the captured program."""

    def __init__(self, members: Sequence[torch.nn.Module],
                 weights: Optional[Sequence[float]] = None, *,
                 combine: str = "mean", impl: str = "xla",
                 dtype: str = "float32", mesh=None, stacked=None,
                 tower=None):
        if not members:
            raise ValueError("an ensemble needs at least one member")
        if combine not in ("mean", "sum"):
            raise ValueError(f"combine {combine!r}: expected mean or sum")
        devices = {next(m.parameters()).device for m in members}
        if len(devices) != 1:
            raise ValueError(f"ensemble members live on several devices: {devices}")
        self.device = devices.pop()
        if tower is not None and mesh is not None:
            raise ValueError("a tower does not compose with mesh= sharding")
        self.tower = tower
        self.k = len(members)
        self.impl = impl
        self.stacked = stacked
        self.mesh = mesh
        self.dtype = dtype
        self.members = [infer_cast(m, None, dtype)[0].eval() for m in members]
        if weights is not None:
            if len(weights) != self.k:
                raise ValueError(f"{len(weights)} weights for {self.k} members")
            w = [float(x) for x in weights]
        elif combine == "mean":
            w = [1.0 / self.k] * self.k
        else:
            w = [1.0] * self.k
        self.weights = torch.tensor(w, dtype=torch.float32, device=self.device)
        self.program = GraphedFunction(
            _combination(self.members, self.weights, impl, dtype, stacked),
            self.device,
            name=f"Ensemble.logits[{impl}]")

    def logits(self, batch) -> torch.Tensor:
        """The weighted combination of the members' logits for one batch
        (numpy arrays or tensors, on the host or the members' device), on
        the members' device: (B, E), or (B, P, E) for the paragraph model.
        One replay of the batch shape's program on a CUDA device."""
        if self.mesh is not None:
            from ..parallel.mesh import local_rows

            self._check_rows(batch)
            batch = local_rows(batch, self.mesh)
        if self.tower is not None:
            raise ValueError("logits() takes no tower: its batches are "
                             "packed by predict_all")
        return self._gathered(self.program({
            k: (v if torch.is_tensor(v)
                else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in batch.items()}).clone())

    def _check_rows(self, batch) -> None:
        n_data = self.mesh.shape["data"]
        b = next(iter(batch.values())).shape[0]
        if b % n_data:
            raise ValueError(
                f"batch size {b} must divide the mesh 'data' axis "
                f"({n_data}) for sharded inference — pick a batch_size "
                f"divisible by dp")

    def _gathered(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's rows' logits, or on a mesh every rank's, in order."""
        if self.mesh is None:
            return logits
        return comm.all_gather(logits, self.mesh.group("data"), 0)

    def predict_all(self, loader, *, transfer_dtype=None) -> np.ndarray:
        """The combined logits over a loader (a zero-arg callable such as a
        `data.loader.Batcher`, or an iterable of numpy batches), the rows
        whose `sample_weight` is 0 (padding) dropped.  On a CUDA device the
        batches are copied ahead by `prefetch_to_device`, and the logits
        stay on the card until one copy back at the end.
        `transfer_dtype` ("float16", "bfloat16" or "int8"): the batches
        travel in that wire format (data/loader.cast_for_transfer) and are
        restored to f32 on the device before any math.  Spans: `eval.pass`
        around it, and per batch `feed.wait` and `eval.batch` (the
        program's call: the input copy, the replay, the clone)
        (utils/spans.py)."""
        with spans.span("eval.pass"):
            return self._predict_all(loader, transfer_dtype)

    def _predict_all(self, loader, transfer_dtype) -> np.ndarray:
        from ..data.loader import (cast_for_transfer, prefetch_to_device,
                                   resolve_transfer_dtype, to_device)

        wire = resolve_transfer_dtype(transfer_dtype)
        keeps = []

        def keeping(it):
            for b in it:
                if self.mesh is not None:
                    self._check_rows(b)
                w = b.get("sample_weight")
                keeps.append(None if w is None else np.asarray(w) > 0)
                yield b

        it = keeping(iter(loader() if callable(loader) else loader))
        max_lens = []
        if self.tower is not None:
            it = self._packing(it, max_lens)
        if self.device.type == "cuda":
            it = prefetch_to_device(it, device=self.device, size=2,
                                    transfer_dtype=wire, mesh=self.mesh)
        else:
            if self.mesh is not None:
                from ..parallel.mesh import local_rows

                it = (local_rows(b, self.mesh) for b in it)
            it = (to_device(cast_for_transfer(b, wire), self.device)
                  for b in it)
        outs = []
        for i, b in enumerate(spans.waited("feed.wait", it)):
            with spans.span("eval.batch"):
                if self.tower is not None:
                    b = self.tower.features(b, max_lens[i])
                outs.append(self._gathered(self.program(b).clone()))
        if not outs:
            raise ValueError("predict_all: the loader gave no batch")
        lg = torch.cat(outs).cpu().numpy()
        if all(k is None for k in keeps):
            return lg
        keep = np.concatenate([np.ones(len(o), bool) if k is None else k
                               for k, o in zip(keeps, outs)])
        return lg[keep]

    def _packing(self, it, max_lens):
        """The tower's host packing of each batch, where the batches are
        made (the feed thread on a card); each batch's longest sequence is
        appended to `max_lens` before the batch is passed on."""
        for b in it:
            packed, max_len = self.tower.pack(b)
            max_lens.append(max_len)
            yield packed

    def predict_all_staged(self, samples: Sequence, batch_size: int, *,
                           transfer_dtype=None) -> np.ndarray:
        """The combined logits over `samples`, staged on the members' device
        once (train/device_epochs.stage_dataset, padded to a multiple of
        `batch_size`, in `transfer_dtype`'s wire format), then one replay
        of one captured program per batch, the batch's rows read through a
        device-side index; padding rows dropped, one copy back at the end.
        The same batches and math as `predict_all` over a
        Batcher(samples, batch_size, shuffle=False): the same logits.  A
        mesh raises, as in JAX."""
        if self.tower is not None:
            raise ValueError("staged prediction takes no tower: its batches "
                             "are packed one by one (predict_all)")
        if self.mesh is not None:
            raise ValueError(
                "staged prediction does not compose with mesh= sharding — "
                "use the per-batch path (predict_all) on a mesh")
        from ..train.device_epochs import stage_dataset

        data, _ = stage_dataset(list(samples), pad_to_multiple=batch_size,
                                transfer_dtype=transfer_dtype,
                                device=self.device)
        n_ev = int(data["sample_weight"].shape[0]) // batch_size
        j = torch.zeros((), dtype=torch.int64, device=self.device)
        rows = torch.arange(batch_size, device=self.device)
        combine = _combination(self.members, self.weights, self.impl,
                               self.dtype, self.stacked)

        def batch_logits():
            idx = j * batch_size + rows
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            j.add_(1)
            return combine(batch)

        program = GraphedFunction(batch_logits, self.device,
                                  name=f"Ensemble.predict_all_staged[{self.impl}]")
        outs = [program().clone() for _ in range(n_ev)]
        lg = torch.cat(outs).cpu().numpy()
        return lg[data["sample_weight"].float().cpu().numpy() > 0]


def _combination(members, weights, impl: str, dtype: str, stacked=None):
    """The weighted combination of one batch, as a closure that holds no
    reference to its Ensemble, so that its graphs die with the Ensemble."""

    @torch.inference_mode()
    def combine(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        # a batch may arrive in a wire format (data/loader.cast_for_transfer):
        # f32 is restored before any math
        _, batch = infer_cast(None, upcast_wire(batch), dtype)
        per = torch.stack([infer_upcast(m(batch, impl=impl, stacked=stacked))
                           for m in members])              # (k, B, ...)
        w = weights.reshape((len(members),) + (1,) * (per.ndim - 1))
        return (per * w).sum(dim=0)

    return combine


def group_average(logits: np.ndarray, group_ids: Sequence[int],
                  labels: Optional[np.ndarray] = None):
    """Average logit rows sharing a group id (order-preserving by first
    appearance); labels reduce to the group's first row.  This is the
    reference's two-crop test protocol: one prediction per sentence PAIR from
    the mean of its head/tail crop logits (cmu-mosei/run.py:462,477-480)."""
    logits = np.asarray(logits)
    gids = np.asarray(group_ids)
    uniq, first_idx, inverse = np.unique(gids, return_index=True,
                                         return_inverse=True)
    order = np.argsort(first_idx)  # preserve first-appearance order
    summed = np.zeros((len(uniq), logits.shape[-1]), np.float64)
    np.add.at(summed, inverse, logits)
    counts = np.bincount(inverse, minlength=len(uniq))
    avg = (summed / counts[:, None]).astype(logits.dtype)[order]
    if labels is None:
        return avg
    return avg, np.asarray(labels)[first_idx[order]]


def apply_thresholds(logits: np.ndarray, thresholds: Sequence[float],
                     emotion_index: Sequence[int]) -> np.ndarray:
    """Binary predictions: pred[:, j] = logits[:, emotion_index[j]] > thresholds[j]."""
    logits = np.asarray(logits)
    cols = np.stack([logits[:, idx] for idx in emotion_index], axis=1)
    return (cols > np.asarray(thresholds)[None, :]).astype(np.int32)


def threshold_sweep(
    logits: np.ndarray,
    labels: np.ndarray,
    thresholds: Sequence[float],
    emotion_index: Sequence[int],
    emotion_names: Sequence[str],
    *,
    metric: Callable = metrics.weighted_f1,
) -> Dict[str, Dict[str, float]]:
    """Per-emotion best threshold by the given metric, from CACHED logits —
    one inference pass total (vs the reference's sweep re-running inference
    per threshold).  Returns {emotion: {t, f1, acc}}."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    best = {}
    for j, name in enumerate(emotion_names):
        col = logits[:, emotion_index[j]]
        lab = labels[:, emotion_index[j]]
        b = {"t": 0.0, "f1": -1.0, "acc": 0.0}
        for t in thresholds:
            pred = (col > t).astype(np.int32)
            f1 = metric(lab, pred)
            if f1 > b["f1"]:
                b = {"t": float(t), "f1": float(f1),
                     "acc": metrics.accuracy(lab, pred)}
        best[name] = b
    return best


def realformer_threshold_grid(n: int = 400):
    """The reference's sweep grid: t/200 - 1 for t in range(400)
    (others/realformer.py:411-412)."""
    return [t / 200 - 1.0 for t in range(n)]


def robot_threshold_grid(n: int = 13):
    """robot_demo.py:532-533: i/10 - 1 for i in range(13)."""
    return [i / 10 - 1.0 for i in range(n)]


def joint_threshold_grid(
    logits: np.ndarray,
    labels: np.ndarray,
    grids: Sequence[Sequence[float]],
    emotion_index: Sequence[int],
    emotion_names: Sequence[str],
) -> Dict[str, object]:
    """Ren-MME's JOINT threshold grid search (Ren-MME/run.py:582-613): score
    every combination of per-emotion thresholds by micro-F1 + macro-F1 of the
    full multi-label matrix, keep the first maximizer in nested-loop order.

    The reference re-binarizes the whole prediction matrix per combination
    (its executed grid is degenerate — one value per emotion); here the
    per-emotion (TP, FP, FN) count curves are computed ONCE per threshold and
    every combination is scored by broadcast-summing count tables — micro-F1
    couples emotions only through ΣTP/ΣFP/ΣFN, macro-F1 is separable — so a
    g^8 grid costs O(N·Σg) counting + O(Πg) adds instead of O(N·Πg).
    Non-degenerate grids are fully supported (guarded at ~2e7 combinations).

    Returns {"thresholds": {name: t}, "objective", "micro_f1", "macro_f1"}.
    """
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    e = len(emotion_names)
    sizes = [len(g) for g in grids]
    total = int(np.prod(sizes))
    if total > 20_000_000:
        raise ValueError(f"grid product {total} too large; coarsen the grids")
    tp, fp, fn, f1e = [], [], [], []
    for j in range(e):
        col = logits[:, emotion_index[j]][:, None]      # (N, 1)
        lab = labels[:, emotion_index[j]][:, None] > 0  # (N, 1)
        pred = col > np.asarray(grids[j], col.dtype)[None, :]  # (N, g_j)
        tp_j = np.sum(pred & lab, axis=0).astype(np.float64)
        fp_j = np.sum(pred & ~lab, axis=0).astype(np.float64)
        fn_j = np.sum(~pred & lab, axis=0).astype(np.float64)
        shape = [1] * e
        shape[j] = sizes[j]
        tp.append(tp_j.reshape(shape))
        fp.append(fp_j.reshape(shape))
        fn.append(fn_j.reshape(shape))
        denom = 2 * tp_j + fp_j + fn_j
        f1e.append(np.divide(2 * tp_j, denom, out=np.zeros_like(denom),
                             where=denom > 0).reshape(shape))
    tp_sum = sum(tp)    # broadcast to the full (g_1, ..., g_e) table
    denom = 2 * tp_sum + sum(fp) + sum(fn)
    micro = np.divide(2 * tp_sum, denom, out=np.zeros_like(denom),
                      where=denom > 0)
    macro = sum(np.broadcast_to(x, micro.shape) / e for x in f1e)
    obj = micro + macro
    # np.argmax C-order = the reference's nested-loop order (love outermost),
    # strict-> keeps the FIRST maximizer exactly like its `f1 > temp_max`
    best = np.unravel_index(int(np.argmax(obj)), obj.shape)
    return {
        "thresholds": {emotion_names[j]: float(grids[j][best[j]])
                       for j in range(e)},
        "objective": float(obj[best]),
        "micro_f1": float(micro[best]),
        "macro_f1": float(np.broadcast_to(macro, obj.shape)[best]),
    }


def ren_mme_joint_grids(per: int = 5, lo: float = -4.2, hi: float = -1.0):
    """A non-degenerate default grid for the joint search, spanning the
    reference's tuned threshold range (love -3.6 ... anxi -1.2,
    Ren-MME/run.py:582-589): `per` evenly spaced values per emotion."""
    pts = [lo + (hi - lo) * i / (per - 1) for i in range(per)]
    return [list(pts) for _ in range(8)]
