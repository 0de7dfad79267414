"""Host-side batching and the feed to the GPU (data/loader.py of the JAX
package).

  * `Batcher` assembles batches from a struct-of-arrays copy of the samples
    with one vectorised gather per key; the final partial batch is
    zero-padded to full size and carries a `sample_weight` vector, so every
    step sees one shape and the weighted loss equals the reference's mean
    over the unpadded batch (`pad_final=False`: no padding and no
    `sample_weight`, the last batch short; `drop_remainder=True`: no last
    partial batch); with `duplicate=True` (Ren-MME's R-Drop,
    Ren-MME/run.py:143-146) each sample appears twice, in adjacent rows;
  * `prefetch_to_device` assembles batches in a background thread, stages
    them in pinned host memory and copies them to the GPU with non-blocking
    copies on a side stream, one or two batches ahead of the consumer; on
    a data-parallel mesh every rank's Batcher gives the same seeded global
    batches and each rank copies only its own rows
    (parallel/mesh.put_global_batch);
  * `resample(epoch)` rebuilds the sample list at the start of every epoch
    (the robot demo's per-epoch text substitution), and a list whose
    entries do not stack (ragged shapes) is gathered row by row;
  * `cast_for_transfer` shrinks a batch to a wire format (float16,
    bfloat16, or int8 with per-row scales) for the copy to the device;
    the steps restore f32 before any math (train/engine.upcast_wire).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

#: wire formats for `cast_for_transfer`: "float16" (exact for the 0/1
#: mask, label and weight vectors, ~1e-3 relative rounding of features,
#: saturates at ±65504), "bfloat16" (the f32 range, a coarser mantissa) and
#: "int8" (per-row symmetric quantization of FEATURE keys, ~4x fewer bytes;
#: mask, weight and label keys travel as exact float16).  numpy has no
#: bfloat16, so that wire's leaves are torch tensors (cast by torch, round
#: to nearest even, the bits ml_dtypes gives).
WIRE_DTYPES = {"float16": np.float16, "bfloat16": torch.bfloat16,
               "int8": "int8"}

#: f32 keys whose name contains one of these stay on the EXACT f16 path
#: under the "int8" wire (their values are 0/1 flags whose meaning, such as
#: the -1e8 additive attention mask, must not pick up quantization noise)
EXACT_KEY_SUBSTRINGS = ("mask", "weight", "label")

#: reserved suffix of the int8 wire's per-row scales (consumed and dropped
#: by train/engine.upcast_wire)
WIRE_SCALE_SUFFIX = "__wire_scale"


def resolve_transfer_dtype(dtype):
    """None | "float16" | "bfloat16" | "int8" | a numpy dtype -> a numpy
    dtype, torch.bfloat16, the "int8" sentinel, or None."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        if dtype not in WIRE_DTYPES:
            raise ValueError(f"transfer_dtype must be one of "
                             f"{sorted(WIRE_DTYPES)}, got {dtype!r}")
        return WIRE_DTYPES[dtype]
    if dtype is torch.bfloat16:
        return dtype
    return np.dtype(dtype)


def quantize_rows(v: np.ndarray):
    """Per-leading-axis-row symmetric int8 quantization: returns (q int8
    like v, scales float32 (n,)) with q = clip(round(v / s), ±127) and
    s = max(row absmax / 127, 1e-12), rounding half to even."""
    n = v.shape[0] if v.ndim else 1
    flat = np.abs(v).reshape(n, -1) if v.ndim > 1 else np.abs(v)[:, None]
    scales = np.maximum(flat.max(axis=1) / 127.0, 1e-12).astype(np.float32)
    bshape = (-1,) + (1,) * (v.ndim - 1)
    q = np.clip(np.round(v / scales.reshape(bshape)),
                -127, 127).astype(np.int8)
    return q, scales


def cast_for_transfer(batch: Dict[str, np.ndarray], dtype) -> Dict:
    """Shrink the host-to-device bytes of a numpy batch; the steps restore
    float32 on the device (train/engine.upcast_wire) before any math, so
    these are TRANSFER formats, never compute dtypes.  `dtype` as
    `resolve_transfer_dtype` gives it; None returns the batch.

      * float16 / bfloat16 (half the bytes): every float32 leaf is cast;
        ~1e-3 relative rounding of features (f16 saturates at ±65504; bf16
        keeps the range), exact on 0/1 masks, labels and weights.  The
        bfloat16 leaves are torch tensors.
      * "int8" (a quarter of the feature bytes): float32 FEATURE keys are
        quantized per leading-axis row (`quantize_rows`), their scales
        shipped as '<key>__wire_scale' f32 vectors (error at most s/2 per
        element); keys whose name contains mask, weight or label take the
        exact float16 path."""
    if dtype is None:
        return batch
    if dtype is torch.bfloat16:
        return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
                    if v.dtype == np.float32 else v)
                for k, v in batch.items()}
    if not isinstance(dtype, str):  # the float16 wire
        return {k: (v.astype(dtype) if v.dtype == np.float32 else v)
                for k, v in batch.items()}
    if dtype != "int8":
        raise ValueError(f"unknown wire {dtype!r}")
    out = {}
    for k, v in batch.items():
        if k.endswith(WIRE_SCALE_SUFFIX) or v.dtype != np.float32:
            out[k] = v  # scales of an already-cast batch, or not f32
        elif any(t in k for t in EXACT_KEY_SUBSTRINGS):
            out[k] = v.astype(np.float16)  # 0/1 values: exact
        else:
            out[k], out[k + WIRE_SCALE_SUFFIX] = quantize_rows(v)
    return out


def _host_tensor(v) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))


class Batcher:
    """A zero-arg callable: each call is one epoch's iterator of numpy batch
    dicts, shuffled by a generator seeded once at construction (so epochs
    differ and runs repeat).  With `duplicate`, a batch holds
    2 × `batch_size` rows, each sample in two adjacent ones, and padding
    rows are zero with `sample_weight` 0.  A batch carries the keys of the
    first sample the Batcher was built with.  `pad_final=False`: the last
    batch keeps its real rows only and no batch carries `sample_weight`;
    `drop_remainder=True`: an epoch ends before its last partial batch."""

    def __init__(self, samples: Sequence[Dict[str, np.ndarray]],
                 batch_size: int, *, shuffle: bool = True,
                 duplicate: bool = False, pad_final: bool = True,
                 seed: int = 0, drop_remainder: bool = False,
                 resample: Optional[Callable[[int], Sequence[Dict]]] = None):
        """`resample(epoch) -> samples` replaces the sample list at the
        start of each epoch, epoch 0 included: the robot demo's per-epoch
        label-matched text substitution (the reference rebuilds its
        replace_dict in every data_loader call, robot_demo.py:256-258)."""
        self.samples = list(samples)
        if not self.samples:
            raise ValueError("empty sample list")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.duplicate = duplicate
        self.pad_final = pad_final
        self.drop_remainder = drop_remainder
        self.resample = resample
        self._epoch = 0
        self._rng = np.random.default_rng(seed)
        self._keys = list(self.samples[0])
        self._stacked = None  # struct-of-arrays copy, built lazily
        self._ragged = False  # the list did not stack: gather row by row

    def _stack(self) -> bool:
        """One contiguous (N, ...) array per key, so a batch is one gather
        per key; False when the samples' shapes do not stack."""
        try:
            self._stacked = {k: np.stack([s[k] for s in self.samples])
                             for k in self._keys}
        except ValueError:
            return False
        return True

    def _gather(self, idx, k):
        if self._stacked is not None:
            return self._stacked[k][idx]
        # the row-by-row fallback: the first row's shape and dtype
        first = np.asarray(self.samples[idx[0]][k])
        buf = np.zeros((len(idx),) + first.shape, dtype=first.dtype)
        for row, i in enumerate(idx):
            buf[row] = self.samples[i][k]
        return buf

    def __call__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.resample is not None:
            self.samples = list(self.resample(self._epoch))
            self._epoch += 1
            self._stacked = None
            self._ragged = False
        if self._stacked is None and not self._ragged and not self._stack():
            self._ragged = True  # tried once per sample list, not per epoch
        order = np.arange(len(self.samples))
        if self.shuffle:
            self._rng.shuffle(order)
        if self.duplicate:
            order = np.repeat(order, 2)
        bs = self.batch_size * (2 if self.duplicate else 1)
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            actual = len(idx)
            if actual < bs and self.drop_remainder:
                return
            batch = {}
            for k in self._keys:
                g = self._gather(idx, k)
                if actual < bs and self.pad_final:
                    buf = np.zeros((bs,) + g.shape[1:], dtype=g.dtype)
                    buf[:actual] = g
                    g = buf
                batch[k] = g
            if self.pad_final:
                w = np.zeros(bs, np.float32)
                w[:actual] = 1.0
                batch["sample_weight"] = w
            yield batch

    def steps_per_epoch(self) -> int:
        """Batches per epoch: with `duplicate`, 2N rows in batches of
        2 × batch_size, the same count; without the last partial batch
        under `drop_remainder`."""
        if self.drop_remainder:
            return len(self.samples) // self.batch_size
        return -(-len(self.samples) // self.batch_size)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or host tensors) as tensors on `device`,
    synchronously."""
    return {k: _host_tensor(v).to(device) for k, v in batch.items()}


def prefetch_to_device(iterator: Iterator[Dict[str, np.ndarray]], *,
                       device, size: int = 2, transfer_dtype=None,
                       mesh=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of `iterator` as tensors on the CUDA `device`, assembled and
    copied up to `size` batches ahead in a background thread.  Each batch is
    cast to the wire `transfer_dtype` in the thread (`cast_for_transfer`;
    None keeps f32), staged in pinned host memory and copied with
    non-blocking copies on a side stream; the consumer's stream waits on
    the copy's event, and every tensor is recorded on that stream, so its
    memory is not reused while the consumer may still read it.  An
    exception in the thread is raised to the consumer; closing the
    generator early releases the thread.  With `mesh`
    (parallel/mesh.Mesh), every rank's iterator gives the same global
    batches and the thread copies only this rank's rows of the data axis
    (`parallel.mesh.local_rows`, as `put_global_batch` does)."""
    from ..parallel.mesh import local_rows

    device = torch.device(device)
    wire = resolve_transfer_dtype(transfer_dtype)
    if device.type != "cuda":
        raise ValueError(f"prefetch_to_device feeds a CUDA device, got {device}")
    copy_stream = torch.cuda.Stream(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            with torch.cuda.device(device), torch.cuda.stream(copy_stream):
                for batch in iterator:
                    if stop.is_set():
                        return
                    if mesh is not None:
                        batch = local_rows(batch, mesh)
                    host = {k: _host_tensor(v) for k, v in
                            cast_for_transfer(batch, wire).items()}
                    out = {k: t.pin_memory().to(device, non_blocking=True)
                           for k, t in host.items()}
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                    if not offer((out, ready)):
                        return
            offer(end)
        except BaseException as e:  # raised again in the consumer
            offer(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            out, ready = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for t in out.values():
                t.record_stream(consumer)
            yield out
    finally:
        stop.set()
        thread.join(timeout=5.0)
