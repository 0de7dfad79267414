"""Host-side batching and the feed to the GPU (data/loader.py of the JAX
package).

  * `Batcher` assembles batches from a struct-of-arrays copy of the samples
    with one vectorised gather per key; the final partial batch is
    zero-padded to full size and carries a `sample_weight` vector, so every
    step sees one shape and the weighted loss equals the reference's mean
    over the unpadded batch; with `duplicate=True` (Ren-MME's R-Drop,
    Ren-MME/run.py:143-146) each sample appears twice, in adjacent rows;
  * `prefetch_to_device` assembles batches in a background thread, stages
    them in pinned host memory and copies them to the GPU with non-blocking
    copies on a side stream, one or two batches ahead of the consumer;
  * `resample(epoch)` rebuilds the sample list at the start of every epoch
    (the robot demo's per-epoch text substitution), and a list whose
    entries do not stack (ragged shapes) is gathered row by row.

Not ported yet: the wire-compression dtypes (`cast_for_transfer`),
`pad_final=False` and `drop_remainder`.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


class Batcher:
    """A zero-arg callable: each call is one epoch's iterator of numpy batch
    dicts, shuffled by a generator seeded once at construction (so epochs
    differ and runs repeat).  With `duplicate`, a batch holds
    2 × `batch_size` rows, each sample in two adjacent ones, and padding
    rows are zero with `sample_weight` 0.  A batch carries the keys of the
    first sample the Batcher was built with."""

    def __init__(self, samples: Sequence[Dict[str, np.ndarray]],
                 batch_size: int, *, shuffle: bool = True,
                 duplicate: bool = False, seed: int = 0,
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
            batch = {}
            for k in self._keys:
                g = self._gather(idx, k)
                if actual < bs:
                    buf = np.zeros((bs,) + g.shape[1:], dtype=g.dtype)
                    buf[:actual] = g
                    g = buf
                batch[k] = g
            w = np.zeros(bs, np.float32)
            w[:actual] = 1.0
            batch["sample_weight"] = w
            yield batch

    def steps_per_epoch(self) -> int:
        """Batches per epoch: with `duplicate`, 2N rows in batches of
        2 × batch_size, the same count."""
        return -(-len(self.samples) // self.batch_size)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`, synchronously."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def prefetch_to_device(iterator: Iterator[Dict[str, np.ndarray]], *,
                       device, size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of `iterator` as tensors on the CUDA `device`, assembled and
    copied up to `size` batches ahead in a background thread.  Each batch is
    staged in pinned host memory and copied with non-blocking copies on a
    side stream; the consumer's stream waits on the copy's event, and every
    tensor is recorded on that stream, so its memory is not reused while
    the consumer may still read it.  An exception in the thread is raised
    to the consumer; closing the generator early releases the thread."""
    device = torch.device(device)
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
                    pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                              for k, v in batch.items()}
                    out = {k: t.to(device, non_blocking=True)
                           for k, t in pinned.items()}
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
