"""Ahead-of-time serving export (serve/export.py of the JAX package): the
whole k-member serving computation (each member's forward, the logit mean,
the calibrated sigmoid) and its weights as one `torch.export` artifact,
which a host loads and calls with no model code.

    blob = export_predictor(members, offsets, example_sample)
    Path("predictor.pt2").write_bytes(blob)
    # the serving host:
    fn = load_predictor(Path("predictor.pt2").read_bytes())
    pred, probs = fn(batch)

As JAX exports, the members run at impl="xla", the plain PyTorch path:
the hand-written kernels are launched through ctypes, which `torch.export`
cannot trace.  A torch artifact holds its weights on one device, so
`device` takes the place of JAX's `platforms`: an artifact exported for
"cuda" runs on a CUDA card, one for "cpu" on the CPU.
"""

from __future__ import annotations

import copy
import io
from typing import Dict, Sequence

import numpy as np
import torch

from ..train.engine import infer_cast, infer_upcast
from ..utils.device import resolve_device


class _Predictor(torch.nn.Module):
    """The serving computation of `ensemble_serve_fn` at impl="xla" as one
    module: batch (B, ...) -> (logits (B, E), probs (B, E')), or at
    `batch_size` 1 (logits (E,), probs (E',))."""

    def __init__(self, members, offsets, dtype: str, batch_size: int):
        super().__init__()
        self.members = torch.nn.ModuleList(
            infer_cast(m, None, dtype)[0].eval() for m in members)
        device = next(self.members[0].parameters()).device
        self.register_buffer(
            "off", torch.as_tensor(offsets, dtype=torch.float32, device=device))
        self.dtype = dtype
        self.squeeze = batch_size == 1

    def forward(self, batch: Dict[str, torch.Tensor]):
        _, batch = infer_cast(None, batch, self.dtype)
        logits = torch.stack([infer_upcast(m(batch, impl="xla"))
                              for m in self.members])       # (k, B, E)
        pred = logits.mean(dim=0)
        probs = torch.sigmoid(pred[:, : self.off.shape[0]] - self.off)
        if self.squeeze:
            return pred[0], probs[0]
        return pred, probs


def export_predictor(members: Sequence[torch.nn.Module],
                     offsets: Sequence[float],
                     example_sample: Dict[str, np.ndarray], *,
                     batch_size: int = 1, dtype: str = "float32",
                     device=None) -> bytes:
    """The bytes of `torch.export.save` of the ensemble serving computation
    on `device` ("cuda" unless "cpu" is asked for; the members are copied
    there), weights included.  `example_sample` fixes the per-sample input
    shapes (every key but the label) and `batch_size` the static batch
    axis: 1 exports the live predictor (outputs (E,) and (E',)), more
    exports the batching server's bucket program (outputs (B, E) and
    (B, E')); export one artifact per bucket size."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if len(offsets) == 0:
        raise ValueError("serving needs calibrated per-emotion offsets; this "
                         "config has none — pass offsets explicitly")
    if not members:
        raise ValueError("serving needs at least one ensemble member")
    device = resolve_device(device)
    members = [copy.deepcopy(m).to(device) for m in members]
    module = _Predictor(members, offsets, dtype, batch_size).eval()
    example = {k: torch.as_tensor(np.repeat(np.asarray(v)[None], batch_size,
                                            axis=0), device=device)
               for k, v in example_sample.items() if k != "label"}
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_predictor(blob: bytes):
    """`fn(batch) -> (pred, probs)` from an exported artifact: batch is a
    dict of tensors (or numpy arrays) of the exported shapes; it runs on
    the device the artifact was exported for."""
    program = torch.export.load(io.BytesIO(blob))
    module = program.module()
    device = next(iter(program.state_dict.values())).device

    def fn(batch):
        with torch.no_grad():
            return module({k: torch.as_tensor(v, device=device)
                           for k, v in batch.items() if k != "label"})

    return fn
