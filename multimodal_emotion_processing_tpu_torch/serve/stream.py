"""Streaming single-sample inference (robot_demo.py:594-640): a k-member
ensemble, the mean of its logits, and the calibrated per-emotion sigmoid.

The members run one after another in a Python loop: each forward launches
the CUDA kernels through ctypes, which `torch.func.vmap` cannot trace
through.  `predict` packs the sample into one pinned host buffer, ships it
in one host-to-device copy, unpacks it on the device, and brings
(logits ++ probabilities) back in one copy.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..train.engine import infer_cast, infer_upcast


def _device_of(members) -> torch.device:
    devices = {next(m.parameters()).device for m in members}
    if len(devices) != 1:
        raise ValueError(f"ensemble members live on several devices: {devices}")
    return devices.pop()


def ensemble_serve_fn(members: Sequence[torch.nn.Module],
                      offsets: Sequence[float], *, impl: str = "xla",
                      dtype: str = "float32"):
    """THE serving computation: batch (B, ...) of device tensors ->
    (logits (B, E), probs (B, E')) as the mean of the members' f32-upcast
    logits and sigmoid(logits[:, :E'] − offsets).  `dtype="bfloat16"` runs
    the forwards in bf16 on bf16 copies of the members (`infer_cast`)."""
    if len(offsets) == 0:
        raise ValueError(
            "serving needs calibrated per-emotion offsets; this config has "
            "none — serve a config with fixed thresholds")
    if not members:
        raise ValueError("serving needs at least one ensemble member")
    device = _device_of(members)
    members = [infer_cast(m, None, dtype)[0] for m in members]
    off = torch.as_tensor(offsets, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def run(batch: Dict[str, torch.Tensor]):
        _, batch = infer_cast(None, batch, dtype)
        logits = torch.stack([infer_upcast(m(batch, impl=impl))
                              for m in members])           # (k, B, E)
        if logits.ndim != 3:
            raise ValueError(f"serving expects per-sample logits (k, B, E); "
                             f"got {tuple(logits.shape)}")
        pred = logits.mean(dim=0)
        probs = torch.sigmoid(pred[:, : off.shape[0]] - off)
        return pred, probs

    return run


class StreamingPredictor:
    """Batch-1 ensemble predictor.  One caller at a time: `predict` reuses
    one pinned staging buffer."""

    def __init__(self, members: Sequence[torch.nn.Module],
                 offsets: Sequence[float], *, impl: str = "xla",
                 dtype: str = "float32"):
        self.n_off = len(offsets)
        self.device = _device_of(members)
        self._run = ensemble_serve_fn(members, offsets, impl=impl, dtype=dtype)
        self._pack_keys: tuple = ()
        self._pack_shapes: tuple = ()
        self._host = None

    def warmup(self, sample: Dict[str, np.ndarray]) -> None:
        self.predict_unpacked(sample)
        self.predict(sample)

    def _batch1(self, sample: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)[None]).to(self.device)
                for k, v in sample.items() if k != "label"}

    def _build_packed(self, sample: Dict[str, np.ndarray]) -> None:
        if self._host is not None:
            return
        keys = tuple(k for k in sample if k != "label")
        shapes = tuple(tuple(np.asarray(sample[k]).shape) for k in keys)
        total = sum(int(np.prod(s)) for s in shapes)
        self._pack_keys, self._pack_shapes = keys, shapes
        self._host = torch.empty(total, dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")

    def _pack(self, sample: Dict[str, np.ndarray]) -> torch.Tensor:
        self._build_packed(sample)
        host = self._host.numpy()
        ofs = 0
        for k, shp in zip(self._pack_keys, self._pack_shapes):
            x = np.asarray(sample[k])
            if x.shape != shp:
                # the layout is fixed by the first sample; a different shape
                # would unpack garbage
                raise ValueError(
                    f"packed predict: sample[{k!r}] shape {x.shape} != {shp} "
                    "from the first sample; use a predictor per config/shape "
                    "or predict_unpacked()")
            n = x.size
            host[ofs: ofs + n] = x.ravel()
            ofs += n
        return self._host.to(self.device, non_blocking=True)

    def predict(self, sample: Dict[str, np.ndarray]):
        """Returns (raw ensemble logits (E,), calibrated probabilities (E',))
        through the packed path: one copy up, one copy down."""
        buf = self._pack(sample)
        batch, ofs = {}, 0
        for k, shp in zip(self._pack_keys, self._pack_shapes):
            n = int(np.prod(shp))
            batch[k] = buf[ofs: ofs + n].reshape((1,) + shp)
            ofs += n
        pred, probs = self._run(batch)
        out = torch.cat([pred[0], probs[0]]).cpu().numpy()
        return out[: out.shape[0] - self.n_off], out[out.shape[0] - self.n_off:]

    def predict_unpacked(self, sample: Dict[str, np.ndarray]):
        """One transfer per array; kept for parity tests."""
        pred, probs = self._run(self._batch1(sample))
        return pred[0].cpu().numpy(), probs[0].cpu().numpy()

    def emotions(self, sample, names: Sequence[str]) -> Dict[str, float]:
        """emotion -> rounded calibrated probability (robot_demo.py:616-622)."""
        _, probs = self.predict(sample)
        return {n: round(float(p), 2) for n, p in zip(names, probs)}
