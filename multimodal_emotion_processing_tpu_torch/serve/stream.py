"""Streaming single-sample inference (robot_demo.py:594-640): a k-member
ensemble, the mean of its logits, and the calibrated per-emotion sigmoid;
and clip-by-clip streaming of the recurrent paragraph head
(`ParagraphStreamingPredictor`).

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

from ..models.heads import StateTransfer, state_transfer_recurrence
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


class ParagraphStreamingPredictor:
    """Stateful per-clip streaming for the recurrent `state_transfer` head
    (JAX serve/stream.py `ParagraphStreamingPredictor`).

    The reference's paragraph model (others/realformer.py:266-286) scores
    only complete p_len-clip windows.  Here each member's recurrence carry
    (out, feats) and the paragraph's `started` flag stay on the device
    between calls, so a clip costs one grid forward per member plus the
    O(E²) gated recurrence, and clip t streamed equals column t of the
    whole-window logits.  `reset()` starts a new paragraph (the first
    clip's output is its own out_t1).  `weights`: the per-member logit
    blend, uniform by default (the reference blends two of five members at
    0.6/0.4, others/realformer.py:420).  The members run in a Python loop,
    as in `ensemble_serve_fn`.  One caller at a time."""

    _CLIP_KEYS = ("l", "v", "a", "l_mask", "v_mask", "a_mask")

    def __init__(self, members: Sequence[torch.nn.Module],
                 offsets: Sequence[float], *, weights=None,
                 impl: str = "xla", dtype: str = "float32"):
        if not members:
            raise ValueError("serving needs at least one ensemble member")
        for m in members:
            if not isinstance(m, StateTransfer):
                raise ValueError(
                    "ParagraphStreamingPredictor serves the recurrent "
                    f"state_transfer head; got {type(m).__name__} — use "
                    "StreamingPredictor")
        if len(offsets) == 0:
            raise ValueError(
                "serving needs calibrated per-emotion offsets; pass the "
                "swept thresholds (this config has none)")
        self.device = _device_of(members)
        self.impl = impl
        self.dtype = dtype
        self.k = len(members)
        self.members = [infer_cast(m, None, dtype)[0] for m in members]
        w = (torch.full((self.k,), 1.0 / self.k) if weights is None
             else torch.as_tensor(weights, dtype=torch.float32))
        if tuple(w.shape) != (self.k,):
            raise ValueError(f"weights must have shape ({self.k},)")
        self.weights = w.to(self.device)
        self.off = torch.as_tensor(offsets, dtype=torch.float32,
                                   device=self.device)
        self.n_off = len(offsets)
        e = members[0].n_emotions
        self.trans = torch.stack([m.trans.detach().float()
                                  for m in members])          # (k, E, E)
        self._zero = (torch.zeros(self.k, 1, e, device=self.device),
                      torch.zeros(self.k, 1, e, device=self.device),
                      torch.zeros((), dtype=torch.bool, device=self.device))
        self.reset()

    def reset(self) -> None:
        """Start a new paragraph: the next clip is t = 0 (no carry)."""
        self._state = self._zero

    def _clip1(self, clip: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(clip[k])[None]).to(self.device)
                for k in self._CLIP_KEYS}

    @torch.inference_mode()
    def _step(self, state, clip: Dict[str, np.ndarray]):
        """(blended logits ++ probabilities on the device, the new state)."""
        _, batch = infer_cast(None, self._clip1(clip), self.dtype)
        outs = [m.clip(*(batch[k] for k in self._CLIP_KEYS), impl=self.impl)
                for m in self.members]
        out_t1 = torch.stack([infer_upcast(o) for o, _ in outs])   # (k, 1, E)
        feats = torch.stack([infer_upcast(f) for _, f in outs])
        prev_out, prev_feats, started = state
        rec = state_transfer_recurrence(self.trans, prev_out, prev_feats,
                                        out_t1, feats)
        # first clip of a paragraph: out = out_t1 (the reference's t = 0)
        out = torch.where(started, rec, out_t1)
        pred = torch.einsum("k,kbe->be", self.weights, out)[0]      # (E,)
        probs = torch.sigmoid(pred[: self.n_off] - self.off)
        new_state = (out, feats, torch.ones_like(started))
        return torch.cat([pred, probs]), new_state

    def warmup(self, clip: Dict[str, np.ndarray]) -> None:
        """One clip through every member from a fresh paragraph; the state
        is left as it was."""
        self._step(self._zero, clip)[0].cpu()

    def push(self, clip: Dict[str, np.ndarray]):
        """Feed the next clip; returns (raw blended logits (E,), calibrated
        probabilities (E',)) in one copy from the device.  The state
        advances: call reset() between paragraphs."""
        out, self._state = self._step(self._state, clip)
        out = out.cpu().numpy()
        return out[: out.shape[0] - self.n_off], out[out.shape[0] - self.n_off:]

    def emotions(self, clip, names: Sequence[str]) -> Dict[str, float]:
        _, probs = self.push(clip)
        return {n: round(float(p), 2) for n, p in zip(names, probs)}
