"""Streaming single-sample inference (robot_demo.py:594-640): a k-member
ensemble, the mean of its logits, and the calibrated per-emotion sigmoid;
and clip-by-clip streaming of the recurrent paragraph head
(`ParagraphStreamingPredictor`).

The members run one after another in a Python loop: each forward launches
the CUDA kernels through ctypes, which `torch.func.vmap` cannot trace
through.  On a CUDA device every serving computation is one captured CUDA
graph per input shape (serve/graphs.py), the counterpart of JAX's one
compiled program per shape: `ensemble_serve_fn`, the packed predict
program of `StreamingPredictor` (and of each `BatchingServer` bucket), and
the paragraph step.  `stacked_grid=True` builds them on the stacked
RealFormer grid (models/grid.py; impl "xla", RealFormer blocks), fixed
when the predictor or server is built.  `predict` packs the sample into
one pinned host
buffer, replays one program that copies it to the device, unpacks it, runs
the ensemble and writes (logits ++ probabilities) into one static output,
and brings that back in one copy.  `StreamingPredictor(wire_dtype=
"float16")` packs the sample as float16 (half the bytes up, ~1e-3 relative
rounding of the features; data/loader.WIRE_DTYPES), upcast to f32 on the
device inside the program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..models.heads import StateTransfer, state_transfer_recurrence
from ..train.engine import infer_cast, infer_upcast
from .graphs import GraphedFunction

def _device_of(members) -> torch.device:
    devices = {next(m.parameters()).device for m in members}
    if len(devices) != 1:
        raise ValueError(f"ensemble members live on several devices: {devices}")
    return devices.pop()


def ensemble_serve_fn(members: Sequence[torch.nn.Module],
                      offsets: Sequence[float], *, impl: str = "xla",
                      dtype: str = "float32",
                      stacked=None) -> GraphedFunction:
    """THE serving computation: batch (B, ...) of tensors -> (logits (B, E),
    probs (B, E')) as the mean of the members' f32-upcast logits and
    sigmoid(logits[:, :E'] − offsets).  `dtype="bfloat16"` runs the
    forwards in bf16 on bf16 copies of the members (`infer_cast`), made
    once here and held by the program; `stacked` is the members' grid
    path (`Grid.forward`).  Returned as a `GraphedFunction`: on
    a CUDA device one captured graph per batch shape, whose outputs the
    caller copies out before the next call; `.fn` is the eager path."""
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
        logits = torch.stack([infer_upcast(m(batch, impl=impl,
                                             stacked=stacked))
                              for m in members])           # (k, B, E)
        if logits.ndim != 3:
            raise ValueError(f"serving expects per-sample logits (k, B, E); "
                             f"got {tuple(logits.shape)}")
        pred = logits.mean(dim=0)
        probs = torch.sigmoid(pred[:, : off.shape[0]] - off)
        return pred, probs

    return GraphedFunction(run, device, name=f"ensemble_serve_fn[{impl}]")


def packed_wire(wire_dtype) -> np.dtype:
    """The packed buffer's dtype: float32 (None or "float32"), or a wire of
    data/loader.WIRE_DTYPES that numpy holds (float16)."""
    from ..data.loader import WIRE_DTYPES

    if wire_dtype in (None, "float32"):
        return np.dtype(np.float32)
    wire = WIRE_DTYPES.get(wire_dtype)
    if not (isinstance(wire, type) and issubclass(wire, np.floating)):
        raise ValueError(f"packed wire_dtype {wire_dtype!r}: expected "
                         "'float32' or 'float16'")
    return np.dtype(wire)


class PackedProgram:
    """The serving computation for `batch` samples of one layout, fed from
    one pinned host buffer of `wire` (float32, or float16 for half the
    bytes, upcast to f32 on the device inside the program): a call packs
    the samples' keys (in `keys` order, each (batch, *shape) block in
    turn), replays one graph (the copy to the device, the unpack, `serve`,
    and pred ++ probs into one (batch, E + E') output) and brings the
    output back in one device-to-host copy.  The host buffers are reused by
    the next call: one caller at a time."""

    def __init__(self, serve, keys, shapes, batch: int, device, *,
                 name: str = "", wire=np.float32):
        self.keys, self.shapes, self.batch = tuple(keys), tuple(shapes), batch
        self.sizes = tuple(batch * int(np.prod(s)) for s in self.shapes)
        self.device = device
        self.wire = np.dtype(wire)
        pinned = device.type == "cuda"
        self.host = torch.empty(
            sum(self.sizes), dtype=torch.from_numpy(np.empty(0, self.wire)).dtype,
            pin_memory=pinned)
        self._host_np = self.host.numpy()
        self._out = None
        layout = tuple(zip(self.keys, self.shapes, self.sizes))

        def packed_run(buf):   # no reference to self: see _paragraph_step
            unpacked, ofs = {}, 0
            for k, shp, n in layout:
                unpacked[k] = buf[ofs: ofs + n].float().reshape((batch,) + shp)
                ofs += n
            pred, probs = serve(unpacked)
            return torch.cat([pred, probs], dim=1)

        self.fn = GraphedFunction(packed_run, device,
                                  name=name or f"packed predict, batch {batch}")

    def pack(self, samples: Sequence[Dict[str, np.ndarray]]) -> None:
        if len(samples) != self.batch:
            raise ValueError(f"{len(samples)} samples for a program of "
                             f"batch {self.batch}")
        ofs = 0
        for k, shp, n in zip(self.keys, self.shapes, self.sizes):
            view = self._host_np[ofs: ofs + n].reshape((self.batch,) + shp)
            for i, s in enumerate(samples):
                x = np.asarray(s[k])
                if x.shape != shp:
                    # the layout is fixed by the first sample; a different
                    # shape would unpack garbage
                    raise ValueError(
                        f"packed predict: sample[{k!r}] shape {x.shape} != "
                        f"{shp} from the first sample; use a predictor per "
                        "config/shape or predict_unpacked()")
                view[i] = x
            ofs += n

    def __call__(self, samples) -> np.ndarray:
        """(batch, E + E') float32: each sample's logits ++ probabilities."""
        self.pack(samples)
        out = self.fn(self.host)
        if self.device.type != "cuda":
            return out.numpy().copy()
        if self._out is None:
            self._out = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
        self._out.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out.numpy().copy()


def packed_layout(sample: Dict[str, np.ndarray]):
    """(keys, shapes) of a sample's packed layout: every key but the label,
    in the sample's order."""
    keys = tuple(k for k in sample if k != "label")
    return keys, tuple(tuple(np.asarray(sample[k]).shape) for k in keys)


class StreamingPredictor:
    """Batch-1 ensemble predictor.  One caller at a time: `predict` reuses
    one pinned staging buffer and one captured program."""

    def __init__(self, members: Sequence[torch.nn.Module],
                 offsets: Sequence[float], *, impl: str = "xla",
                 dtype: str = "float32", stacked_grid: bool = False,
                 wire_dtype: str = "float32"):
        """`wire_dtype`: the packed buffer's dtype, "float32" (lossless)
        or "float16" (half the bytes of the copy up, ~1e-3 relative
        rounding of the features; `packed_wire`)."""
        self.n_off = len(offsets)
        self.device = _device_of(members)
        self.wire = packed_wire(wire_dtype)
        self._run = ensemble_serve_fn(members, offsets, impl=impl, dtype=dtype,
                                      stacked=True if stacked_grid else None)
        self._packed = None

    def warmup(self, sample: Dict[str, np.ndarray]) -> None:
        """Capture both programs (unpacked and packed) for this layout."""
        self.predict_unpacked(sample)
        self.predict(sample)

    def _batch1(self, sample: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)[None]).to(self.device)
                for k, v in sample.items() if k != "label"}

    def packed_program(self, sample: Dict[str, np.ndarray]) -> PackedProgram:
        """The packed program, its layout fixed by the first sample."""
        if self._packed is None:
            keys, shapes = packed_layout(sample)
            self._packed = PackedProgram(self._run.fn, keys, shapes, 1,
                                         self.device, wire=self.wire,
                                         name="packed predict, batch 1")
        return self._packed

    def predict(self, sample: Dict[str, np.ndarray]):
        """Returns (raw ensemble logits (E,), calibrated probabilities (E',))
        through the packed path: one copy up, one program, one copy down."""
        out = self.packed_program(sample)([sample])[0]
        return out[: out.shape[0] - self.n_off], out[out.shape[0] - self.n_off:]

    def predict_unpacked(self, sample: Dict[str, np.ndarray]):
        """One transfer per array; kept for parity tests."""
        pred, probs = self._run(self._batch1(sample))
        return pred[0].cpu().numpy(), probs[0].cpu().numpy()

    def emotions(self, sample, names: Sequence[str]) -> Dict[str, float]:
        """emotion -> rounded calibrated probability (robot_demo.py:616-622)."""
        _, probs = self.predict(sample)
        return {n: round(float(p), 2) for n, p in zip(names, probs)}


def _paragraph_step(members, trans, weights, off, state, *, impl: str,
                    dtype: str, stacked=None):
    """The paragraph step: one clip batch (1, ...) -> blended logits ++
    probabilities (E + E',) on the device, the recurrence `state` (out,
    feats, started) advanced in place.  A closure that holds no reference
    to its predictor, so that its graph dies with the predictor."""
    keys = ParagraphStreamingPredictor._CLIP_KEYS
    n_off = off.shape[0]

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        _, batch = infer_cast(None, batch, dtype)
        outs = [m.clip(*(batch[k] for k in keys), impl=impl, stacked=stacked)
                for m in members]
        out_t1 = torch.stack([infer_upcast(o) for o, _ in outs])   # (k, 1, E)
        feats = torch.stack([infer_upcast(f) for _, f in outs])
        prev_out, prev_feats, started = state
        rec = state_transfer_recurrence(trans, prev_out, prev_feats, out_t1,
                                        feats)
        # first clip of a paragraph: out = out_t1 (the reference's t = 0)
        out = torch.where(started, rec, out_t1)
        pred = torch.einsum("k,kbe->be", weights, out)[0]           # (E,)
        probs = torch.sigmoid(pred[:n_off] - off)
        prev_out.copy_(out)
        prev_feats.copy_(feats)
        started.fill_(True)
        return torch.cat([pred, probs])

    return step


class ParagraphStreamingPredictor:
    """Stateful per-clip streaming for the recurrent `state_transfer` head
    (JAX serve/stream.py `ParagraphStreamingPredictor`).

    The reference's paragraph model (others/realformer.py:266-286) scores
    only complete p_len-clip windows.  Here each member's recurrence carry
    (out, feats) and the paragraph's `started` flag stay on the device
    between calls, in static tensors that the step (one captured graph on a
    CUDA device) reads and then overwrites in place; so a clip costs one
    grid forward per member plus the O(E²) gated recurrence, and clip t
    streamed equals column t of the whole-window logits.  `reset()` starts
    a new paragraph (the first clip's output is its own out_t1) by zeroing
    the state in place: the graph reads the tensors it captured, so they
    are never rebound.  `weights`: the per-member logit blend, uniform by
    default (the reference blends two of five members at 0.6/0.4,
    others/realformer.py:420).  One caller at a time."""

    _CLIP_KEYS = ("l", "v", "a", "l_mask", "v_mask", "a_mask")

    def __init__(self, members: Sequence[torch.nn.Module],
                 offsets: Sequence[float], *, weights=None,
                 impl: str = "xla", dtype: str = "float32",
                 stacked_grid: bool = False):
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
        # the recurrence state: (out, feats, started), updated in place
        self.state = (torch.zeros(self.k, 1, e, device=self.device),
                      torch.zeros(self.k, 1, e, device=self.device),
                      torch.zeros((), dtype=torch.bool, device=self.device))
        self.step = GraphedFunction(
            _paragraph_step(self.members, self.trans, self.weights, self.off,
                            self.state, impl=impl, dtype=dtype,
                            stacked=True if stacked_grid else None),
            self.device, name=f"paragraph step[{impl}]")

    def reset(self) -> None:
        """Start a new paragraph: the next clip is t = 0 (no carry)."""
        for t in self.state:
            t.zero_()

    def _clip1(self, clip: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(clip[k])[None])
                for k in self._CLIP_KEYS}

    def warmup(self, clip: Dict[str, np.ndarray]) -> None:
        """Capture the step: one clip through every member from a fresh
        paragraph; the state is left as it was."""
        saved = [t.clone() for t in self.state]
        self.reset()
        self.step(self._clip1(clip))
        for t, s in zip(self.state, saved):
            t.copy_(s)

    def push(self, clip: Dict[str, np.ndarray]):
        """Feed the next clip; returns (raw blended logits (E,), calibrated
        probabilities (E',)) in one copy from the device.  The state
        advances: call reset() between paragraphs."""
        out = self.step(self._clip1(clip)).cpu().numpy()
        return out[: out.shape[0] - self.n_off], out[out.shape[0] - self.n_off:]

    def emotions(self, clip, names: Sequence[str]) -> Dict[str, float]:
        _, probs = self.push(clip)
        return {n: round(float(p), 2) for n, p in zip(names, probs)}
