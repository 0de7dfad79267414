"""Checkpoints: `torch.save` files with a JSON manifest (train/checkpoint.py
of the JAX package, whose Orbax trees become files here).

The reference saves best-only model weights to loss-tagged filenames
(`{name}_{str(valid_loss)[:4]}.pt`, cmu-mosei/run.py:415) and reloads them
by hard-coded names (cmu-mosei/run.py:446-453); it never saves the
optimizer and cannot resume.  Here each member saves its best parameters
(for ensembling and serving), its full train state at that epoch, and an
every-epoch resume point, and a manifest records the paths, the best
valid loss and epoch, so ensembles reload by member name.

Every file is written to a temporary name and moved into place with
`os.replace`, so a file that exists is a complete save: the resume slots
rely on that, as the JAX store relies on Orbax's atomic commit.

With `use_async=True` the copy of the state to the host stays inline, and
the writes (`torch.save` to the temporary name, `os.replace`) and then the
save's manifest entry run on one worker thread, in order, overlapping the
next epoch.  So a cut at any point leaves what the synchronous store
would: the previous complete files and the manifest entry that names
them, or the new ones.  A save joins the save in flight of its own kind
(a resume point before it picks its slot, a best member before it
replaces params.pt and full.pt); every restore joins all; `wait()` joins
all and raises a failed write.
"""

from __future__ import annotations

import json
import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch


def _params(model) -> Dict[str, torch.Tensor]:
    """A member's `state_dict()` as host tensors (the reference key names,
    so a reference `.pt` user loads it with `load_state_dict`)."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _owned(obj):
    """`obj` with every tensor cloned: on the CPU `.cpu()` returns the live
    tensor itself, which the next step would change under a write still in
    flight."""
    if torch.is_tensor(obj):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _owned(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_owned(v) for v in obj)
    return obj


class CheckpointStore:
    """Directory layout:
        <root>/manifest.json
        <root>/<name>/params.pt   (the member's state_dict)
        <root>/<name>/full.pt     (TrainState.state_dict() at its best epoch)
        <root>/<name>/last_a.pt, last_b.pt   (alternating resume points)
    The manifest keeps JAX's keys and meanings: `params`, `full`,
    `valid_loss`, `epoch`, `last`, `last_prev`, `done` and `imported`.
    """

    def __init__(self, root: str, *, use_async: bool = False):
        self.root = root
        self.use_async = use_async
        self._worker: Optional[ThreadPoolExecutor] = None
        self._pending: Dict[str, Future] = {}   # "best" / "last" in flight
        self._lock = threading.RLock()   # the manifest, shared with the worker
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")
        self.manifest: Dict[str, Dict] = {}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)

    def _write_manifest(self) -> None:
        # save_last writes it every epoch: a cut mid-write must not leave
        # a truncated manifest that makes every checkpoint unreachable
        with self._lock:
            tmp = self._manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.manifest, f, indent=2)
            os.replace(tmp, self._manifest_path)

    def _path(self, name: str, kind: str) -> str:
        return os.path.abspath(os.path.join(self.root, name, f"{kind}.pt"))

    @staticmethod
    def _save(path: str, obj) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)

    @staticmethod
    def _load(path: str, map_location=None):
        return torch.load(path, map_location=map_location, weights_only=True)

    def wait(self) -> None:
        """Block until every save in flight has landed; a failed write
        raises here."""
        for kind in list(self._pending):
            self._join(kind)

    def _join(self, kind: str) -> None:
        pending = self._pending.pop(kind, None)
        if pending is not None:
            pending.result()

    def _commit(self, kind: str, files, on_cpu: bool, entry) -> None:
        """Save each (path, obj), then apply `entry(manifest)` and write
        the manifest: inline, or with `use_async` on the worker, so the
        manifest names a file only once it has landed."""

        def commit():
            for path, obj in files:
                self._save(path, obj)
            with self._lock:
                entry(self.manifest)
                self._write_manifest()

        if not self.use_async:
            commit()
            return
        if on_cpu:
            files = [(path, _owned(obj)) for path, obj in files]
        if self._worker is None:
            self._worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mep-torch-checkpoint")
        self._pending[kind] = self._worker.submit(commit)

    @staticmethod
    def _on_cpu(model) -> bool:
        return next(model.parameters()).device.type == "cpu"

    def save_best(self, name: str, state, epoch: int, valid_loss: float) -> None:
        """The member's parameters and full train state at a new best."""
        self._join("best")
        full = state.state_dict()
        params, full_path = self._path(name, "params"), self._path(name, "full")

        def entry(manifest):
            manifest.setdefault(name, {}).update({
                "params": params, "full": full_path,
                "valid_loss": float(valid_loss), "epoch": int(epoch)})

        self._commit("best", [(params, full["model"]), (full_path, full)],
                     self._on_cpu(state.model), entry)

    def save_params(self, name: str, model, valid_loss: float = 0.0,
                    epoch: int = -1, *, imported: bool = True) -> None:
        """A parameters-only member (an `nn.Module` or its state dict):
        enough for ensembling and serving, with no train state.  Any
        train-state keys of an earlier member of that name are dropped, so
        the entry cannot point a restore at state that no longer matches
        the parameters."""
        self._join("best")
        sd = (_params(model) if isinstance(model, torch.nn.Module)
              else {k: v.detach().cpu() for k, v in model.items()})
        params = self._path(name, "params")

        def entry(manifest):
            member = manifest.setdefault(name, {})
            for stale in ("full", "last", "last_prev", "done", "imported"):
                member.pop(stale, None)
            member.update({"params": params, "valid_loss": float(valid_loss),
                           "epoch": int(epoch)})
            if imported:
                member["imported"] = True

        self._commit("best", [(params, sd)], True, entry)

    def save_last(self, name: str, state, epoch: int,
                  schedule: Optional[Dict] = None) -> None:
        """Every-epoch resume point: the full train state and the host-side
        schedule (plateau LR controller and early-stop counters).

        Crash-safe by alternating slots: epochs write `last_a` and `last_b`
        in turn and the manifest keeps the previous entry as `last_prev`,
        so a cut during a save always leaves one complete resume point,
        which `restore_last` falls back to.  The slot to write is chosen
        against the newest entry whose file exists: after a fallback resume
        (the manifest's `last` lost mid-save) the next save must not
        overwrite the surviving slot."""
        self._join("last")
        with self._lock:
            member = self.manifest.get(name, {})
            good = next((e for e in (member.get("last"),
                                     member.get("last_prev"))
                         if e and os.path.isfile(e["path"])), None)
        slot = ("last_a" if good is None
                or not good["path"].endswith("last_a.pt") else "last_b")
        path = self._path(name, slot)

        def entry(manifest):
            member = manifest.setdefault(name, {})
            if good is not None:
                member["last_prev"] = good
            member["last"] = {"path": path, "epoch": int(epoch),
                              "schedule": schedule or {}}

        self._commit("last", [(path, state.state_dict())],
                     self._on_cpu(state.model), entry)

    def restore_last(self, name: str, state_like, epoch: Optional[int] = None):
        """(state_like with the newest complete resume point loaded into it,
        that point's manifest entry), or None where the member has none.
        Falls back to the previous epoch's slot when the newest save was
        cut short; a file that exists but does not fit `state_like` (a
        changed model config) raises instead of silently retraining.  With
        `epoch`, the complete point of that epoch, or None (a lockstep
        driver resumes all its members from one epoch)."""
        self.wait()
        member = self.manifest.get(name, {})
        for key in ("last", "last_prev"):
            entry = member.get(key)
            if not entry or not os.path.isfile(entry["path"]):
                continue
            if epoch is not None and entry["epoch"] != epoch:
                continue
            sd = self._load(entry["path"])
            return state_like.load_state_dict(sd), entry
        return None

    def last_epochs(self, name: str) -> List[int]:
        """The epochs of the member's complete resume points, newest first."""
        member = self.manifest.get(name, {})
        return [e["epoch"] for e in (member.get("last"), member.get("last_prev"))
                if e and os.path.isfile(e["path"])]

    def mark_done(self, name: str) -> None:
        """Record the member as finished, once its saves have landed."""
        self.wait()
        with self._lock:
            self.manifest.setdefault(name, {})["done"] = True
            self._write_manifest()

    def is_done(self, name: str) -> bool:
        with self._lock:
            return bool(self.manifest.get(name, {}).get("done"))

    def restore_params(self, name: str, model=None):
        """The member's best parameters: loaded into `model` (strictly),
        which is returned, or as a host state dict when no model is given."""
        self.wait()
        if model is None:
            return self._load(self.manifest[name]["params"])
        model.load_state_dict(self._load(self.manifest[name]["params"],
                                         next(model.parameters()).device))
        return model

    def restore_state(self, name: str, state_like):
        """state_like with the member's full train state at its best epoch
        loaded into it."""
        self.wait()
        return state_like.load_state_dict(
            self._load(self.manifest[name]["full"]))

    def best_members(self, prefix: str = "") -> List[str]:
        """Member names `<prefix>_<int>` carrying best parameters, in member
        order (numeric: 10 sorts after 2).  The exact suffix keeps sibling
        artifacts out of the ensemble, such as `<prefix>_sweep_winner` or
        the `<prefix>_s256_*` members of a scale preset sharing the store.
        prefix="" lists every member with parameters, by name."""
        with self._lock:
            entries = list(self.manifest.items())
        if not prefix:
            return sorted(n for n, e in entries if "params" in e)
        pat = re.compile(re.escape(prefix) + r"_(\d+)$")
        hits = [(int(m.group(1)), n) for n, e in entries
                if "params" in e and (m := pat.match(n))]
        return [n for _, n in sorted(hits)]
