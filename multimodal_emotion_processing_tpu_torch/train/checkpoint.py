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

Not ported yet: asynchronous saves (`use_async`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import torch


def _params(model) -> Dict[str, torch.Tensor]:
    """A member's `state_dict()` as host tensors (the reference key names,
    so a reference `.pt` user loads it with `load_state_dict`)."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


class CheckpointStore:
    """Directory layout:
        <root>/manifest.json
        <root>/<name>/params.pt   (the member's state_dict)
        <root>/<name>/full.pt     (TrainState.state_dict() at its best epoch)
        <root>/<name>/last_a.pt, last_b.pt   (alternating resume points)
    The manifest keeps JAX's keys and meanings: `params`, `full`,
    `valid_loss`, `epoch`, `last`, `last_prev`, `done` and `imported`.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")
        self.manifest: Dict[str, Dict] = {}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)

    def _write_manifest(self) -> None:
        # save_last writes it every epoch: a cut mid-write must not leave
        # a truncated manifest that makes every checkpoint unreachable
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

    def save_best(self, name: str, state, epoch: int, valid_loss: float) -> None:
        """The member's parameters and full train state at a new best."""
        full = state.state_dict()
        self._save(self._path(name, "params"), full["model"])
        self._save(self._path(name, "full"), full)
        self.manifest.setdefault(name, {}).update({
            "params": self._path(name, "params"),
            "full": self._path(name, "full"),
            "valid_loss": float(valid_loss),
            "epoch": int(epoch),
        })
        self._write_manifest()

    def save_params(self, name: str, model, valid_loss: float = 0.0,
                    epoch: int = -1, *, imported: bool = True) -> None:
        """A parameters-only member (an `nn.Module` or its state dict):
        enough for ensembling and serving, with no train state.  Any
        train-state keys of an earlier member of that name are dropped, so
        the entry cannot point a restore at state that no longer matches
        the parameters."""
        sd = (_params(model) if isinstance(model, torch.nn.Module)
              else {k: v.detach().cpu() for k, v in model.items()})
        self._save(self._path(name, "params"), sd)
        entry = self.manifest.setdefault(name, {})
        for stale in ("full", "last", "last_prev", "done", "imported"):
            entry.pop(stale, None)
        entry.update({
            "params": self._path(name, "params"),
            "valid_loss": float(valid_loss),
            "epoch": int(epoch),
        })
        if imported:
            entry["imported"] = True
        self._write_manifest()

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
        member = self.manifest.get(name, {})
        good = next((e for e in (member.get("last"), member.get("last_prev"))
                     if e and os.path.isfile(e["path"])), None)
        slot = ("last_a" if good is None
                or not good["path"].endswith("last_a.pt") else "last_b")
        self._save(self._path(name, slot), state.state_dict())
        entry = self.manifest.setdefault(name, {})
        if good is not None:
            entry["last_prev"] = good
        entry["last"] = {
            "path": self._path(name, slot),
            "epoch": int(epoch),
            "schedule": schedule or {},
        }
        self._write_manifest()

    def restore_last(self, name: str, state_like):
        """(state_like with the newest complete resume point loaded into it,
        that point's manifest entry), or None where the member has none.
        Falls back to the previous epoch's slot when the newest save was
        cut short; a file that exists but does not fit `state_like` (a
        changed model config) raises instead of silently retraining."""
        member = self.manifest.get(name, {})
        for key in ("last", "last_prev"):
            entry = member.get(key)
            if not entry or not os.path.isfile(entry["path"]):
                continue
            sd = self._load(entry["path"])
            return state_like.load_state_dict(sd), entry
        return None

    def mark_done(self, name: str) -> None:
        self.manifest.setdefault(name, {})["done"] = True
        self._write_manifest()

    def is_done(self, name: str) -> bool:
        return bool(self.manifest.get(name, {}).get("done"))

    def restore_params(self, name: str, model=None):
        """The member's best parameters: loaded into `model` (strictly),
        which is returned, or as a host state dict when no model is given."""
        if model is None:
            return self._load(self.manifest[name]["params"])
        model.load_state_dict(self._load(self.manifest[name]["params"],
                                         next(model.parameters()).device))
        return model

    def restore_state(self, name: str, state_like):
        """state_like with the member's full train state at its best epoch
        loaded into it."""
        return state_like.load_state_dict(
            self._load(self.manifest[name]["full"]))

    def best_members(self, prefix: str = "") -> List[str]:
        """Member names `<prefix>_<int>` carrying best parameters, in member
        order (numeric: 10 sorts after 2).  The exact suffix keeps sibling
        artifacts out of the ensemble, such as `<prefix>_sweep_winner` or
        the `<prefix>_s256_*` members of a scale preset sharing the store.
        prefix="" lists every member with parameters, by name."""
        if not prefix:
            return sorted(n for n, e in self.manifest.items()
                          if "params" in e)
        pat = re.compile(re.escape(prefix) + r"_(\d+)$")
        hits = [(int(m.group(1)), n) for n, e in self.manifest.items()
                if "params" in e and (m := pat.match(n))]
        return [n for _, n in sorted(hits)]
