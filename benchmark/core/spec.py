"""The manifest (`BENCHMARK.json`) and the files each cell is found by."""

from __future__ import annotations

import importlib.util
import json
import sys
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                      # the checkout


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of benchmark/<folder>/ from a file of any name (a metric's
    file carries the metric's dots), inside that folder's package, so
    that its relative imports resolve."""
    name = f"benchmark.{path.parent.name}.{path.stem.replace('.', '_')}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of the manifest's `workloads` with everything it names:
    its configuration file, its traffic mix and that mix's driver, its
    limits, and the metrics it reports."""

    def __init__(self, name: str, doc: dict = None):
        doc = doc or manifest()
        cells = {w["name"]: w for w in doc["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; the "
                           f"workloads are {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in doc["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(ROOT / self.config_entry["file"])
        self.traffic = _json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = self._metrics(doc["end_to_end"])
        self.per_layer = self._metrics(doc["per_layer"])

    def _metrics(self, entries: List[dict]) -> List[dict]:
        return [m for m in entries
                if "workloads" not in m or self.name in m["workloads"]]

    def driver(self):
        return load_module(HERE / "drivers" / f"{self.traffic['driver']}.py")

    @staticmethod
    def reader(metric: str):
        """`metrics/<metric>.py` where a metric's arithmetic is its own,
        else its family's reader, `metrics/<family>.py`, the family being
        the name before the first dot (`idle_share.train` reads with
        `idle_share.py`)."""
        own = HERE / "metrics" / f"{metric}.py"
        if own.exists():
            return load_module(own)
        return load_module(HERE / "metrics" / f"{metric.split('.')[0]}.py")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (`tag`) of a run's `--seed`: the same
    seed gives the same inputs, and each purpose draws its own stream."""
    ss = np.random.SeedSequence(entropy=int(seed) & ((1 << 128) - 1),
                                spawn_key=(zlib.crc32(tag.encode()),))
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def metric_units(entries: List[dict]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in entries}
