"""Feature sources (data/sources.py of the JAX package): where the raw
per-sentence feature sequences come from.

The reference reads CMU MultimodalSDK `.csd` HDF5 files (cmu-mosei/
run.py:45-46) and loose `.npy` / `.pk` trees.  Every source here has one
interface, so the pair and paragraph assemblers work alike over `.csd`
files and `.npy` directories.

`CsdSource` imports h5py when it is built, never at import: the package
imports without h5py, and only the MOSEI corpora need it.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np


class FeatureSource:
    """get(name) -> the raw (length, dim) float sequence of one sentence."""

    def get(self, name: str) -> np.ndarray:
        raise NotImplementedError

    def __contains__(self, name: str) -> bool:
        raise NotImplementedError

    def names(self) -> Iterable[str]:
        raise NotImplementedError


class CsdSource(FeatureSource):
    """A CMU MultimodalSDK computational sequence (.csd, HDF5): one group
    per sentence id with a 'features' dataset (cmu-mosei/run.py:170:
    data[name]["features"][:]).  Also a context manager that closes the
    file."""

    def __init__(self, path: str):
        import h5py  # only the MOSEI corpora need it

        self._f = h5py.File(path, "r")
        # mmsdk's layout: ONE top-level group named after the sequence,
        # holding "data" (per-sentence groups with "features" and
        # "intervals") and "metadata".  Also accepted: a top-level "data"
        # group, several top-level groups (the one that has "data" wins,
        # "metadata" is skipped), and sentence nodes that are bare datasets
        if "data" in self._f and hasattr(self._f["data"], "keys"):
            root = "data"
        else:
            tops = [k for k in self._f.keys() if k != "metadata"]
            if not tops:
                raise ValueError(f"{path}: no computational-sequence "
                                 "group found (only 'metadata')")
            top = next((k for k in tops if "data" in self._f[k]), tops[0])
            root = f"{top}/data" if "data" in self._f[top] else top
        self._data = self._f[root]

    def get(self, name):
        node = self._data[name]
        # mmsdk group layout <sid>/{features,intervals}; the reference never
        # reads the intervals
        if hasattr(node, "keys"):
            node = node["features"]
        return np.asarray(node[:], dtype=np.float32)

    def __contains__(self, name):
        return name in self._data

    def names(self):
        return self._data.keys()

    def close(self):
        """Release the HDF5 handle; safe to call twice."""
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NpyDirSource(FeatureSource):
    """A directory of per-sentence .npy files (the Ren-MME, Ren-CECps and
    robot layouts).  `transpose` reads files stored (dim, T), as Ren-MME's
    audio is.  `names()` is in `os.listdir` order, as the reference's is."""

    def __init__(self, dirpath: str, *, transpose: bool = False):
        self.dir = dirpath
        self.transpose = transpose

    def _path(self, name):
        return os.path.join(self.dir, name + ".npy")

    def get(self, name):
        x = np.load(self._path(name))
        if self.transpose:
            x = np.transpose(x)
        return np.asarray(x, dtype=np.float32)

    def __contains__(self, name):
        return os.path.exists(self._path(name))

    def names(self):
        for fn in os.listdir(self.dir):
            if fn.endswith(".npy"):
                yield fn[:-4]
