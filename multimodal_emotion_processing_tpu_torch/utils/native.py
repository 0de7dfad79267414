"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with `nvcc` into a shared library under the package's `_build/` directory,
named by the hash of its source and of the shared headers `csrc/*.cuh`, so
an edited source or header is rebuilt and an unchanged one is loaded as is.  The library is opened with `ctypes`; no
PyTorch headers are compiled, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Dict]:
    """Compile every named source that has no library for its current hash,
    one `nvcc` process per source, all started together.  Returns, per
    name, the library's `path`, the `seconds` its build took (0.0 when it
    was already built) and the compiler's resource report `ptxas`: its
    lines per kernel function (the entry's name, then its stack frame and
    spills, then its registers)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: {"path": _target(n), "seconds": 0.0, "ptxas": "cached"}
           for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        if out[n]["path"].exists():
            continue
        tmp = out[n]["path"].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{log}")
        os.replace(tmp, out[n]["path"])
        out[n]["seconds"] = time.perf_counter() - t0
        out[n]["ptxas"] = "\n".join(line for line in log.splitlines()
                                    if "ptxas" in line or "spill" in line)
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]["path"]))
            _loaded[name] = lib
        return lib
