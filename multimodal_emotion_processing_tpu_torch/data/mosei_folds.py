"""CMU-MOSEI's standard test fold (data/mosei_folds.py of the JAX package).

The reference takes the standard test-fold video list from the CMU
MultimodalSDK (`mmsdk.mmdatasdk.cmu_mosei.standard_folds.standard_test_fold`,
cmu-mosei/run.py:47-54).  Here it is resolved without needing mmsdk, in
this order:

  1. an explicit iterable passed by the caller;
  2. a plain-text `standard_test_fold.txt` in the corpus root (one video id
     per line, '#' comments allowed; docs/REAL_DATA.md);
  3. the mmsdk constant, if mmsdk is installed;
  4. an error that says how to provide it.

`extract_fold_file()` writes the file from mmsdk once:
`python -m multimodal_emotion_processing_tpu_torch.data.mosei_folds <root>`.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Set

FOLD_FILENAME = "standard_test_fold.txt"
EXTRACT_COMMAND = ("python -m "
                   "multimodal_emotion_processing_tpu_torch.data.mosei_folds")


def _read_fold_file(path: str) -> Set[str]:
    out = set()
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


def _mmsdk_fold() -> Optional[Set[str]]:
    try:
        from mmsdk import mmdatasdk  # optional, never required
    except ImportError:
        return None
    return set(mmdatasdk.cmu_mosei.standard_folds.standard_test_fold)


def standard_test_fold(
    data_root: Optional[str] = None,
    *,
    explicit: Optional[Iterable[str]] = None,
) -> Set[str]:
    """The CMU-MOSEI standard test fold's video ids."""
    if explicit is not None:
        return set(explicit)
    if data_root is not None:
        path = os.path.join(data_root, FOLD_FILENAME)
        if os.path.exists(path):
            return _read_fold_file(path)
    fold = _mmsdk_fold()
    if fold is not None:
        return fold
    where = (f"{os.path.join(data_root, FOLD_FILENAME)!r}" if data_root
             else f"a {FOLD_FILENAME!r} file in the corpus root")
    raise FileNotFoundError(
        f"CMU-MOSEI standard test fold not found: provide {where} (one video "
        "id per line), or install mmsdk, or pass explicit=[...].  To create "
        f"the file once from an mmsdk install: {EXTRACT_COMMAND} <data_root>")


def extract_fold_file(data_root: str) -> str:
    """Write `standard_test_fold.txt` into `data_root` from mmsdk, once."""
    fold = _mmsdk_fold()
    if fold is None:
        raise ImportError("mmsdk is required (once) to extract the fold file")
    path = os.path.join(data_root, FOLD_FILENAME)
    with open(path, "w") as f:
        f.write("# CMU-MOSEI standard test fold (mmsdk.mmdatasdk.cmu_mosei."
                "standard_folds.standard_test_fold)\n")
        for name in sorted(fold):
            f.write(name + "\n")
    return path


if __name__ == "__main__":
    import sys

    print(extract_fold_file(sys.argv[1]))
