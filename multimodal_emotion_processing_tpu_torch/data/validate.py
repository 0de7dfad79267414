"""Corpus-tree validation (data/validate.py of the JAX package): what a
data root lacks, reported before training fails on it.

The reference scripts hard-code their corpus paths and fail with a bare
IOError partway through (cmu-mosei/run.py:21-25, Ren-MME/run.py:18-23,
robot_demo.py:21-29).  `check-data <config> --data-root R` gives one
report instead: every file and directory the config reads, whether it is
usable, the corpus counts (label rows, .csd sentences, .npy files) and the
cross-checks such as the share of labelled sentences that have features.
Nothing here raises on a bad tree: every problem is collected, so one run
reports them all.
"""

from __future__ import annotations

import os
from typing import Dict, List

from .. import configs as _cfg
from .mosei_folds import EXTRACT_COMMAND
from .rencecps import SKIP_DOCS


def _entry(report: Dict, key: str, ok: bool, detail: str) -> None:
    report["checks"][key] = {"ok": bool(ok), "detail": detail}
    if not ok:
        report["problems"].append(f"{key}: {detail}")


def _check_dir(report: Dict, key: str, path: str, suffix: str,
               minimum: int = 1) -> List[str]:
    if not os.path.isdir(path):
        _entry(report, key, False, f"directory missing: {path}")
        return []
    names = [f for f in os.listdir(path) if f.endswith(suffix)]
    _entry(report, key, len(names) >= minimum,
           f"{len(names)} {suffix} files in {path}")
    return names


def _check_csd(report: Dict, key: str, path: str) -> set:
    """Open a computational sequence and count its sentences, in any of
    the layouts `CsdSource` accepts."""
    from .sources import CsdSource

    if not os.path.isfile(path):
        _entry(report, key, False, f"file missing: {path}")
        return set()
    try:
        with CsdSource(path) as src:
            names = set(src.names())
        _entry(report, key, len(names) > 0, f"{len(names)} sentences")
        return names
    except Exception as e:
        _entry(report, key, False, f"unreadable ({type(e).__name__}: {e})")
        return set()


def _coverage(report: Dict, key: str, wanted, have: set, what: str,
              threshold: float = 0.99) -> None:
    """The share of `wanted` ids present in `have` (a feature source)."""
    wanted = list(wanted)
    if not wanted or not have:
        return  # the check of the empty side already reported it
    hit = sum(1 for n in wanted if n in have)
    frac = hit / len(wanted)
    _entry(report, key, frac >= threshold,
           f"{hit}/{len(wanted)} {what} present ({frac:.1%})")


def validate_tree(config_name: str, data_root: str) -> Dict:
    """{"config", "data_root", "ok", "checks": {key: {ok, detail}},
    "problems": [str]} for the layout `pipelines.load_real_data` reads for
    the config's family (docs/REAL_DATA.md)."""
    name = _cfg.family(config_name)
    report: Dict = {"config": config_name, "data_root": data_root,
                    "checks": {}, "problems": []}
    if not os.path.isdir(data_root):
        _entry(report, "data_root", False, f"not a directory: {data_root}")
        report["ok"] = False
        return report
    _entry(report, "data_root", True, data_root)

    if name in ("mosei_trans", "mosei_realformer"):
        labels = os.path.join(data_root, "labels.txt")
        label_names: List[str] = []
        if not os.path.isfile(labels):
            _entry(report, "labels.txt", False, f"file missing: {labels}")
        else:
            try:
                from .mosei import parse_labels

                tr, te, ldict = parse_labels(labels, test_videos=set())
                label_names = list(ldict)
                _entry(report, "labels.txt", len(ldict) > 0,
                       f"{len(ldict)} labeled sentences, "
                       f"{len(tr) + len(te)} (prev, cur) pairs")
            except Exception as e:
                _entry(report, "labels.txt", False,
                       f"unparseable ({type(e).__name__}: {e})")
        for key, fname in (("text.csd", "glove_vectors.csd"),
                           ("video.csd", "FACET 4.2.csd"),
                           ("audio.csd", "COAVAREP.csd")):
            have = _check_csd(report, key, os.path.join(data_root, fname))
            _coverage(report, f"{key}.coverage", label_names[:500], have,
                      "labeled sentences (first 500)")
        if name == "mosei_realformer":
            _check_csd(report, "All Labels.csd",
                       os.path.join(data_root, "All Labels.csd"))
        fold = os.path.join(data_root, "standard_test_fold.txt")
        if os.path.isfile(fold):
            with open(fold) as f:
                n = sum(1 for ln in f if ln.strip() and not ln.startswith("#"))
            _entry(report, "standard_test_fold", n > 0,
                   f"{n} test videos in {fold}")
        else:
            try:
                import mmsdk  # noqa: F401
                _entry(report, "standard_test_fold", True,
                       "file absent; mmsdk importable (fallback)")
            except ImportError:
                _entry(report, "standard_test_fold", False,
                       f"{fold} missing and mmsdk not importable — create "
                       f"it once via {EXTRACT_COMMAND}")

    elif name == "rencecps":
        txts = _check_dir(report, "txt_dir",
                          os.path.join(data_root,
                                       "1487_txt_hier_sents_202002"), ".txt")
        _check_dir(report, "xml_dir",
                   os.path.join(data_root, "1487_xml_doc_segmented_utf8"),
                   ".xml")
        _check_dir(report, "bert_features",
                   os.path.join(data_root, "ren_text_feat"), ".npy")
        if txts:
            present = {int(f[4:-4]) for f in txts
                       if f.startswith("cet_") and f[4:-4].isdigit()}
            missing = [d for d in range(1, 1488)
                       if d not in present and d not in SKIP_DOCS]
            _entry(report, "doc_range", len(missing) == 0,
                   "cet_1..cet_1487 complete (490/761 skipped by the "
                   "reference)" if not missing else
                   f"{len(missing)} docs missing, first: {missing[:10]}")

    elif name == "ren_mme":
        csv = os.path.join(data_root, "data", "zero_one_adjust.csv")
        names: List[str] = []
        if not os.path.isfile(csv):
            _entry(report, "label_csv", False, f"file missing: {csv}")
        else:
            try:
                from .ren_mme import load_label_table

                train, test = load_label_table(csv)
                names = [r[0] for r in train] + [r[0] for r in test]
                _entry(report, "label_csv", len(train) > 0 and len(test) > 0,
                       f"{len(train)} train / {len(test)} test rows "
                       "(episodes 9,10 = test)")
            except Exception as e:
                _entry(report, "label_csv", False,
                       f"unparseable ({type(e).__name__}: {e})")
        for key, sub in (("text_feat", "text_feat"),
                         ("video_feat", "video_feat"),
                         ("audio_feat", "audio_feat")):
            files = _check_dir(report, key, os.path.join(data_root, sub),
                               ".npy")
            have = {f[:-4] for f in files}
            # video may have holes: the fallback chain (Ren-MME/run.py:
            # 79-91) fills them, so its coverage is reported, never failed
            if key == "video_feat":
                if names and have:
                    hit = sum(1 for n in names[:500] if n in have)
                    _entry(report, f"{key}.coverage", True,
                           f"{hit}/{min(len(names), 500)} labeled clips "
                           "present (holes use the name->prev->next->"
                           "prev-prev->zeros fallback chain)")
            else:
                _coverage(report, f"{key}.coverage", names[:500], have,
                          "labeled clips (first 500)")

    elif name == "robot_demo":
        pks = _check_dir(report, "video_pickles",
                         os.path.join(data_root, "Feature(0)-360"), ".pk")
        clip_names = [f.split(".pk")[0] for f in pks]
        labels = os.path.join(data_root, "labels.txt")
        if not os.path.isfile(labels):
            _entry(report, "labels.txt", False, f"file missing: {labels}")
        elif clip_names:
            with open(labels) as f:
                keyed = {ln.split(",")[0] for ln in f.readlines()[1:]}
            _coverage(report, "labels.coverage", clip_names, keyed,
                      "video clips labeled")
        wavs = _check_dir(report, "audio_features",
                          os.path.join(data_root, "WAV_feature"), ".npy")
        _coverage(report, "audio.coverage", clip_names,
                  {f[:-4] for f in wavs}, "video clips with audio")
        _check_dir(report, "ren_text_features",
                   os.path.join(data_root, "ren_text_feat"), ".npy")
        _check_dir(report, "ren_txt_dir",
                   os.path.join(data_root, "1487_txt_hier_sents_202002"),
                   ".txt")
        _check_dir(report, "ren_xml_dir",
                   os.path.join(data_root, "1487_xml_doc_segmented_utf8"),
                   ".xml")
    else:
        _entry(report, "config", False, f"unknown data family {name!r}")

    report["ok"] = not report["problems"]
    return report
