"""End-to-end pipelines (pipelines.py of the JAX package): each reference
script becomes one function call over the shared engine: data, k-fold
bagged training with best-member checkpoints, reloading the best members,
ensemble inference, the threshold decision and the metric report
(`run_experiment`); and offline batch prediction from a checkpoint store
to a file (`run_predict`).

Both run in two data modes, on the card unless `device="cpu"` is given:
  * synthetic samples shaped as the real corpora are (the default; the
    corpora are not distributable);
  * a real corpus tree at `data_root` (`load_real_data`: data/mosei.py,
    rencecps.py, ren_mme.py and robot.py over the reference's layouts,
    docs/REAL_DATA.md), with `synthetic_data=False`.

Both take a wire format for the batches' copies to the card
(`transfer_dtype`: float16, bfloat16 or int8, data/loader.cast_for_transfer),
and `run_experiment` an asynchronous checkpoint store (`async_checkpoint`).

`run_experiment` picks its k-fold driver by JAX's rules: the members one
after another (train/kfold.py, with `scan_steps` and `accum_steps`; the
default, where JAX's is the lockstep), or with `vmap_folds` in lockstep
(train/vmap_kfold.py; host-fed, or with `device_resident` over data
staged on the card, or with `one_dispatch` every epoch launched without
a host round trip).
`run_lr_sweep_experiment` trains learning-rate candidates together on
fold 0's split (train/sweep.py); `run_predict(device_resident=True)`
scores a split staged on the card (`Ensemble.predict_all_staged`).

`run_experiment(dp=, tp=)` trains on a ('data', 'model') mesh over every
rank of the world (parallel/mesh.py; one process per card under torchrun,
or a world of one rank made for the call) with whichever driver the rules
pick, the lockstep, device-resident and one-dispatch ones included, and
scores on the same mesh's data axis where the batch divides it;
`run_predict(dp=)` shards batch inference (`Ensemble(mesh=)`).  Rank 0
alone writes the store, the run's files, the predictions and the log.
`impl="cp"` runs under `ensure_cp` (ops/context_parallel.py).
`run_predict(stacked=True)` scores on the stacked RealFormer grid
(models/grid.py), with or without `dp`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import platform
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import configs
from .data import mosei, ren_mme, rencecps, robot, synthetic
from .data.loader import Batcher
from .data.mosei_folds import standard_test_fold
from .data.sources import CsdSource, NpyDirSource
from .eval.ensemble import (Ensemble, group_average, joint_threshold_grid,
                            realformer_threshold_grid, ren_mme_joint_grids,
                            robot_threshold_grid, threshold_sweep)
from .eval.report import evaluate, format_report
from .models import build_model
from .ops.context_parallel import ensure_cp
from .parallel.mesh import (WholeState, is_rank0, make_mesh, world,
                            world_size)
from .train.checkpoint import CheckpointStore
from .train.kfold import contiguous_folds, run_kfold
from .train.sweep import run_lr_sweep
from .train.vmap_kfold import run_kfold_fully_compiled, run_kfold_vmapped
from .utils.device import resolve_device
from .utils.logging import RunLogger


def _log(msg, quiet=False):
    if not quiet:
        print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class PipelineResult:
    config_name: str
    fold_histories: List
    report: Optional[Dict]
    sweep: Optional[Dict]
    store: Optional[CheckpointStore]
    # the ensemble's test logits and labels as scored: crop pairs averaged,
    # paragraph clips flattened
    logits: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    # what a lockstep driver measured: the staging's seconds and bytes,
    # and for one-dispatch the epochs launched and the masked ones
    driver_stats: Dict = dataclasses.field(default_factory=dict)


def _synthetic_data(exp, n_train: int, n_test: int, seed: int = 0):
    train = synthetic.synthetic_dataset(exp.name, exp.model, n_train, seed)
    test = synthetic.synthetic_dataset(exp.name, exp.model, n_test, seed + 1)
    return train, test


def load_real_data(exp, data_root: str):
    """Train and test sample lists from a real corpus tree, laid out as the
    reference's scripts read it (docs/REAL_DATA.md).  Returns (train, test,
    ctx): `mosei_trans`' train list holds pair units (lists of one or two
    crop samples; its folds count pairs) and its test samples carry crop
    `group` ids; robot_demo has no test split, its samples carry
    `name_idx`, and ctx holds the assembler, the label table and the clip
    names for the per-epoch text substitution; ctx is None otherwise."""
    name = configs.family(exp.name)  # scaled presets read their family's corpus
    m = exp.model
    if name in ("mosei_trans", "mosei_realformer"):
        with contextlib.ExitStack() as stack:  # the HDF5 files close on return
            l_src = stack.enter_context(
                CsdSource(os.path.join(data_root, "glove_vectors.csd")))
            v_src = stack.enter_context(
                CsdSource(os.path.join(data_root, "FACET 4.2.csd")))
            a_src = stack.enter_context(
                CsdSource(os.path.join(data_root, "COAVAREP.csd")))
            test_fold = standard_test_fold(data_root)
            if name == "mosei_trans":
                train_pairs, test_pairs, labels = mosei.parse_labels(
                    os.path.join(data_root, "labels.txt"),
                    test_videos=test_fold)
                asm = mosei.PairSampleAssembler(m, l_src, v_src, a_src, labels)
                return (asm.materialize_units(train_pairs),
                        asm.materialize(test_pairs), None)
            label_src = stack.enter_context(
                CsdSource(os.path.join(data_root, "All Labels.csd")))
            videos = sorted({n.split("[")[0] for n in v_src.names()})
            train_v = [v for v in videos if v not in test_fold]
            test_v = [v for v in videos if v in test_fold]
            present = set(v_src.names())
            asm = mosei.ParagraphSampleAssembler(m, l_src, v_src, a_src,
                                                 label_src)
            return (asm.materialize(
                        mosei.paragraph_windows(train_v, present, m.p_len)),
                    asm.materialize(
                        mosei.paragraph_windows(test_v, present, m.p_len)),
                    None)
    if name == "rencecps":
        txt = os.path.join(data_root, "1487_txt_hier_sents_202002")
        xml = os.path.join(data_root, "1487_xml_doc_segmented_utf8")
        feat = NpyDirSource(os.path.join(data_root, "ren_text_feat"))
        asm = rencecps.RenCecpsAssembler(feat, dim=m.l_dim)
        return (asm.materialize(rencecps.pair_list(
                    rencecps.load_split(txt, xml, "train"))),
                asm.materialize(rencecps.pair_list(
                    rencecps.load_split(txt, xml, "test"))),
                None)
    if name == "ren_mme":
        train, test = ren_mme.load_label_table(
            os.path.join(data_root, "data", "zero_one_adjust.csv"))
        asm = ren_mme.RenMmeAssembler(
            m,
            NpyDirSource(os.path.join(data_root, "text_feat")),
            NpyDirSource(os.path.join(data_root, "video_feat")),
            NpyDirSource(os.path.join(data_root, "audio_feat"), transpose=True),
        )
        return asm.materialize(train), asm.materialize(test), None
    if name == "robot_demo":
        video_dir = os.path.join(data_root, "Feature(0)-360")
        # os.listdir order, as the reference's: it decides the folds
        names = [f.split(".pk")[0] for f in os.listdir(video_dir)
                 if f.endswith(".pk")]
        label_dict = {}
        name_set = set(names)
        with open(os.path.join(data_root, "labels.txt")) as f:
            for line in f.readlines()[1:]:
                key = line.split(",")[0]
                if key in name_set:
                    label_dict[key] = line.strip().split(",")[3:]
        table = robot.ren_label_name_dict(
            os.path.join(data_root, "1487_txt_hier_sents_202002"),
            os.path.join(data_root, "1487_xml_doc_segmented_utf8"))
        asm = robot.RobotAssembler(
            m, video_dir,
            NpyDirSource(os.path.join(data_root, "WAV_feature")),
            NpyDirSource(os.path.join(data_root, "ren_text_feat")),
            label_dict, robot.SubstitutionSampler(table))
        samples = asm.materialize(names)
        # each sample's clip index rides along, so a fold's loader can
        # substitute its texts anew each epoch (robot_demo.py:256-258)
        for i, s in enumerate(samples):
            s["name_idx"] = np.asarray(i, np.int32)
        ctx = {"assembler": asm, "table": table, "names": names}
        return samples, [], ctx
    raise ValueError(name)


def _count_samples(units) -> int:
    return sum(len(u) if isinstance(u, list) else 1 for u in units)


def _write_run_meta(dirs, *, config_name, overrides, exp, drivers, data,
                    device):
    """Write `run_meta.json` into every artifact directory of a run: the
    resolved config (every hyperparameter, after the overrides), the
    driver knobs, the data mode and the environment (torch, CUDA, the
    device), enough to reproduce or audit the run from its artifacts."""
    if not dirs:
        return
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": str(device), "python": platform.python_version()}
    if device.type == "cuda":
        env["device_name"] = torch.cuda.get_device_name(device)
    meta = {
        "config": config_name,
        "overrides": overrides or {},
        "resolved_config": dataclasses.asdict(exp),
        "drivers": drivers,
        "data": data,
        "env": env,
        "started_unix": time.time(),
    }
    for d in dirs:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "run_meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)


def save_tuned_thresholds(checkpoint_dir, config_name, exp, thresholds,
                          source: str) -> None:
    """Persist swept per-emotion thresholds next to the checkpoints, where
    `predict` and `serve` pick them up.  The reference reads its sweep off
    the logs and hand-edits the values back into the script (the tables at
    cmu-mosei/run.py:481-486, Ren-MME/run.py:735-742)."""
    with open(os.path.join(checkpoint_dir, "thresholds.json"), "w") as f:
        json.dump({"config": config_name,
                   "emotion_names": list(exp.emotion_names),
                   "thresholds": [float(t) for t in thresholds],
                   "source": source}, f, indent=2)


def load_tuned_thresholds(checkpoint_dir, config_name, exp):
    """Tuned thresholds persisted by a swept eval in this store, or None
    (no file, another config family, or another emotion set)."""
    path = os.path.join(checkpoint_dir, "thresholds.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        d = json.load(f)
    if (configs.family(d.get("config", "")) != configs.family(config_name)
            or d.get("emotion_names") != list(exp.emotion_names)):
        return None
    return [float(t) for t in d["thresholds"]]


def _restore_members(config_name, exp, store, device):
    """The store's trained members, each fold's best checkpoint (the
    reference always reloads the best, cmu-mosei/run.py:447-453), as
    models on `device`, with their recorded valid losses (the realformer's
    member selection needs them)."""
    names = store.best_members(config_name)
    if not names and f"{config_name}_sweep_winner" in store.manifest:
        # a sweep-only store: its winner is the one servable model
        names = [f"{config_name}_sweep_winner"]
    if not names:
        raise ValueError(
            f"no trained members named {config_name!r} in the checkpoint "
            f"store (manifest has {sorted(store.manifest)}); run `train` "
            "with --checkpoint-dir first")
    members = [store.restore_params(n, build_model(exp, device=device))
               for n in names]
    member_losses = [store.manifest[n]["valid_loss"] for n in names]
    return members, member_losses


def _member(exp, state_dict, device):
    """A model of `exp` on `device` holding `state_dict`."""
    model = build_model(exp, device=device)
    model.load_state_dict(state_dict)
    return model


def _make_ensemble(config_name, members, member_losses, *,
                   impl: str = "xla", dtype: str = "float32", mesh=None,
                   stacked=None):
    """The config's combination: Ren-MME sums the members' logits
    (Ren-MME/run.py:560-575), the realformer keeps its two best folds at
    0.6/0.4 (others/realformer.py:420,482-485), every other config
    averages."""
    combine = "sum" if configs.family(config_name) == "ren_mme" else "mean"
    weights = None
    if configs.family(config_name) == "mosei_realformer" \
            and member_losses is not None and len(members) >= 2:
        order = np.argsort(member_losses)[:2]
        members = [members[i] for i in order]
        weights = [0.6, 0.4]
    return Ensemble(members, weights=weights, combine=combine, impl=impl,
                    dtype=dtype, mesh=mesh, stacked=stacked)


def _flatten_units(units, with_groups: bool = False):
    """Flatten pair-level LIST units (folds count pairs) to samples.
    `with_groups` gives each unit's samples a crop-group id, so that crop
    averaging keeps one prediction per pair."""
    out = []
    for i, u in enumerate(units):
        if isinstance(u, list):
            for s in u:
                out.append({**s, "group": np.asarray(i, np.int32)}
                           if with_groups else s)
        else:
            out.append(u)
    return out


def _collapse_test_outputs(logits, test_samples):
    """Reduce per-row ensemble logits to the reference's test units:
    two-crop pairs average to one prediction per pair (cmu-mosei/
    run.py:462,477-480); paragraph logits flatten to valid clips, keeping
    only those before the first invalid clip (others/realformer.py:427-441
    breaks there rather than skipping holes)."""
    labels = (np.stack([s["label"] for s in test_samples])
              if "label" in test_samples[0] else None)
    if "group" in test_samples[0]:
        gids = [int(s["group"]) for s in test_samples]
        if labels is None:
            logits = group_average(logits, gids)
        else:
            logits, labels = group_average(logits, gids, labels)
    if logits.ndim == 3:  # paragraph model: flatten valid clips
        clip_mask = np.stack([s["clip_mask"] for s in test_samples])
        keep = np.cumprod(clip_mask, axis=1).reshape(-1) > 0
        logits = logits.reshape(-1, logits.shape[-1])[keep]
        if labels is not None:
            labels = labels.reshape(-1, labels.shape[-1])[keep]
    return logits, labels


def _choose_thresholds(config_name, exp, logits, labels, sweep_thresholds,
                       checkpoint_dir):
    """(thresholds, sweep): the config's fixed thresholds, or, when asked
    for or when the config has none, the reference's search over the
    cached logits: Ren-MME's joint grid scored by micro + macro F1 of the
    whole label matrix (Ren-MME/run.py:582-613), the robot demo's 13-point
    grid (robot_demo.py:533) or the 400-point t/200 − 1 grid
    (others/realformer.py:412).  Swept values are saved to the store."""
    if not (sweep_thresholds or not exp.thresholds):
        return list(exp.thresholds), None
    if config_name == "ren_mme":
        joint = joint_threshold_grid(logits, labels, ren_mme_joint_grids(),
                                     exp.emotion_index, exp.emotion_names)
        sweep = {"joint": joint}
        thresholds = [joint["thresholds"][e] for e in exp.emotion_names]
    else:
        grid = (robot_threshold_grid() if config_name == "robot_demo"
                else realformer_threshold_grid())
        sweep = threshold_sweep(logits, labels, grid, exp.emotion_index,
                                exp.emotion_names)
        thresholds = [sweep[e]["t"] for e in exp.emotion_names]
    if checkpoint_dir and is_rank0():
        save_tuned_thresholds(checkpoint_dir, config_name, exp, thresholds,
                              source="sweep")
    return thresholds, sweep


def _run_experiment(
    config_name: str,
    *,
    synthetic_data: bool = True,
    data_root: Optional[str] = None,
    n_train: int = 256,
    n_test: int = 64,
    epochs: Optional[int] = None,
    log_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    impl: Optional[str] = None,
    sweep_thresholds: bool = False,
    quiet: bool = False,
    overrides: Optional[Dict] = None,
    resume: bool = False,
    seeds_per_fold: int = 1,
    device=None,
    transfer_dtype: Optional[str] = None,
    async_checkpoint: bool = False,
    vmap_folds: bool = False,
    scan_steps: int = 1,
    device_resident: bool = False,
    one_dispatch: bool = False,
    accum_steps: int = 1,
    profile_dir: Optional[str] = None,
    dp: Optional[int] = None,
    tp: int = 1,
) -> PipelineResult:
    """One reference script: the train samples carved into the config's k
    folds, one member trained per fold (and per extra seed,
    `seeds_per_fold`: member i trains fold i % k from seed tcfg.seed + i),
    then the members' ensemble scored on the held-out samples.  The
    samples are n_train and n_test synthetic ones, or with
    `synthetic_data=False` the corpus at `data_root` (`load_real_data`):
    `mosei_trans`' pair units are carved whole and flattened per fold, and
    robot_demo's folds substitute their texts anew each epoch.

    With `checkpoint_dir` each member's best epoch and an every-epoch
    resume point are saved, the ensemble reloads the best members, and
    `resume=True` continues an interrupted run.  `epochs=0` evaluates the
    store's members without training (the `eval` command).  Without a
    store the ensemble is the members' final states.  `log_dir` keeps one
    CSV of epoch losses per member.  `transfer_dtype` ("float16",
    "bfloat16" or "int8") ships every train, valid and test batch in that
    wire format, restored to f32 on the device before any math;
    `async_checkpoint` writes the store's files on a worker thread
    (`CheckpointStore(use_async=True)`), and the run joins the last one
    before it returns.

    The drivers (JAX's keywords and fallbacks, each fallback logged):
    `vmap_folds` trains the members in lockstep (train/vmap_kfold.py; off
    by default, where JAX's is on: on the card the sequential driver's
    captured steps are as fast a member-epoch, PERF.md);
    `device_resident` stages the samples on the card once and gathers
    every batch there; `one_dispatch` also runs the controllers on the card
    and launches every epoch without a host round trip (no resume);
    `scan_steps` copies that many host-fed batches together and launches
    their steps back to back; `accum_steps` accumulates the gradient over
    micro-batches (the sequential driver).  Pair-level units, robot_demo's
    per-epoch resampling, unequal folds and a host-fed int8 wire fall back
    as JAX's do.  The drivers are recorded in run_meta.json.

    `profile_dir`: torch.profiler traces (utils/logging.profile_trace) into
    this directory: each sequential member's first epoch after its
    captures, the lockstep's first such epoch, or one-dispatch's whole
    run.

    `dp` / `tp`: train on a mesh of dp x tp ranks (`make_mesh`; the world
    must hold exactly that many): batches sharded over `dp` on 'data',
    with `tp` > 1 tensor-parallel over 'model' (engine.Trainer(mesh=, tp=),
    or the lockstep drivers' `mesh=`, `tp=`); the same math as one device.  The batch rows per step (x2 under
    R-Drop) must divide dp.  The test batches shard over the same data
    axis where batch_size divides it.  dp=None, tp=1: one device."""
    exp = configs.with_overrides(configs.get(config_name), overrides)
    impl = impl or exp.model.attn_impl
    device = resolve_device(device)
    quiet = quiet or not is_rank0()
    loader_ctx = None
    if synthetic_data:
        train_samples, test_samples = _synthetic_data(exp, n_train, n_test)
    else:
        if data_root is None:
            raise ValueError("data_root required when synthetic_data=False")
        train_samples, test_samples, loader_ctx = load_real_data(exp,
                                                                 data_root)
    _log(f"[{config_name}] {_count_samples(train_samples)} train / "
         f"{_count_samples(test_samples)} test samples; device={device}, "
         f"impl={impl}", quiet)
    if resume and not checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir")
    store = (CheckpointStore(checkpoint_dir, use_async=async_checkpoint)
             if checkpoint_dir else None)
    loggers: Dict[str, RunLogger] = {}
    duplicate = exp.train.rdrop_kl  # Ren-MME's R-Drop duplicates each sample
    n_epochs = exp.train.epochs if epochs is None else epochs

    mesh = None
    if dp is not None or tp > 1:
        mesh = make_mesh(n_data=dp, n_model=tp, device=device)
        device = mesh.device
        n_data = mesh.shape["data"]
        rows = exp.train.batch_size * (2 if duplicate else 1)
        if rows % n_data:
            raise ValueError(
                f"batch rows per step ({rows}) must divide the data axis "
                f"({n_data}) — adjust --dp or train.batch_size")
        if duplicate and exp.train.batch_size % n_data:
            # a rank's rows would end inside a pair: its R-Drop term would
            # pair rows of two samples, or none
            raise ValueError(
                f"R-Drop's duplicate pairs must stay whole on a rank: "
                f"batch_size ({exp.train.batch_size}) must divide the data "
                f"axis ({n_data}) — adjust --dp or train.batch_size")
        if impl == "cp" and mesh.size > 1:
            raise ValueError(
                "impl='cp' shards the sequence over every rank, each on the "
                "same rows: it does not compose with a dp x tp mesh of "
                f"{mesh.size} ranks")
        _log(f"[{config_name}] mesh: dp={n_data} tp={mesh.shape['model']} "
             f"over {mesh.size} devices", quiet)

    # JAX's driver rules, each fallback logged in JAX's words
    # nested units (mosei pairs -> 1-2 crop samples) are carved at the unit
    # level and flattened per fold; per-fold sample counts then differ,
    # which the lockstep's aligned step counts cannot represent
    nested_units = bool(train_samples) and isinstance(train_samples[0], list)
    if accum_steps > 1 and vmap_folds:
        _log(f"[{config_name}] accum_steps > 1 uses the sequential k-fold "
             "driver; disabling vmap_folds", quiet)
        vmap_folds = False
    if nested_units and vmap_folds:
        _log(f"[{config_name}] pair-level folds require the sequential "
             "k-fold driver; disabling vmap_folds", quiet)
        vmap_folds = False
    if vmap_folds and exp.train.n_folds > 1:
        widths = {sl.stop - sl.start for sl, _ in contiguous_folds(
            len(train_samples), exp.train.n_folds, exp.train.fold_size)}
        if len(widths) > 1:
            _log(f"[{config_name}] unequal contiguous folds ({sorted(widths)});"
                 " using the sequential k-fold driver", quiet)
            vmap_folds = False
    if one_dispatch:
        if resume:
            _log(f"[{config_name}] one_dispatch has no epoch boundaries to "
                 "resume at; disabling one_dispatch", quiet)
            one_dispatch = False
        else:
            device_resident = True  # inherits the staging gates below
    if device_resident and n_epochs == 0:
        _log(f"[{config_name}] device_resident is a no-op with epochs=0; "
             "skipping dataset staging", quiet)
        device_resident = False
    if device_resident and (not vmap_folds or exp.train.n_folds <= 1
                            or loader_ctx is not None):
        _log(f"[{config_name}] device_resident requires the vmapped driver "
             "and a static sample set; falling back to host loaders", quiet)
        device_resident = False
    if device_resident:
        n = len(train_samples)
        fs, kf = exp.train.fold_size, exp.train.n_folds
        fold = fs if fs is not None and fs * kf <= n else n // kf
        if (n - fold) < exp.train.batch_size:
            _log(f"[{config_name}] device_resident needs >= batch_size "
                 f"({exp.train.batch_size}) train samples per fold, have "
                 f"{n - fold}; falling back to host loaders", quiet)
            device_resident = False
        elif scan_steps > 1:
            _log(f"[{config_name}] device_resident subsumes scan_steps "
                 "(each epoch is already one dispatch); ignoring "
                 f"scan_steps={scan_steps}", quiet)
    if one_dispatch and not device_resident:
        _log(f"[{config_name}] one_dispatch disabled by the fallback above; "
             "training runs with host-controlled epochs "
             "(single-model whole-run API: train/device_epochs."
             "fit_fully_compiled)", quiet)
        one_dispatch = False
    if transfer_dtype == "int8" and vmap_folds and not device_resident:
        _log(f"[{config_name}] host-fed int8 wire uses the sequential "
             "k-fold driver; disabling vmap_folds", quiet)
        vmap_folds = False

    # provenance written before training, so a crashed run has it too; an
    # eval-only pass must not overwrite the training run's
    _write_run_meta(
        [d for d in (log_dir, checkpoint_dir) if d]
        if n_epochs != 0 and is_rank0() else [],
        config_name=config_name, overrides=overrides, exp=exp,
        drivers={"epochs": epochs, "impl": impl,
                 "vmap_folds": vmap_folds, "scan_steps": scan_steps,
                 "device_resident": device_resident,
                 "one_dispatch": one_dispatch, "accum_steps": accum_steps,
                 "seeds_per_fold": seeds_per_fold,
                 "transfer_dtype": transfer_dtype,
                 "async_checkpoint": async_checkpoint, "resume": resume,
                 "sweep_thresholds": sweep_thresholds, "dp": dp, "tp": tp},
        data={"synthetic": synthetic_data, "data_root": data_root,
              "n_train": n_train, "n_test": n_test},
        device=device)

    def log_cb(name, epoch, stats):
        if log_dir:
            if name not in loggers:
                loggers[name] = RunLogger(log_dir, name)
            loggers[name].log_epoch(epoch, stats)
        _log(f"[{name}] epoch {epoch + 1}: train {stats.train_loss:.4f} "
             f"valid {stats.valid_loss:.4f} ({stats.samples_per_sec:.0f} "
             "samples/s)", quiet)

    def robot_resample(subset, fold_idx):
        """Fold `fold_idx`'s samples with their texts substituted anew for
        each epoch, from a per-fold seed; the clip indices ride along."""
        idxs = [int(s["name_idx"]) for s in subset]
        fold_names = [loader_ctx["names"][i] for i in idxs]
        seed = exp.train.seed * 1000 + fold_idx

        def resample(epoch):
            fresh = loader_ctx["assembler"].epoch_materialize(
                fold_names, loader_ctx["table"], epoch, seed=seed)
            for s, i in zip(fresh, idxs):
                s["name_idx"] = np.asarray(i, np.int32)
            return fresh

        return resample

    fold_counter = {"i": 0}

    def make_loaders(train, valid):
        resample = None
        if loader_ctx is not None:
            resample = robot_resample(train, fold_counter["i"])
            fold_counter["i"] += 1
        return (Batcher(_flatten_units(train), exp.train.batch_size,
                        duplicate=duplicate, seed=1, resample=resample),
                Batcher(_flatten_units(valid), exp.train.batch_size,
                        duplicate=duplicate, shuffle=False))

    best_members = best_losses = None
    driver_stats: Dict = {}
    if vmap_folds and exp.train.n_folds > 1:
        common = dict(store=store, name_prefix=config_name, epochs=epochs,
                      impl=impl, log_cb=log_cb,
                      fold_size=exp.train.fold_size, duplicate=duplicate,
                      seeds_per_fold=seeds_per_fold,
                      transfer_dtype=transfer_dtype, device=device,
                      info=driver_stats, profile_dir=profile_dir,
                      mesh=mesh, tp=tp > 1)
        if one_dispatch:
            _, hists, best_members, best_losses = run_kfold_fully_compiled(
                train_samples, exp, exp.train, **common)
            _log(f"[{config_name}] one dispatch: "
                 f"{driver_stats['epochs_launched']} epochs launched, "
                 f"{driver_stats['masked_epochs']} of them after every "
                 "member had stopped (masked)", quiet)
        else:
            _, hists, best_members, best_losses = run_kfold_vmapped(
                train_samples, make_loaders, exp, exp.train,
                scan_steps=scan_steps, device_resident=device_resident,
                resume=resume, **common)
        results = [(None, h) for h in hists]
    else:
        results = run_kfold(train_samples, make_loaders, exp, exp.train,
                            store=store, name_prefix=config_name,
                            epochs=epochs, impl=impl, log_cb=log_cb,
                            fold_size=exp.train.fold_size, resume=resume,
                            seeds_per_fold=seeds_per_fold, device=device,
                            transfer_dtype=transfer_dtype,
                            scan_steps=scan_steps, accum_steps=accum_steps,
                            profile_dir=profile_dir, mesh=mesh, tp=tp > 1)
    if world_size() > 1 and store is not None:
        # rank 0 wrote the store: every rank reads it once its saves landed
        store.wait()
        torch.distributed.barrier()
        if not is_rank0():
            store = CheckpointStore(checkpoint_dir)

    report = sweep = logits = labels = None
    if test_samples:
        member_losses = None
        if store is not None:
            members, member_losses = _restore_members(config_name, exp,
                                                      store, device)
        elif best_members is not None:
            # the lockstep drivers' best parameters, kept without a store
            members = [_member(exp, sd, device) for sd in best_members]
            member_losses = best_losses
        elif tp > 1:
            # the final states' shards gathered whole: the members replicate
            members = [_member(exp, WholeState(state).state_dict()["model"],
                               device) for state, _ in results]
        else:
            members = [state.model for state, _ in results]
        # the eval batches are not R-Drop duplicated: they shard over the
        # data axis only where batch_size divides it
        eval_mesh = (mesh if mesh is not None
                     and exp.train.batch_size % mesh.shape["data"] == 0
                     else None)
        ens = _make_ensemble(config_name, members, member_losses, impl=impl,
                             dtype=exp.train.compute_dtype, mesh=eval_mesh)
        # eval batches: no shuffle, no R-Drop duplicates (Ren-MME/run.py:427-449)
        test_loader = Batcher(test_samples, exp.train.batch_size, shuffle=False)
        logits, labels = _collapse_test_outputs(
            ens.predict_all(test_loader, transfer_dtype=transfer_dtype),
            test_samples)
        thresholds, sweep = _choose_thresholds(
            config_name, exp, logits, labels, sweep_thresholds, checkpoint_dir)
        report = evaluate(logits, labels, thresholds, exp.emotion_index,
                          exp.emotion_names)
        _log(format_report(report, title=config_name), quiet)
    for lg in loggers.values():
        lg.close()
    if store is not None:
        store.wait()
    return PipelineResult(config_name, [h for _, h in results], report, sweep,
                          store, logits, labels, driver_stats)


def _in_world(run, config_name: str, kwargs, meshed: bool):
    """`run(config_name, **kwargs)` with impl="cp" bound to a psum-mode
    context over every rank when the caller bound none
    (ops/context_parallel.ensure_cp), and for a mesh a world of one rank
    made for the call when no process group exists."""
    device = kwargs.get("device")
    with contextlib.ExitStack() as stack:
        stack.enter_context(ensure_cp(kwargs.get("impl") or "xla",
                                      device=device))
        if meshed:
            stack.enter_context(world(device))
        return run(config_name, **kwargs)


@functools.wraps(_run_experiment)
def run_experiment(config_name: str, **kwargs) -> PipelineResult:
    return _in_world(_run_experiment, config_name, kwargs,
                     kwargs.get("dp") is not None or kwargs.get("tp", 1) > 1)


run_experiment.__name__ = run_experiment.__qualname__ = "run_experiment"


def run_lr_sweep_experiment(
    config_name: str,
    *,
    lrs,
    wds=None,
    seeds_per_lr: int = 1,
    synthetic_data: bool = True,
    data_root: Optional[str] = None,
    n_train: int = 256,
    n_test: int = 64,
    epochs: Optional[int] = None,
    impl: Optional[str] = None,
    quiet: bool = False,
    overrides: Optional[Dict] = None,
    checkpoint_dir: Optional[str] = None,
    transfer_dtype: Optional[str] = None,
    device=None,
) -> Dict:
    """The config-named sweep (train/sweep.run_lr_sweep): every (lr x wd x
    seed) candidate trains together on fold 0's train and valid split (the
    k-fold drivers' shuffle and contiguous carving, so the sweep tunes on
    the data fold 1 of a later `run_experiment` validates on).  Returns
    {"table": rows best-first, "winner": {...}, "seconds": s}; with
    `checkpoint_dir` the winner's best parameters are saved as
    '{config_name}_sweep_winner', which `eval`, `predict` and `serve`
    pick up from a store with no k-fold members."""
    import random

    exp = configs.with_overrides(configs.get(config_name), overrides)
    impl = impl or exp.model.attn_impl
    device = resolve_device(device)
    if synthetic_data:
        train_units, _ = _synthetic_data(exp, n_train, n_test)
    else:
        if data_root is None:
            raise ValueError("data_root required when synthetic_data=False")
        train_units, _, loader_ctx = load_real_data(exp, data_root)
        if loader_ctx is not None:
            raise ValueError(
                "the robot per-epoch text substitution re-materializes "
                "samples each epoch; the staged sweep cannot represent that "
                "— sweep robot_demo on synthetic data or freeze an epoch's "
                "materialization")
    train_units = list(train_units)
    random.Random(0).shuffle(train_units)  # the k-fold drivers' carving
    va_slice, tr_ranges = contiguous_folds(
        len(train_units), exp.train.n_folds, exp.train.fold_size)[0]
    valid_samples = _flatten_units(train_units[va_slice])
    train_samples = _flatten_units(
        [train_units[j] for r in tr_ranges for j in r])
    n_members = len(lrs) * (len(wds) if wds else 1) * seeds_per_lr
    _log(f"[{config_name}] sweep: {len(lrs)} lrs x "
         f"{len(wds) if wds else 1} wds x {seeds_per_lr} seeds = "
         f"{n_members} members, {len(train_samples)} train / "
         f"{len(valid_samples)} valid samples (fold-0 split)", quiet)

    def log_cb(name, epoch, stats):
        _log(f"[{name}] epoch {epoch + 1}: train {stats.train_loss:.4f} "
             f"valid {stats.valid_loss:.4f}", quiet)

    with ensure_cp(impl, device=device):
        result = run_lr_sweep(
            train_samples, valid_samples, exp, exp.train, lrs=lrs, wds=wds,
            seeds_per_lr=seeds_per_lr, epochs=epochs, impl=impl,
            duplicate=exp.train.rdrop_kl, log_cb=None if quiet else log_cb,
            transfer_dtype=transfer_dtype, device=device)
    win = result.members[result.winner]
    if checkpoint_dir:
        store = CheckpointStore(checkpoint_dir)
        store.save_params(f"{config_name}_sweep_winner", win.best_params,
                          valid_loss=win.best_valid_loss,
                          epoch=max(win.best_epoch, 0), imported=False)
    out = {"table": result.table(),
           "winner": {"lr": win.lr, "wd": win.wd, "seed": win.seed,
                      "best_valid_loss": win.best_valid_loss,
                      "best_epoch": win.best_epoch},
           "seconds": result.seconds}
    _log(f"[{config_name}] sweep winner: lr={win.lr:g} wd={win.wd:g} "
         f"seed={win.seed} best_valid_loss={win.best_valid_loss:.4f} "
         f"({result.seconds:.1f}s total)", quiet)
    return out


def _run_predict(
    config_name: str,
    *,
    checkpoint_dir: Optional[str] = None,
    init_random: bool = False,
    synthetic_data: bool = True,
    data_root: Optional[str] = None,
    n_test: int = 64,
    n_train: Optional[int] = None,
    impl: Optional[str] = None,
    overrides: Optional[Dict] = None,
    thresholds: Optional[List[float]] = None,
    output: Optional[str] = None,
    quiet: bool = False,
    split: str = "test",
    device=None,
    transfer_dtype: Optional[str] = None,
    device_resident: bool = False,
    dp: Optional[int] = None,
    stacked: bool = False,
) -> Dict:
    """Offline batch inference: the trained ensemble over a split once,
    every sample's outputs kept (eval/predictions.py): the artifact
    between `eval` (metrics only) and `serve` (one sample at a time).

    Samples: the synthetic test split (n_test, seed 1), the train split
    (n_train, default n_test, seed 0) or both (`split="all"`); or with
    `synthetic_data=False` the same splits of the corpus at `data_root`,
    where a corpus with no held-out split (robot_demo's) predicts over
    all its samples, and with `split="all"` the test split's crop groups
    are numbered above the train split's.  Members:
    the store's best checkpoints with the config's combination, or one
    fresh member from the config's seed with `init_random=True` (a smoke
    run).  Decisions use `thresholds`, else the store's tuned ones, else
    the config's, else zeros.  `output` writes .npz/.csv/.jsonl.
    `transfer_dtype` ships the batches in that wire format
    (`Ensemble.predict_all`).  `device_resident` stages the whole split on
    the card once and replays one program per batch
    (`Ensemble.predict_all_staged`): the same logits, without a per-batch
    copy.  `dp`: shard the batches over a mesh of dp ranks' 'data' axis
    (`Ensemble(mesh=)`; the world must hold dp ranks, batch_size must
    divide dp; not with `device_resident`); the logits are one device's.
    `stacked`: the members' grids on the stacked RealFormer path
    (`Ensemble(stacked=True)`; impl "xla", RealFormer blocks).
    Rank 0 alone writes `output`.  Returns the prediction table with
    "rows" and "members" counts."""
    from .eval.predictions import prediction_table, write_predictions

    exp = configs.with_overrides(configs.get(config_name), overrides)
    impl = impl or exp.model.attn_impl
    device = resolve_device(device)
    quiet = quiet or not is_rank0()
    mesh = None
    if dp is not None:
        if device_resident:
            raise ValueError("device_resident does not compose with dp — "
                             "pick one (staged scoring vs sharded "
                             "per-batch inference)")
        mesh = make_mesh(n_data=dp, n_model=1, device=device)
        device = mesh.device
        if exp.train.batch_size % mesh.shape["data"]:
            raise ValueError(
                f"batch_size ({exp.train.batch_size}) must be divisible by "
                f"dp ({mesh.shape['data']}) for sharded inference")
        _log(f"[{config_name}] predict mesh: dp={mesh.shape['data']}", quiet)
    if split not in ("test", "train", "all"):
        raise ValueError(f"split must be test/train/all, got {split!r}")
    n_tr = n_train if n_train is not None else n_test

    if synthetic_data:
        def _train():
            return synthetic.synthetic_dataset(exp.name, exp.model, n_tr, 0)

        def _test():
            return synthetic.synthetic_dataset(exp.name, exp.model, n_test, 1)

        samples = {"train": _train, "test": _test,
                   "all": lambda: _train() + _test()}[split]()
    else:
        if data_root is None:
            raise ValueError("data_root required when synthetic_data=False")
        train_units, test_samples, _ = load_real_data(exp, data_root)
        train_samples = _flatten_units(train_units, with_groups=True)
        if split == "train":
            samples = train_samples
        elif split == "test":
            samples = test_samples
            if not samples:
                samples = train_samples
                _log(f"[{config_name}] corpus has no held-out split; "
                     f"predicting over all {len(samples)} samples", quiet)
        else:
            if test_samples and "group" in test_samples[0]:
                # group ids count within a split: the test split's go above
                # the train split's, so no crop average spans both
                off = (1 + max(int(s["group"]) for s in train_samples)
                       if train_samples and "group" in train_samples[0]
                       else 0)
                test_samples = [
                    {**s, "group": np.asarray(int(s["group"]) + off,
                                              np.int32)}
                    for s in test_samples]
            samples = train_samples + test_samples
    if not samples:
        raise ValueError("no samples to predict on")
    if checkpoint_dir:
        store = CheckpointStore(checkpoint_dir)
        members, member_losses = _restore_members(config_name, exp, store,
                                                  device)
    elif init_random:
        members = [build_model(exp, device=device, seed=exp.train.seed)]
        member_losses = None
    else:
        raise ValueError("checkpoint_dir required (or init_random=True for "
                         "an untrained smoke run)")
    ens = _make_ensemble(config_name, members, member_losses, impl=impl,
                         dtype=exp.train.compute_dtype, mesh=mesh,
                         stacked=True if stacked else None)
    if device_resident:
        raw = ens.predict_all_staged(samples, exp.train.batch_size,
                                     transfer_dtype=transfer_dtype)
    else:
        raw = ens.predict_all(Batcher(samples, exp.train.batch_size,
                                      shuffle=False),
                              transfer_dtype=transfer_dtype)
    logits, labels = _collapse_test_outputs(raw, samples)
    if thresholds is None and checkpoint_dir:
        thresholds = load_tuned_thresholds(checkpoint_dir, config_name, exp)
        if thresholds is not None:
            _log(f"[{config_name}] using tuned thresholds from "
                 f"{checkpoint_dir}/thresholds.json", quiet)
    if thresholds is None:
        thresholds = (list(exp.thresholds) if exp.thresholds
                      else [0.0] * len(exp.emotion_names))
    table = prediction_table(logits, thresholds, exp.emotion_index,
                             exp.emotion_names, labels=labels)
    table["rows"] = int(table["pred"].shape[0])
    table["members"] = ens.k
    if output and is_rank0():
        write_predictions(output, table)
        _log(f"[{config_name}] wrote {table['rows']} predictions "
             f"({ens.k} members) to {output}", quiet)
    return table


@functools.wraps(_run_predict)
def run_predict(config_name: str, **kwargs) -> Dict:
    return _in_world(_run_predict, config_name, kwargs,
                     kwargs.get("dp") is not None)


run_predict.__name__ = run_predict.__qualname__ = "run_predict"
