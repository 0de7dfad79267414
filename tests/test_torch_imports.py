"""The PyTorch port stands alone: every port module and chip_smoke.py import
with JAX and the JAX package made unimportable, no port source names the JAX
package, and chip_smoke.py fails without a GPU or without the repo."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multimodal_emotion_processing_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _sources():
    return (sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
            + sorted(PORT.rglob("*.cuh")) + [ROOT / "chip_smoke.py"])


def test_the_training_slice_is_covered():
    """The modules and kernel sources of the training slice are among those
    the tests below import and scan."""
    mods = set(_port_modules())
    for m in ("ops.loss", "ops.flash_attention", "data.loader",
              "train.engine", "train.schedule", "data.sources",
              "data.mosei_folds", "data.mosei", "data.rencecps",
              "data.ren_mme", "data.robot", "data.validate"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods
    names = {p.name for p in _sources()}
    assert {"flash_fwd.cu", "flash_bwd.cu", "flash_common.cuh"} <= names


def test_the_robot_slice_is_covered():
    """The modules and kernel source of the robot_demo serving slice are
    among those the tests below import and scan."""
    mods = set(_port_modules())
    for m in ("ops.pallas_attention", "ops.cuda_binding", "models.layers",
              "models.heads", "data.masking"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods
    assert "scored_fwd.cu" in {p.name for p in _sources()}


def test_the_realformer_slice_is_covered():
    """The modules and kernel sources of the mosei_realformer training and
    paragraph serving slice are among those the tests below import and
    scan."""
    mods = set(_port_modules())
    for m in ("ops.pallas_attention", "ops.attention", "models.grid",
              "models.heads", "models.registry", "data.synthetic",
              "interop.torch_compat", "serve.stream", "cli"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods
    names = {p.name for p in _sources()}
    assert {"scored_fwd.cu", "scored_bwd.cu", "flash_common.cuh"} <= names


def test_the_fused_block_slice_is_covered():
    """The modules and kernel sources of the whole-block slice
    (`mosei_trans` training and `ren_mme` serving at impl="pallas_fused")
    are among those the tests below import and scan."""
    mods = set(_port_modules())
    for m in ("ops.fused_block", "ops.pallas_attention", "models.layers",
              "models.grid", "models.heads", "models.registry", "configs",
              "data.synthetic", "interop.torch_compat", "cli"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods
    names = {p.name for p in _sources()}
    assert {"fused_block.cu", "scored_bwd.cu", "flash_common.cuh"} <= names


def test_the_training_families_slice_is_covered():
    """The modules of the slice that trains every family (dropout, the
    R-Drop KL and duplicated batches, the `concat_linear` head, the
    `rencecps` config, sampler and BERT masking) are among those the tests
    below import and scan."""
    mods = set(_port_modules())
    for m in ("configs", "data.masking", "data.synthetic", "data.loader",
              "models.layers", "models.grid", "models.heads",
              "models.registry", "interop.torch_compat", "ops.loss",
              "train.engine", "cli"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods
    names = {p.name for p in _sources()}
    assert {"scored_fwd.cu", "scored_bwd.cu", "fused_block.cu"} <= names


def test_the_experiment_slice_is_covered():
    """The modules of the k-fold experiment slice (folds, checkpoints,
    metrics, the ensemble and its thresholds, the report, prediction files,
    the pipelines, the run logs and the CLI's front doors) are among those
    the tests below import and scan."""
    mods = set(_port_modules())
    for m in ("train.kfold", "train.checkpoint", "train.metrics",
              "eval.ensemble", "eval.report", "eval.predictions",
              "pipelines", "utils.logging", "cli"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods


def test_the_serving_io_slice_is_covered():
    """The modules of the serving and I/O slice (the captured programs, the
    HTTP front end, the export, the wire formats and the asynchronous
    store) are among those the tests below import and scan."""
    mods = set(_port_modules())
    for m in ("serve.graphs", "serve.stream", "serve.server",
              "serve.http_api", "serve.export", "eval.ensemble",
              "data.loader", "train.engine", "train.kfold",
              "train.checkpoint", "pipelines", "ops.cuda_binding", "cli"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods


def test_the_drivers_slice_is_covered():
    """The modules of the whole-run drivers slice (device-resident epochs,
    the lockstep k-fold, the learning-rate sweep and its cost bench, the
    captured steps' engine and the capture ledger) are among those the
    tests below import and scan."""
    mods = set(_port_modules())
    for m in ("train.device_epochs", "train.vmap_kfold", "train.sweep",
              "bench", "bench.sweep_cost", "train.engine", "serve.graphs",
              "ops.cuda_binding", "eval.ensemble", "pipelines", "cli"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods


def test_the_tools_slice_is_covered():
    """The modules of the CLI and tools slice (reference `.pt` files in and
    out, acceptance, parameter counts and FLOPs, doctor, tune, config files,
    profiling and NaN debugging, per-block remat) are among those the tests
    below import and scan."""
    mods = set(_port_modules())
    for m in ("interop.torch_compat", "eval.acceptance", "utils",
              "utils.logging", "bench.flops", "bench.doctor", "bench.autotune",
              "configs", "models.grid", "models.layers", "serve.graphs",
              "train.engine", "train.kfold", "train.vmap_kfold", "pipelines",
              "cli"):
        assert f"multimodal_emotion_processing_tpu_torch.{m}" in mods


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['multimodal_emotion_processing_tpu'] = None\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not None"
        " and m.split('.')[0] in ('jax', 'multimodal_emotion_processing_tpu'))\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_every_port_module_imports_without_h5py():
    """The card's machine has no h5py: every port module imports without
    it (and without JAX), and only a `.csd` reader asks for it, by name."""
    code = (
        "import importlib, sys\n"
        "for blocked in ('jax', 'multimodal_emotion_processing_tpu', 'h5py'):\n"
        "    sys.modules[blocked] = None\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "from multimodal_emotion_processing_tpu_torch.data.sources import CsdSource\n"
        "try:\n"
        "    CsdSource('glove_vectors.csd')\n"
        "except ImportError as e:\n"
        "    assert 'h5py' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('CsdSource built without h5py')\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_port_source_names_jax_or_the_jax_package(path):
    text = path.read_text()
    assert "multimodal_emotion_processing_tpu." not in text
    assert not re.search(r"^\s*(import jax|from jax)\b", text, re.M)
    assert not re.search(r"^\s*(import|from) multimodal_emotion_processing_tpu\b"
                         r"(?!_torch)", text, re.M)


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    for cwd in (ROOT, tmp_path):
        script = cwd / "chip_smoke.py"
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
