"""Nothing the benchmark loads is JAX or the JAX package, the reference
takes nothing from the program, and a run without a card fails without a
result."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchmark.core import port, spec

HERE = spec.HERE
FILES = sorted(HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.level, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_by_top_level_name(path):
    for level, name in _imports(path):
        if level == 0:
            assert name.split(".")[0] not in port.FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for level, name in _imports(path):
        assert level <= 1, (path, name)          # nothing outside reference/
        assert name.split(".")[0] in ("", "__future__", "collections", "math",
                                      "typing", "numpy", "torch"), (path, name)


def test_top_level_names_compare_whole():
    assert port.forbidden_modules(
        ["multimodal_emotion_processing_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert port.forbidden_modules(
        ["multimodal_emotion_processing_tpu.models", "jax.numpy", "jaxlib",
         "flax.linen"]) == ["flax", "jax", "jaxlib",
                            "multimodal_emotion_processing_tpu"]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "robot_demo.stream",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_only_the_benchmark_is_no_run(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""
