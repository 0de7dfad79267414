"""Shared pieces of the benchmark's tests: the tiny configurations the CPU
runs use, and the `cuda` fixture that skips a card-only test here."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_PAIR = {"dim": 12, "n_heads": 2, "l_len": 6, "v_len": 9, "a_len": 10}
TINY_ROBOT = {"dim": 12, "n_heads": 2, "l_len": 5, "v_len": 7, "a_len": 8}

#: every cell at a size a CPU test holds: the widths, lengths, folds and
#: pools cut, the structure (heads, blocks, layers, members) kept
TINY = {
    "mosei_trans.train": {"model": TINY_PAIR,
                          "train": {"fold_size": 32, "n_folds": 2,
                                    "batch_size": 8},
                          "traffic": {"epochs_per_member": 2}},
    "mosei_trans.eval": {"model": TINY_PAIR, "train": {"batch_size": 8},
                         "traffic": {"n_pairs": 40, "check_rows": 30}},
    "robot_demo.stream": {"model": TINY_ROBOT,
                          "traffic": {"pool": 16, "warm_requests": 2,
                                      "check_requests": 10}},
    "robot_demo.serve": {"model": TINY_ROBOT,
                         "traffic": {"pool": 16, "warm_requests": 2,
                                     "check_requests": 10, "rate_per_s": 60}},
}


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny():
    return TINY
