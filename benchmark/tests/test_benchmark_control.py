"""On the card: the control, the plain reference computed with TF32 on in
the program's place, comes out not correct under each cell's limits,
while the program at the same seed comes out within them.  A short
window at each cell's own sizes; run with
`python -m pytest benchmark/tests/test_benchmark_control.py` on the card
(it skips elsewhere)."""

import pytest

from benchmark import calibrate
from benchmark.core import spec

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda, cell):
    c = spec.Cell(cell)
    out = calibrate.readings(c, 2_500_000_001, 2.0, control=True,
                             faults=cell.endswith(".train"))
    assert all(v <= c.limits[k] for k, v in out["program"].items())
    assert any(v > c.limits[k] for k, v in out["control"].items())
    if "half_batch" in out:
        assert any(v > c.limits[k] for k, v in out["half_batch"].items())
