"""The cells on the card, a short window each (run where torch sees a CUDA
device; skipped elsewhere):

    python3 -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

from __future__ import annotations

import pytest

from portbench import harness, runner


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["solve.deflector.b1024",
                                  "design.ns2_member.rp40", "lens.ns2_580"])
def test_cell_on_the_card(cuda_device, name):
    cell = harness.Cell(name)
    res = runner.execute(cell, 2 ** 32 + 1, 2.0, 0, device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end()}
