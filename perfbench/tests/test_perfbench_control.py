"""On the card, at each cell's own size: the program as configured
passes the cell's limits on three seeds, and the control, the program
with its int8 path switched on (K3's int8 products, the precision below
the stated bf16), fails them on three others. Run on the card with
``python3 -m pytest perfbench/tests -m cuda``."""

import pytest
import torch

from perfbench import compare, control, harness
from .conftest import ROOT

# a window long enough to compare as many rows as a run does
SECONDS = {"bge-base.passages": 5.0, "nomic-v2-moe.passages": 8.0,
           "bge-base.queries-packed": 10.0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SECONDS))
def test_control_fails_the_limits_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("runs each cell at its own size, on the card")
    cell = harness.load_cell(ROOT, name)
    dev = torch.device("cuda", 0)
    secs = SECONDS[name]
    for row in control.readings(cell, [2**31 + 101, 2**31 + 103,
                                       2**31 + 107], False, secs, dev):
        whole = 2 * cell.mix["request_size"]  # and the sampled rows
        assert row["rows"] == whole + cell.mix["check_rows"], row
        assert compare.passed(compare.judge(row, cell.limits)), row
    for row in control.readings(cell, [2**31 + 201, 2**31 + 203,
                                       2**31 + 207], True, secs, dev):
        assert not compare.passed(compare.judge(row, cell.limits)), row
