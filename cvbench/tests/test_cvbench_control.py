"""The control of each cell's check comes out not correct: the plain
reference computed a precision below the configuration's (fp8 e4m3 for the
bfloat16 cells, int4 for the int8 one), judged by the cell's comparison
against its committed limits, on the card at the cell's configuration (a
few frames). ``python -m cvbench.control`` reads the same numbers over
more seeds and frames."""

import pytest

from cvbench import run
from cvbench.control import readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell,frames", [("semseg_a.infer_b1", 4),
                                         ("centernet_b.serve_int8", 8),
                                         ("centernet_b.train_records", 0)])
def test_control_fails(cuda_device, cell_spec, cell, frames):
    spec = cell_spec(cell)
    values = readings(spec, 2 ** 31 + 101, cuda_device, spec["mix"]["check"]["control"], frames)
    ok, rows = run.compare(values, spec["limits"])
    assert not ok, rows


@pytest.mark.cuda
def test_half_batch_fault_fails(cuda_device, cell_spec):
    spec = cell_spec("centernet_b.train_records")
    values = readings(spec, 2 ** 31 + 102, cuda_device, "fp8_e4m3", 0, fault="half_batch")
    ok, rows = run.compare(values, spec["limits"])
    assert not ok, rows
