"""The control on the card: the plain reference put in the program's
place in float32 with TF32 on fails the cell's limits, where the program
passes them, at the configurations' own widths on fewer and shorter
videos than a run's (a size a test run can hold).  Needs a CUDA device;
``portbench/calibrate.py`` reads the same numbers at the cells' sizes."""
import shutil
import tempfile
from pathlib import Path

import pytest

from portbench import calibrate
from portbench.lib import check
from portbench.lib.cell import load_cell

CELLS = ["ab-nystromformer.train-tvsum", "ab-attention.eval-summe",
         "ab-nystromformer.eval-summe"]


def _small(name):
    cell = load_cell(name)
    traffic = dict(cell.traffic, videos=10, held_out=2,
                   positions=[cell.traffic["positions"][0], 400])
    if "max_epoch" in traffic["program"]:
        traffic["program"] = dict(traffic["program"], max_epoch=1)
    cell.traffic = traffic
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7, 5550123])
def test_control_fails_where_the_program_passes(name, seed, card):
    cell = _small(name)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-test-"))
    run = cell.driver.Run(cell, seed, card, workdir)
    try:
        run.setup()
        run.window(0.0 if "train" in name else 3.0)
        ok, rows = check.verdict(run.judge(), cell.limits)
        assert ok, rows
        control = calibrate.control_numbers(cell, run, card)
        ok, rows = check.verdict(
            {k: control.get(k, 0.0) for k in cell.limits}, cell.limits)
        assert not ok, rows
    finally:
        run.close()
        shutil.rmtree(workdir, ignore_errors=True)
