"""On the card, at the cells' own sizes: a short run of each cell is
correct, and the control is not.  Skipped where there is no card."""

import json
import subprocess
import sys

import pytest

from rtbench import calibrate, paths, run
from rtbench.tests import tiny

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_runs_correct(card, cell):
    proc = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", cell, "--seed",
                           str(tiny.SEED), "--seconds", "2", "--trace", "0"], cwd=paths.ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_at_cell_size(card, cell):
    spec = run.resolve(run.load_json(paths.ROOT, "BENCHMARK.json"), cell)
    got = calibrate.calibrate(spec, [tiny.SEED], 1.0, 1, card)
    assert all(got["lower"][k] <= v for k, v in spec["limits"].items())
    assert any(got["upper"][k] > v for k, v in spec["limits"].items())
