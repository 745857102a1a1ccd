"""The comparison that decides ``correct`` fails what it must: the control
(the reference in bfloat16 in the program's place) and a run whose timed
path is broken underneath, at a tiny size on the CPU.  On the card the
control's readings at the cells' own sizes are taken by
``python3 -m rtbench.calibrate --control`` (PERF.md)."""

import numpy as np
import pytest
import torch

from rtbench import calibrate
from rtbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(cell):
    spec = tiny.spec(cell)
    got = calibrate.calibrate(spec, [11, 12, 13], 0.2, 3, "cpu")
    for name, limit in spec["limits"].items():
        assert got["lower"][name] <= limit
    # The control fails one of the cell's numbers on every seed.
    assert any(got["upper"][name] > limit for name, limit in spec["limits"].items())


def _drop_half(route):
    def broken(tables, rays, any_hit=False, **kw):
        hits = route(tables, rays, any_hit=any_hit, **kw)
        n = rays.num
        gone = torch.arange(n, device=rays.origin.device) >= n // 2
        return hits._replace(tri=torch.where(gone, -1, hits.tri),
                             t=torch.where(gone, rays.tmax, hits.t))
    return broken


def _alter(route):
    def broken(tables, rays, any_hit=False, **kw):
        hits = route(tables, rays, any_hit=any_hit, **kw)
        n = rays.num
        hit = hits.tri >= 0
        pick = (torch.arange(n, device=rays.origin.device) % 5 == 0) & (rays.tmax >= 0)
        tri = torch.where(pick, torch.where(hit, -1, 0), hits.tri).to(hits.tri.dtype)
        t = torch.where(pick, torch.where(hit, rays.tmax, rays.tmax * 0.5), hits.t)
        return hits._replace(tri=tri, t=t)
    return broken


FAULTS = {"half_the_batch_left_out": _drop_half, "answers_altered": _alter}


def _plant(make):
    def fault(driver):
        if hasattr(driver, "renderer"):
            driver.renderer.routing = make(driver.renderer.routing)
        else:
            driver.route = make(driver.route)
    return fault


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_broken_timed_path_is_not_correct(cell, fault):
    line = tiny.line(cell, fault=_plant(FAULTS[fault]))
    assert not line["correct"]
    assert line["failed"] > 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_sound_run_reads_below_its_limits():
    spec = tiny.spec("conference-ao8")
    got = calibrate.calibrate(spec, [21], 0.2, 0, "cpu")
    assert got["upper"] == {}
    assert all(np.isfinite(v) and v <= spec["limits"][k] for k, v in got["lower"].items())
