"""Each cell's run at a tiny size on the CPU, with the port's plain
versions: a well-formed last line, correct, with the cell's metrics; the
entry point's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from rtbench import paths, run
from rtbench.tests import tiny

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _well_formed(line: dict, spec: dict, trace: bool):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert DEVICE_KEYS <= set(line["device"])
    assert line["attempted"] > 0 and 0 <= line["failed"] <= line["attempted"]
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] == spec["limits"][name]
    json.loads(json.dumps(line))
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_rehearsal(cell):
    line = tiny.line(cell)
    _well_formed(line, tiny.spec(cell), trace=False)
    assert line["correct"] and line["failed"] == 0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_rehearsal_traced(cell):
    line = tiny.line(cell, trace=True)
    spec = tiny.spec(cell)
    _well_formed(line, spec, trace=True)
    assert line["correct"]
    # On the CPU the trace holds no device operation: the device readers
    # return nothing, the span readers their spans.
    got = set(line["metrics"])
    spans = ({"setup.renderer_s"} if cell.endswith("-frames")
             else {"setup.bvh_s", "setup.kernels_s"})
    assert spans <= got
    assert not got & {"trace_kernels_roofline", "device_idle_pct.trace",
                      "device_idle_pct.frame"}
    assert got <= {m["name"] for m in spec["per_layer"]}


def test_main_refuses_without_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "conference-ao8", "--seed", "1", "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_main_refuses_unknown_cell(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_refuse(tmp_path):
    """A directory with only BENCHMARK.json and the files under ``paths``
    (no program) exits non-zero and prints no result."""
    bench = run.load_json(paths.ROOT, "BENCHMARK.json")
    shutil.copy(os.path.join(paths.ROOT, "BENCHMARK.json"), tmp_path)
    for p in bench["paths"]:
        shutil.copytree(os.path.join(paths.ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(bench["command"] + ["--workload", "conference-ao8", "--seed", "1",
                                              "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_large_seed_is_accepted():
    line = tiny.line("dragon-primary", seed=2**31 + 12_345)
    assert line["correct"]


def test_same_seed_same_work():
    a = tiny.spec("conference-ao8")
    from rtbench.drivers.common import Driver

    d1 = Driver(a["config"], a["mix"], 77, "cpu", {}, {})
    d2 = Driver(a["config"], a["mix"], 77, "cpu", {}, {})
    d3 = Driver(a["config"], a["mix"], 78, "cpu", {}, {})
    assert d1.ao_seed == d2.ao_seed != d3.ao_seed
    for c1, c2 in zip(d1.cams, d2.cams):
        assert all((c1[k] == c2[k]).all() if hasattr(c1[k], "all") else c1[k] == c2[k]
                   for k in c1)
    assert any((c1["position"] != c3["position"]).any() for c1, c3 in zip(d1.cams, d3.cams))


def test_entry_point_in_subprocess_has_no_jax():
    """The run as a process: its modules hold no top-level ``jax``,
    ``jaxlib``, ``flax`` or ``tpu_rt`` (``tpu_rt_torch`` begins with
    ``tpu_rt``: names are compared whole)."""
    code = (
        "import sys, json\n"
        "from rtbench import run\n"
        "from rtbench.tests import tiny\n"
        "line = tiny.line('conference-ao8-frames')\n"
        "assert 'tpu_rt_torch' in sys.modules\n"
        "print(json.dumps({'found': run.forbidden_modules(), 'correct': line['correct']}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=paths.ROOT, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"found": [], "correct": True}
