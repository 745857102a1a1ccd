"""Every configuration, mix, driver, metric and limits file is found by
the name ``BENCHMARK.json`` gives it, and the file keeps the contract's
shape."""

import json
import os
import re

import pytest

from rtbench import paths, run

BENCH = run.load_json(paths.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
EMPTY = {"spans": {}, "counters": {}, "trace": {}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert BENCH["command"][:3] == ["python3", "-m", "rtbench.run"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"] == f"rtbench/configs/{conf['name']}.json"
    cfg = run.load_json(paths.ROOT, conf["file"])
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"] == []


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    spec = run.resolve(BENCH, cell["name"])
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    assert os.path.exists(os.path.join(paths.BENCH_DIR, "drivers",
                                       f"{spec['mix']['driver']}.py"))
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    moved = {m["moves"] for m in spec["per_layer"]}
    assert spec["per_layer"] and moved <= names


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        ends = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in ends
        mine = set(metric.get("workloads", cells))
        assert mine <= set(ends[metric["moves"]].get("workloads", cells))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_and_silent_on_nothing(metric):
    reader = run.load_module("metrics", metric["name"])
    assert reader.read(EMPTY) is None


def test_roofline_reader():
    reader = run.load_module("metrics", "trace_kernels_roofline")
    rec = {"spans": {}, "counters": {"trace_rays": 1_000_000},
           "trace": {"device_ops": {"void quad_trace_kernel<true>(TraceArgs)": 0.001,
                                    "elementwise_kernel": 5.0}}}
    assert reader.read(rec) == pytest.approx(4e7 / 3.35e12 / 0.001 * 100)


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert "device" in by_layer


def test_every_file_found_by_a_name():
    """No configuration, mix, metric or limits file is left without a name
    that finds it."""
    named = {"configs": {c["name"] for c in BENCH["configs"]},
             "traffic": {w["traffic"] for w in BENCH["workloads"]},
             "limits": {w["name"] for w in BENCH["workloads"]},
             "metrics": {m["name"] for m in BENCH["per_layer"]}}
    for kind, names in named.items():
        files = {f.rsplit(".", 1)[0] for f in os.listdir(os.path.join(paths.BENCH_DIR, kind))
                 if not f.startswith("_") and f.endswith((".json", ".py"))}
        assert files == names, kind
