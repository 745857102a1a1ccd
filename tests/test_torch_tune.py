"""The port's leaf-width tune tool (``tpu_rt_torch.bench.tune_quad``) and its
tune file: written under the port's own key, read back by ``quad_policy``
and the routing tracer, never mixed with ``tpu_rt``'s."""

import json
import os

import numpy as np
import pytest

from tpu_rt.trace import _tune_path as t_tune_path
from tpu_rt.trace import quad_policy as t_quad_policy

from tpu_rt_torch.bench import tune_quad
from tpu_rt_torch.bvh import load_or_build_bvh, load_or_collapse_quad
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import make_routing_tracer, upload_quad
from tpu_rt_torch.trace.tables import TABLE_BUDGET, _tune_path, quad_policy


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("tune_cache"))
    record = tune_quad.tune("knob", [4, 8], chain=1, repeats=1, cache_dir=cache, device="cpu",
                            width=32, height=24)
    flat, _ = load_or_build_bvh(Scene(procedural.scene_by_name("knob")), cache_dir=cache)
    return cache, record, flat


def test_tune_writes_the_ports_file(tuned):
    cache, record, flat = tuned
    path = _tune_path(flat, cache)
    assert os.path.basename(path).startswith("c") and os.path.exists(path)
    assert not os.path.exists(t_tune_path(flat, cache))
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk == record
    assert set(record) == {"scene", "leaf_max", "best_ms", "ms", "candidates", "device"}
    assert record["scene"] == "knob" and record["candidates"] == [4, 8]
    assert record["device"] == "cpu" and set(record["ms"]) == {"4", "8"}
    assert record["leaf_max"] in (4, 8)
    assert record["best_ms"] == min(record["ms"].values()) == record["ms"][str(record["leaf_max"])]
    assert not [f for f in os.listdir(cache) if ".tmp" in f]


def test_routing_collapses_at_the_tuned_width(tuned):
    cache, record, flat = tuned
    width = record["leaf_max"]
    assert quad_policy(flat, cache, TABLE_BUDGET) == width
    assert quad_policy(flat, None, TABLE_BUDGET) == 16
    # tpu_rt does not read the port's file.
    assert t_quad_policy(flat, cache) == 16
    _, kind, tables = make_routing_tracer(flat, "auto", device="cpu", cache_dir=cache)
    assert kind == "quad-plain"
    for lm in (4, 8):
        want = upload_quad(load_or_collapse_quad(flat, leaf_max=lm, cache_dir=cache), "cpu")
        same = (tables.nodes.shape == want.nodes.shape
                and np.array_equal(tables.nodes.numpy().view(np.int32),
                                   want.nodes.numpy().view(np.int32)))
        assert same == (lm == width), lm


def test_tune_refuses_widths_a_link_cannot_hold(tmp_path):
    for bad in (0, 128):
        with pytest.raises(ValueError, match="not in \\[1, 127\\]"):
            tune_quad.tune("knob", [16, bad], cache_dir=str(tmp_path), device="cpu",
                           width=8, height=6)


def test_main_passes_its_flags(monkeypatch):
    calls = []
    monkeypatch.setattr(tune_quad, "tune", lambda *a: calls.append(a))
    assert tune_quad.main(["bunny", "dragon", "--candidates", "16,32", "--chain", "4",
                           "--repeats", "2", "--cache-dir", "c", "--device", "cpu"]) == 0
    assert calls == [("bunny", [16, 32], 4, 2, "c", "cpu"), ("dragon", [16, 32], 4, 2, "c", "cpu")]
    calls.clear()
    tune_quad.main([])
    assert calls == [(n, None, 16, 3, "bvhcache", "cuda") for n in tune_quad.DEFAULT_SCENES]
