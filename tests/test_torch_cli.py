"""The port's command-line app (``tpu_rt_torch.bench.cli``) against
``tpu_rt.bench.cli``: the parser, cookbook replay, the ``--json`` / ``--log``
result, the ``--image`` files byte for byte, ``--mesh``, the errors, and
``Renderer.set_build_params``."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from tpu_rt.bench import cli as t_cli
from tpu_rt.bench.workload import suite_camera as t_suite_camera
from tpu_rt.bvh import BuildParams as TBuildParams
from tpu_rt.renderer import Renderer as TRenderer
from tpu_rt.renderer import RendererParams as TParams
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc

from tpu_rt_torch.bench import cli as p_cli
from tpu_rt_torch.bench.workload import suite_camera as p_suite_camera
from tpu_rt_torch.bvh import BuildParams as PBuildParams
from tpu_rt_torch.renderer import Renderer as PRenderer
from tpu_rt_torch.renderer import RendererParams as PParams
from tpu_rt_torch.scene import Scene as PScene
from tpu_rt_torch.scene import export_wavefront_mesh
from tpu_rt_torch.scene import procedural as p_proc

# The camera of the conference line of the reference's cookbook (grtcmdline.txt).
CONFERENCE_CAMERA = "6omr/04j3200bR6Z/0/3ZEAz/x4smy19///c/05frY109Qx7w////m100"
SMALL = ["--size", "64x48", "--warmup-repeats", "0", "--measure-repeats", "1"]


def _knob_camera() -> str:
    scene = PScene(p_proc.scene_by_name("knob"))
    return p_suite_camera("knob", scene).encode_signature().strip(",").strip('"')


@pytest.fixture(scope="module")
def cookbook(tmp_path_factory):
    knob = _knob_camera()
    lines = [
        "##conference",
        f'--mesh=scenes/rt/conference/conference.obj --camera="{CONFERENCE_CAMERA}" '
        "--sbvh-alpha=1.0e-5 --ao-radius=5",
        "",
        "##mori knob",
        f'--mesh=scenes/rt_2/mori_knob/testObj.obj --camera="{knob}" '
        "--sbvh-alpha=1.0e-5 --ao-radius=0.5",
        "##sibenik",
        f'--mesh=scenes/rt/sibenik/sibenik.obj --camera="{CONFERENCE_CAMERA}" '
        "--sbvh-alpha=1.0e-6 --ao-radius=5",
        "##cornell box",
        f'--mesh=scenes/cornellbox/cornellbox.obj --camera="{knob}" --sbvh-alpha=1.0e-5',
    ]
    path = tmp_path_factory.mktemp("grt") / "grtcmdline.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_parser_equals_tpu_rt():
    t_acts, p_acts = _actions(t_cli.build_parser()), _actions(p_cli.build_parser())
    assert set(p_acts) == set(t_acts) | {"device"}
    for dest, t in t_acts.items():
        p = p_acts[dest]
        assert p.option_strings == t.option_strings, dest
        assert (p.default, p.choices, p.type, p.nargs, p.const, p.metavar) == (
            t.default, t.choices, t.type, t.nargs, t.const, t.metavar), dest
        assert type(p) is type(t), dest
        assert p.help == (t.help and t.help.replace("tpu_rt.", "tpu_rt_torch.")), dest
    dev = p_acts["device"]
    assert dev.option_strings == ["--device"] and dev.default == "cuda"
    assert dev.choices == ("cuda", "cpu")
    assert t_acts["tracer"].choices == p_acts["tracer"].choices == ("auto", "pallas", "xla")
    assert p_cli.GRT_SURROGATES == t_cli.GRT_SURROGATES


def _replay(mod, argv):
    parser = mod.build_parser()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        args = mod.apply_grt(parser, parser.parse_args(argv), argv)
    return vars(args), out.getvalue()


@pytest.mark.parametrize("line", [1, 2, 3])
def test_apply_grt_equals_tpu_rt(cookbook, line):
    assert p_cli.grt_flag_lines(cookbook) == t_cli.grt_flag_lines(cookbook)
    argv = ["--grt-file", cookbook, "--grt-line", str(line)]
    (p_args, p_out), (t_args, t_out) = _replay(p_cli, argv), _replay(t_cli, argv)
    assert p_args.pop("device") == "cuda"
    assert p_args == t_args and p_out == t_out
    assert p_args["mesh"] is None
    assert p_args["scene"] == ("conference", "knob", "sibenik")[line - 1]
    assert p_args["sbvh_alpha"] == (1.0e-6 if line == 3 else 1.0e-5)


def test_apply_grt_refusals_equal_tpu_rt(cookbook, capsys):
    # No surrogate for the Cornell box; an index out of range; no index:
    # the lines are listed.
    cases = {"4": "no procedural surrogate for 'cornellbox'", "5": "--grt-line must be 1..4",
             None: "4 replayable lines; pick --grt-line=N"}
    for line, want in cases.items():
        argv = ["--grt-file", cookbook] + ([] if line is None else ["--grt-line", line])
        texts = []
        for mod in (p_cli, t_cli):
            parser = mod.build_parser()
            with pytest.raises(SystemExit) as e:
                mod.apply_grt(parser, parser.parse_args(argv), argv)
            texts.append((str(e.value), capsys.readouterr().out))
        assert texts[0] == texts[1] and want in texts[0][0]
    assert texts[0][1].splitlines()[0].startswith("  1: --mesh=scenes/rt/conference")
    with pytest.raises(SystemExit, match="no procedural surrogate"):
        p_cli.main(["--grt-file", cookbook, "--grt-line", "4", "--device", "cpu"])


def test_apply_grt_user_flags_win(cookbook):
    argv = ["--grt-file", cookbook, "--grt-line", "1", "--size", "64x48", "--ray-type", "ao",
            "--camera", "extra", "--device", "cpu"]
    args, _ = _replay(p_cli, argv)
    assert args["size"] == "64x48" and args["ray_type"] == "ao" and args["device"] == "cpu"
    assert args["scene"] == "conference" and args["ao_radius"] == 5.0
    assert args["camera"] == [CONFERENCE_CAMERA, "extra"]


def test_main_replays_knob_line_on_cpu(cookbook, capsys):
    rc = p_cli.main(["--grt-file", cookbook, "--grt-line", "2", *SMALL, "--device", "cpu",
                     "--cache-dir", ""])
    out = capsys.readouterr().out
    assert rc == 0
    assert "grt replay: scenes/rt_2/mori_knob/testObj.obj -> procedural surrogate 'knob'" in out
    rate = [ln for ln in out.splitlines() if ln.startswith("Results = ")]
    assert len(rate) == 1 and rate[0].endswith(" M Rays/s")


def _run(mod, argv, capsys):
    mod.main(argv)
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    return {"t": str(tmp_path_factory.mktemp("t_cache")),
            "p": str(tmp_path_factory.mktemp("p_cache"))}


@pytest.mark.parametrize("ray_type,ext", [("primary", "ppm"), ("ao", "ppm"),
                                          ("primary", "npy"), ("ao", "npy")])
def test_json_and_image_equal_tpu_rt(tmp_path, caches, capsys, ray_type, ext):
    flags = ["--scene", "knob", *SMALL, "--ray-type", ray_type, "--samples", "4",
             "--ao-radius", "0.5", "--json"]
    t_img, p_img = str(tmp_path / f"t.{ext}"), str(tmp_path / f"p.{ext}")
    t_res = _run(t_cli, flags + ["--tracer", "xla", "--cache-dir", caches["t"],
                                 "--image", t_img], capsys)
    p_res = _run(p_cli, flags + ["--device", "cpu", "--cache-dir", caches["p"],
                                 "--image", p_img], capsys)
    for key in ("total_rays", "rays_traced_per_frame", "ray_type", "size", "tris", "bvh"):
        assert p_res[key] == t_res[key], key
    assert set(p_res) == set(t_res)
    assert p_res["tracer"] == "quad-plain" and p_res["mrays_per_s"] > 0
    with open(t_img, "rb") as f, open(p_img, "rb") as g:
        assert f.read() == g.read()
    if ext == "npy":
        img = np.load(p_img)
        assert img.shape == (48, 64, 4) and len(np.unique(img.reshape(-1, 4), axis=0)) > 2


def test_log_appends_one_json_line(tmp_path, caches, capsys):
    log = tmp_path / "run.log"
    log.write_text('{"earlier": 1}\n')
    res = _run(p_cli, ["--scene", "knob", *SMALL, "--device", "cpu", "--cache-dir",
                       caches["p"], "--log", str(log), "--json"], capsys)
    lines = log.read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0]) == {"earlier": 1}
    assert json.loads(lines[1]) == res


def test_mesh_flag_loads_an_obj(tmp_path, capsys):
    mesh = p_proc.make_blob(300, seed=5)
    path = str(tmp_path / "blob.obj")
    export_wavefront_mesh(mesh, path)
    res = _run(p_cli, ["--mesh", path, *SMALL, "--device", "cpu", "--cache-dir", "",
                       "--json"], capsys)
    t_res = _run(t_cli, ["--mesh", path, *SMALL, "--tracer", "xla", "--cache-dir", "",
                         "--json"], capsys)
    assert res["tris"] == PScene(mesh).num_triangles == t_res["tris"]
    assert res["bvh"] == t_res["bvh"] and res["total_rays"] == 64 * 48


@pytest.mark.parametrize("argv", [[], ["--scene", "knob", "--size", "64by48"],
                                  ["--serve"]])
def test_errors_equal_tpu_rt(argv):
    texts = []
    for mod in (p_cli, t_cli):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert texts[0] in ("specify --mesh=<file.obj> or --scene=<name>",
                        "--size expects WxH, got '64by48'")


@pytest.mark.parametrize("name", ["knob", "blob"])
def test_set_build_params_equals_tpu_rt(name):
    make = {"knob": lambda proc: proc.scene_by_name("knob"),
            "blob": lambda proc: proc.make_blob(700, seed=80)}[name]
    t_scene, p_scene = TScene(make(t_proc)), PScene(make(p_proc))
    t_r = TRenderer(64, 48, TParams(tracer="xla", cache_dir=None))
    p_r = PRenderer(64, 48, PParams(tracer="xla", cache_dir=None, device="cpu"))
    t_r.set_scene(t_scene)
    p_r.set_scene(p_scene)
    p_cam = p_suite_camera("bunny", p_scene)
    p_r.render_frame(p_cam)
    before = (p_r.flat, p_r.tracer_tables, p_r._tri_shaded_dev, p_r.bvh_stats)
    t_r.set_build_params(TBuildParams(split_alpha=1e-6))
    p_r.set_build_params(PBuildParams(split_alpha=1e-6))
    assert p_r.build_params == PBuildParams(split_alpha=1e-6)
    assert p_r.flat is None and p_r.bvh_stats is None and p_r.tracer_tables is None
    t_r.render_frame(t_suite_camera("bunny", t_scene))
    p_r.render_frame(p_cam)
    after = (p_r.flat, p_r.tracer_tables, p_r._tri_shaded_dev, p_r.bvh_stats)
    assert all(a is not b for a, b in zip(before, after))
    assert dataclasses.asdict(p_r.bvh_stats) == dataclasses.asdict(t_r.bvh_stats)
    np.testing.assert_array_equal(p_r.flat.nodes, np.asarray(t_r.flat.nodes))
    np.testing.assert_array_equal(p_r.update_result_u32(), t_r.update_result_u32())


@pytest.mark.parametrize("residency,releases", [("mixed", 1), ("vmem", 0)])
def test_dropping_mixed_tables_releases_the_l2_window(monkeypatch, residency, releases):
    import types

    import tpu_rt_torch.renderer as p_renderer

    calls = []
    monkeypatch.setattr(p_renderer, "release_persisting_l2", lambda: calls.append(1))
    r = PRenderer(8, 6, PParams(cache_dir=None, device="cpu"))
    r.tracer_tables = types.SimpleNamespace(residency=residency)
    r.set_build_params(PBuildParams(split_alpha=1e-6))
    assert r.tracer_tables is None and len(calls) == releases
    r.tracer_tables = types.SimpleNamespace(residency=residency)
    r.free()
    assert r.tracer_tables is None and r.primary is None and len(calls) == 2 * releases
