"""The port's host I/O copies are bit-equal to tpu_rt's on the same inputs:
image.py (formats, blit, PPM / npy files), scene/objio.py (OBJ / MTL import
with both engines, export, the Mesh methods), core/math.py's halton2,
halton3 and from_abgr, core/types.py's concat_rays and bvh/flatten.py's
node_links and validate_flat_bvh.  The cases mirror tests/test_image.py,
tests/test_scene.py and tests/test_core_math.py; files written by the two
packages must hold the same bytes."""

import numpy as np
import pytest
import torch

import tpu_rt.core.math as t_math
from tpu_rt.bvh import build_sbvh as t_build_sbvh
from tpu_rt.bvh import flatten_bvh as t_flatten_bvh
from tpu_rt.bvh.flatten import node_links as t_node_links
from tpu_rt.bvh.flatten import validate_flat_bvh as t_validate
from tpu_rt.image import Image as TImage
from tpu_rt.image import ImageFormat as TFormat
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import export_wavefront_mesh as t_export
from tpu_rt.scene import import_wavefront_mesh as t_import
from tpu_rt.scene import procedural as t_proc
from tpu_rt.scene.objio import Material as TMaterial
from tpu_rt.scene.objio import Mesh as TMesh

import tpu_rt_torch.core.math as p_math
from tpu_rt_torch.bvh import build_sbvh, flatten_bvh
from tpu_rt_torch.bvh.flatten import node_links, validate_flat_bvh
from tpu_rt_torch.core import concat_rays, make_rays
from tpu_rt_torch.image import Image, ImageFormat
from tpu_rt_torch.scene import Scene, export_wavefront_mesh, import_wavefront_mesh, procedural
from tpu_rt_torch.scene.objio import Material, Mesh

OBJ_TEXT = """
# demo object
mtllib demo.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
f 1 3 4
usemtl blue
f -5/-3 -4/-2 -1/-1
f 1 2 3 4
"""

MTL_TEXT = """
newmtl red
Kd 1 0 0
Ns 10
newmtl blue
Kd 0 0 1
d 0.5
"""


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def meshes_equal(a, b) -> None:
    """Every array and material field bit for bit."""
    for name in ("positions", "normals", "texcoords"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        assert x is None or bits_equal(x, y), name
    assert len(a.submeshes) == len(b.submeshes)
    assert all(bits_equal(x, y) for x, y in zip(a.submeshes, b.submeshes))
    assert len(a.materials) == len(b.materials)
    for x, y in zip(a.materials, b.materials):
        assert (x.name, x.glossiness, x.displacement_coef, x.displacement_bias, x.textures) == (
            y.name, y.glossiness, y.displacement_coef, y.displacement_bias, y.textures)
        assert bits_equal(x.diffuse, y.diffuse) and bits_equal(x.specular, y.specular)


# -- image.py (tests/test_image.py) -----------------------------------------

@pytest.fixture
def rgba():
    return np.random.default_rng(3).random((13, 17, 4)).astype(np.float32)


def test_formats_are_tpu_rts():
    assert [(f.name, f.value, f.bpp, f.has_alpha) for f in ImageFormat] == [
        (f.name, f.value, f.bpp, f.has_alpha) for f in TFormat]


@pytest.mark.parametrize("name", [f.name for f in TFormat])
def test_format_roundtrip(rgba, name):
    img, t_img = Image.from_rgba(rgba), TImage.from_rgba(rgba)
    packed = img.convert(ImageFormat[name])
    assert bits_equal(packed, t_img.convert(TFormat[name]))
    back = Image.from_format(ImageFormat[name], packed)
    assert bits_equal(back.data, TImage.from_format(TFormat[name], packed).data)
    assert (back.width, back.height) == (img.width, img.height)


def test_abgr_matches_core_helper(rgba):
    packed = Image.from_rgba(rgba).convert(ImageFormat.ABGR_8888)
    assert bits_equal(packed, p_math.to_abgr(rgba))
    assert bits_equal(packed, t_math.to_abgr(rgba))


def _blits(image_cls):
    dst = image_cls(8, 6)
    dst.clear((0.5, 0.5, 0.5, 1.0))
    src = image_cls.from_rgba(np.ones((4, 4, 4), np.float32))
    dst.blit(src, dx=-2, dy=-2)
    dst.blit(src, dx=6, dy=4)
    dst.blit(src, dx=100, dy=0)
    dst2 = image_cls(8, 6)
    dst2.blit(src, dx=1, dy=1, sx=2, sy=2, w=2, h=2)
    return dst.data, dst2.data


def test_blit_clipping():
    (a, a2), (b, b2) = _blits(Image), _blits(TImage)
    assert bits_equal(a, b) and bits_equal(a2, b2)
    assert a[0, 0, 0] == 1.0 and a[2, 2, 0] == 0.5 and a[5, 7, 0] == 1.0
    assert a2[2, 2, 0] == 1.0 and a2[3, 3, 0] == 0.0


@pytest.mark.parametrize("fmt", ["ppm", "npy"])
def test_file_roundtrip(rgba, tmp_path, fmt):
    """The files written hold tpu_rt's bytes; PPM reads back as tpu_rt's."""
    p, q = tmp_path / f"port.{fmt}", tmp_path / f"tpu_rt.{fmt}"
    getattr(Image.from_rgba(rgba), f"to_{fmt}")(str(p))
    getattr(TImage.from_rgba(rgba), f"to_{fmt}")(str(q))
    assert p.read_bytes() == q.read_bytes()
    if fmt == "ppm":
        back = Image.from_ppm(str(p))
        assert bits_equal(back.data, TImage.from_ppm(str(q)).data)
        np.testing.assert_allclose(back.data[..., :3], rgba[..., :3], atol=1 / 255)
    assert bits_equal(Image.from_rgba(rgba).flip_y().data, rgba[::-1])


def test_ppm_comments_and_maxval(rgba, tmp_path):
    p = tmp_path / "c.ppm"
    Image.from_rgba(rgba).to_ppm(str(p))
    magic, rest = p.read_bytes().split(b"\n", 1)
    p.write_bytes(magic + b"\n# a comment\n# another\n" + rest)
    assert bits_equal(Image.from_ppm(str(p)).data, TImage.from_ppm(str(p)).data)
    wide = tmp_path / "wide.ppm"
    wide.write_bytes(b"P6\n2 2\n65535\n" + bytes(24))
    with pytest.raises(ValueError, match="2-byte"):
        Image.from_ppm(str(wide))


def test_pixel_accessors():
    im, t_im = Image(4, 4), TImage(4, 4)
    for x in (im, t_im):
        x.set_pixel(2, 1, (0.25, 0.5, 0.75, 1.0))
    assert bits_equal(im.get_pixel(2, 1), t_im.get_pixel(2, 1))
    assert bits_equal(im.data, t_im.data)
    np.testing.assert_allclose(im.get_pixel(2, 1), [0.25, 0.5, 0.75, 1.0])


# -- scene/objio.py (tests/test_scene.py) ------------------------------------

@pytest.fixture
def obj_path(tmp_path):
    (tmp_path / "demo.obj").write_text(OBJ_TEXT)
    (tmp_path / "demo.mtl").write_text(MTL_TEXT)
    return str(tmp_path / "demo.obj")


@pytest.mark.parametrize("engine", ["auto", "numpy", "scalar"])
def test_obj_import(obj_path, engine):
    mesh = import_wavefront_mesh(obj_path, engine=engine)
    meshes_equal(mesh, t_import(obj_path, engine=engine))
    assert len(mesh.submeshes) == 2 and mesh.submeshes[1].shape[0] == 3
    assert mesh.materials[0].name == "red" and mesh.materials[1].diffuse[3] == 0.5
    # The numpy engine equals the scalar one (test_obj_numpy_engine_matches_scalar).
    meshes_equal(mesh, import_wavefront_mesh(obj_path, engine="scalar"))


def test_obj_texcoord_v_flip(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.25 0.25\nf 1/1 2/1 3/1\n")
    mesh = import_wavefront_mesh(str(p))
    meshes_equal(mesh, t_import(str(p)))
    np.testing.assert_allclose(mesh.texcoords[0], [0.25, 0.75])


@pytest.mark.parametrize("source", ["demo", "blob"])
def test_obj_export_roundtrip(tmp_path, obj_path, source):
    """The exported file holds tpu_rt's bytes, and reads back as tpu_rt's
    reads it back; the scene built from it is tpu_rt's."""
    if source == "demo":
        mesh, t_mesh = import_wavefront_mesh(obj_path), t_import(obj_path)
    else:
        mesh, t_mesh = procedural.make_blob(2000, seed=5), t_proc.make_blob(2000, seed=5)
    (tmp_path / "port").mkdir()
    (tmp_path / "tpu_rt").mkdir()
    p, q = tmp_path / "port" / "x.obj", tmp_path / "tpu_rt" / "x.obj"
    export_wavefront_mesh(mesh, str(p))
    t_export(t_mesh, str(q))
    for name in ("x.obj", "x.mtl"):
        assert (p.parent / name).read_bytes() == (q.parent / name).read_bytes(), name
    back = import_wavefront_mesh(str(p))
    meshes_equal(back, t_import(str(q)))
    assert back.num_triangles == mesh.num_triangles
    s, ts = Scene(back), TScene(t_import(str(q)))
    assert bits_equal(s.vtx_pos, ts.vtx_pos) and bits_equal(s.tri_vtx_index, ts.tri_vtx_index)
    assert s.hash() == ts.hash()


def _clean_case(mesh_cls, mat_cls):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]], np.float32)
    subs = [np.array([[0, 1, 2], [0, 0, 2]], np.int32), np.array([[1, 1, 1]], np.int32)]
    return mesh_cls(pos, None, None, subs, [mat_cls(), mat_cls()])


def _collapse_case(mesh_cls, mat_cls):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    return mesh_cls(pos, None, None, [np.array([[0, 1, 2], [3, 5, 4]], np.int32)], [mat_cls()])


def _grid_case(mesh_cls, mat_cls):
    n = 17
    g = np.linspace(0, 1, n, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel(), np.zeros(n * n, np.float32)], 1)
    tris = [t for i in range(n - 1) for j in range(n - 1) for t in (
        [i * n + j, i * n + j + 1, i * n + j + n], [i * n + j + 1, i * n + j + n + 1, i * n + j + n])]
    return mesh_cls(pos, None, None, [np.array(tris, np.int32)], [mat_cls()])


@pytest.mark.parametrize("method", ["clean", "collapse_vertices", "simplify", "recompute_normals"])
def test_mesh_methods(method):
    """test_scene.py's clean / collapse / simplify cases (and the normals
    simplify recomputes) give tpu_rt's mesh, bit for bit."""
    case = {"clean": _clean_case, "collapse_vertices": _collapse_case}.get(method, _grid_case)
    mesh, t_mesh = case(Mesh, Material), case(TMesh, TMaterial)
    before = mesh.num_triangles
    args = (0.08,) if method == "simplify" else ()
    getattr(mesh, method)(*args)
    getattr(t_mesh, method)(*args)
    meshes_equal(mesh, t_mesh)
    if method == "clean":
        assert len(mesh.submeshes) == 1 and mesh.num_vertices == 3
    elif method == "collapse_vertices":
        assert mesh.num_vertices == 4 and mesh.num_triangles == 2
    elif method == "simplify":
        assert 0 < mesh.num_triangles < before


# -- core/math.py (tests/test_core_math.py), core/types.py, bvh/flatten.py ---

@pytest.mark.parametrize("fn", ["halton2", "halton3"])
def test_halton_bit_equal(fn):
    idx = np.concatenate([np.arange(4096), [2**24 - 1, 2**31, 2**32 - 2]]).astype(np.uint32)
    got = getattr(p_math, fn)(idx)
    assert bits_equal(got, getattr(t_math, fn)(idx, xp=np))
    v = got[:1000]
    assert (v >= 0).all() and (v < 1).all() and abs(float(np.mean(v)) - 0.5) < 0.01


def test_abgr_roundtrip():
    rgba = np.array([[0, 0, 0, 0], [1, 1, 1, 1], [0.5, 0.25, 0.75, 1.0],
                     [1.2, -0.5, 0.999, 0.001]], np.float32)
    packed = p_math.to_abgr(rgba)
    assert packed[0] == 0 and packed[1] == 0xFFFFFFFF and (packed[2] & 0xFF) == 128
    words = np.random.default_rng(9).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for x in (packed, words, words[0]):
        assert bits_equal(p_math.from_abgr(x), t_math.from_abgr(x, xp=np))
    np.testing.assert_allclose(p_math.from_abgr(packed)[2], [0.5, 0.25, 0.75, 1.0], atol=1 / 255)


def test_concat_rays():
    rng = np.random.default_rng(4)
    a, b = (make_rays(rng.random((n, 3)), rng.random((n, 3)), rng.random(n), rng.random(n),
                      device="cpu") for n in (5, 3))
    c = concat_rays(a, b)
    assert c.num == 8
    for x, y, z in zip(c, a, b):
        assert torch.equal(x, torch.cat([y, z]))


@pytest.mark.parametrize("name", ["blob", "interior"])
def test_validate_flat_bvh_and_node_links(name):
    make = {"blob": lambda m: m.make_blob(700, seed=80),
            "interior": lambda m: m.make_interior(900, seed=81)}[name]
    scene, t_scene = Scene(make(procedural)), TScene(make(t_proc))
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    t_flat = t_flatten_bvh(t_build_sbvh(t_scene), t_scene.tri_vtx_index, t_scene.vtx_pos)
    assert bits_equal(node_links(flat), t_node_links(t_flat))
    validate_flat_bvh(flat, scene.num_triangles)
    t_validate(t_flat, t_scene.num_triangles)
    # A link out of range, or a triangle no leaf reaches, is refused.
    bad = flat._replace(nodes=flat.nodes.copy())
    bad.nodes[0, 12:13] = np.array([flat.num_nodes], np.int32).view(np.float32)
    with pytest.raises(AssertionError):
        validate_flat_bvh(bad, scene.num_triangles)
    with pytest.raises(AssertionError, match="unreachable"):
        validate_flat_bvh(flat, scene.num_triangles + 1)
