"""The port's HTTP orbit viewer (``tpu_rt_torch.bench.viewer``): the cases of
``tests/test_viewer.py`` on the CPU, ``/frame`` bytes equal to ``tpu_rt``'s
viewer's (PNG, and the BMP fallback), the request limits and the bound on
the renderers kept."""

import io
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_rt.bench import viewer as t_viewer
from tpu_rt.renderer import RendererParams as TParams
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc

from tpu_rt_torch.bench import viewer as p_viewer
from tpu_rt_torch.renderer import RendererParams as PParams
from tpu_rt_torch.scene import Scene as PScene
from tpu_rt_torch.scene import procedural as p_proc


def _serve(state, mod):
    srv = mod.make_server(state, port=0)  # ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    p_state = p_viewer.ViewerState(PScene(p_proc.make_blob(400, seed=12)), 64, 48,
                                   PParams(cache_dir=None, device="cpu"))
    t_state = t_viewer.ViewerState(TScene(t_proc.make_blob(400, seed=12)), 64, 48,
                                   TParams(cache_dir=None, tracer="xla"))
    (p_srv, p_url), (t_srv, t_url) = _serve(p_state, p_viewer), _serve(t_state, t_viewer)
    yield p_state, p_url, t_url
    for srv in (p_srv, t_srv):
        srv.shutdown()
        srv.server_close()


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.read(), r.headers


def _status(url):
    try:
        urllib.request.urlopen(url)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else None
    raise AssertionError("expected an error status")


def test_index_page(servers):
    _, url, t_url = servers
    body = _get(f"{url}/")[0]
    assert b"tpu_rt viewer" in body and b"/frame?" in body
    assert body == _get(f"{t_url}/")[0]


def test_frame_renders_and_orbits(servers):
    _, url, _ = servers
    img1, headers = _get(f"{url}/frame?yaw=0&pitch=0.3&dist=1")
    assert headers["Content-Type"] in ("image/png", "image/bmp")
    assert float(headers["X-Mrays-Per-S"]) > 0 and float(headers["X-Trace-Ms"]) >= 0
    # A different orbit angle produces a different image.
    assert _get(f"{url}/frame?yaw=2.0&pitch=0.3&dist=1")[0] != img1
    # Bad query -> 400 with a JSON error, not a crash.
    code, err = _status(f"{url}/frame?yaw=zzz")
    assert code == 400 and "error" in err
    assert _status(f"{url}/nothing")[0] == 404


def test_encode_image_roundtrip():
    from PIL import Image

    img = (np.random.default_rng(0).uniform(0, 255, (8, 10, 3))
           .astype(np.uint8))
    data, ctype = p_viewer._encode_image(img)
    assert ctype == "image/png"
    back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("encoder", ["png", "bmp"])
@pytest.mark.parametrize("query", ["yaw=0&pitch=0.3&dist=1",
                                   "yaw=1.3&pitch=-0.2&dist=0.8&w=40&h=30",
                                   "yaw=0.5&ray_type=ao&samples=2"])
def test_frame_bytes_equal_tpu_rt(servers, monkeypatch, encoder, query):
    _, url, t_url = servers
    if encoder == "bmp":
        # Pillow does not import: both viewers fall back to BMP.
        monkeypatch.setitem(sys.modules, "PIL", None)
    p_body, p_headers = _get(f"{url}/frame?{query}")
    t_body, t_headers = _get(f"{t_url}/frame?{query}")
    assert p_headers["Content-Type"] == t_headers["Content-Type"] == f"image/{encoder}"
    assert p_body == t_body


def test_bmp_fallback_decodes(servers, monkeypatch):
    state = servers[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    u8, _ = state.render(0.4, 0.2, 1.0)
    data, ctype = p_viewer._encode_image(u8)
    h, w, _ = u8.shape
    row = w * 3 + (-w * 3) % 4
    assert ctype == "image/bmp" and data[:2] == b"BM" and len(data) == 54 + h * row
    pix = np.frombuffer(data[54:], np.uint8).reshape(h, row)[::-1, :w * 3]
    np.testing.assert_array_equal(pix.reshape(h, w, 3)[..., ::-1], u8)


@pytest.mark.parametrize("query", ["w=100000", "h=-1", f"w={p_viewer.MAX_SIDE + 1}",
                                   f"samples={p_viewer.MAX_SAMPLES + 1}", "ray_type=shadow"])
def test_limits_give_400_without_a_renderer(servers, query):
    state, url, _ = servers
    kept = list(state._renderers)
    code, err = _status(f"{url}/frame?{query}")
    assert code == 400 and err["error"]
    assert list(state._renderers) == kept


def test_renderers_bounded_least_recently_used_out():
    state = p_viewer.ViewerState(PScene(p_proc.make_blob(200, seed=3)), 16, 12,
                                 PParams(cache_dir=None, device="cpu"))
    n = p_viewer.MAX_RENDERERS
    made = []
    for i in range(n + 2):
        state.render(w=16 + i, h=12)
        made.append(state._renderers[(16 + i, 12, "primary", 8)])
        # The first size is used again after each new one: it stays.
        state.render(w=16, h=12)
        assert len(state._renderers) == min(i + 1, n)
    assert list(state._renderers)[-1] == (16, 12, "primary", 8)
    evicted = [r for r in made if r not in state._renderers.values()]
    assert len(evicted) == 2 and made[0] not in evicted
    for r in evicted:
        assert r.tracer_tables is None and r.flat is None and r.primary is None
    assert str(state.device) == "cpu" and state.base.device == "cpu"
