"""Calls into the program under test, ``tpu_rt_torch``, through its public
API (``Scene``, ``Camera``, ``Renderer``, ``RayGen``, ``load_or_build_bvh``,
``make_routing_tracer``), with the benchmark's set-up spans around them.

The port is imported here and in the drivers, never by the reference.
The trace cells' set-up is ``Port``; the frame cells' is the renderer's own
(``drivers/frames.py``).
"""

from __future__ import annotations

import os
import time

import numpy as np

from rtbench import paths
from rtbench.data import procedural


def load_mesh(config: dict) -> procedural.Mesh:
    """The configuration's scene from its frozen generator, cached in
    ``build/rtbench/meshes`` by generator, seed and triangle count."""
    gen = config["generator"]
    key = "-".join([gen["name"]] + [f"{k}{v}" for k, v in sorted(gen["args"].items())])
    path = os.path.join(paths.MESH_DIR, f"{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            splits = np.cumsum(z["splits"])[:-1]
            return procedural.Mesh(z["positions"], np.split(z["indices"], splits),
                                   list(z["diffuse"]), list(z["names"]))
    mesh = procedural.GENERATORS[gen["name"]](**gen["args"])
    os.makedirs(paths.MESH_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, positions=mesh.positions, indices=mesh.flat_indices(),
             splits=np.array([len(s) for s in mesh.submeshes]),
             diffuse=np.stack(mesh.diffuse), names=np.array(mesh.names))
    os.replace(tmp, path)
    return mesh


def port_mesh(mesh: procedural.Mesh):
    from tpu_rt_torch.scene import Material, Mesh

    return Mesh(positions=mesh.positions, normals=None, texcoords=None,
                submeshes=list(mesh.submeshes),
                materials=[Material(name=str(n), diffuse=np.asarray(d, np.float32))
                           for n, d in zip(mesh.names, mesh.diffuse)])


def camera(cam: dict):
    from tpu_rt_torch.scene import Camera

    return Camera(position=cam["position"], forward=cam["forward"], up=cam["up"],
                  fov=cam["fov"], near=cam["near"], far=cam["far"])


class Port:
    """The port's scene, tree and routing tracer for one configuration (the
    trace cells' set-up), with the spans ``setup.bvh_s`` (scene tables and the SBVH, built or
    loaded from the cache) and ``setup.kernels_s`` (the routing tracer:
    quad collapse, tables on the device, and its first launch, which
    builds or loads the kernel library)."""

    def __init__(self, mesh: procedural.Mesh, config: dict, device: str, spans: dict):
        import torch

        from tpu_rt_torch.bvh import BuildParams, Platform, load_or_build_bvh
        from tpu_rt_torch.core.types import make_rays
        from tpu_rt_torch.scene import Scene
        from tpu_rt_torch.trace import make_routing_tracer

        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.scene = Scene(port_mesh(mesh))
        self.flat, _ = load_or_build_bvh(self.scene, Platform.gpu(), BuildParams(),
                                         cache_dir=paths.BVH_DIR)
        spans["setup.bvh_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.route, self.kind, self.tables = make_routing_tracer(
            self.flat, prefer=config["tracer"], device=self.device, cache_dir=paths.BVH_DIR)
        lo, hi = self.scene.bbox()
        probe = make_rays(np.tile((lo + hi) * 0.5, (32, 1)),
                          np.tile([0.0, 1.0, 0.0], (32, 1)), np.zeros(32),
                          np.full(32, 1e30), device=self.device)
        self.route(self.tables, probe, any_hit=False)
        self.sync()
        spans["setup.kernels_s"] = time.perf_counter() - t0
        self.tri_normal = torch.as_tensor(self.scene.tri_normal, device=self.device)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
