"""What every driver shares: the scene's mesh, the camera poses and AO seed
drawn from the run's seed, and the host copies of judged values.

A driver module defines ``Driver(common.Driver)`` with ``prepare`` (set up
the program under the cell's set-up spans, then make and warm up the
cell's work; it leaves in ``shared`` what a later driver of the same cell
may take in place of that set-up, as ``calibrate`` does over seeds),
``window(seconds)`` (the measured loop; returns the end-to-end metrics),
``traced(seconds, record)`` (a loop under the profiler, for the per-layer
metrics), ``outputs`` (the judged items and the program's answers, on the
host), ``free``, ``judge(ref, items, answers)``, ``control(ref, items)``
(the control's answers for the same items) and ``units(items)`` (which call
or frame each item came from).
"""

from __future__ import annotations

import numpy as np

from rtbench.data import workload
from rtbench.port import camera, load_mesh


def host(x, idx) -> np.ndarray:
    import torch

    return x[torch.as_tensor(idx, device=x.device)].double().cpu().numpy()


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: str, spans: dict,
                 counters: dict, shared=None):
        import torch

        self.config, self.mix = config, mix
        self.device = torch.device(device)
        self.shared = shared
        self.spans, self.counters = spans, counters
        ss = np.random.SeedSequence(int(seed))
        pose_ss, ao_ss, check_ss = ss.spawn(3)
        self.ao_seed = int(np.random.default_rng(ao_ss).integers(0, 2**32))
        self.rng = np.random.default_rng(check_ss)
        self.mesh = load_mesh(config)
        pos = self.mesh.positions
        self.cams = workload.camera_poses(config["scene"], pos, dict(config["camera"],
                                          count=mix["poses"]), np.random.default_rng(pose_ss))
        self.radius = workload.suite_ao_radius(config["scene"], pos)
        self.port_cams = [camera(c) for c in self.cams]
        self.attempted = 0

    def reference_scene(self, dtype, device):
        from rtbench.reference import control, judge

        m = self.mesh
        idx = m.flat_indices()
        if str(dtype) == "torch.bfloat16":
            return control.scene(m.positions, idx, m.tri_diffuse(), device)
        return judge.RefScene.build(m.positions, idx, m.tri_diffuse(), dtype, device)
