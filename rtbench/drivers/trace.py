"""Driver ``trace``: the reference App's measurement loop (App.cc:188-204).

Set-up makes the mix's camera poses' batches with the port's ``RayGen``
(primary rays; for AO, the primary trace and then the AO batches of up to
``max_batch`` rays).  The window calls the routing tracer on those batches
back to back, cycling, with at most ``IN_FLIGHT`` calls queued, and counts
the reference's rays: W x H for a primary batch, its live rays (primary
hits x samples over a pose's batches) for an AO one.  ``mrays_per_s`` is
those rays over the window's wall time, from the first launch to the
final synchronize.

For the judge, each batch keeps the hits of its last call in the window,
and ``CHECK_RAYS`` of its rays drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from rtbench import profile
from rtbench.drivers import common
from rtbench.port import Port

IN_FLIGHT = 8  # routing calls queued at most in the window
HOST_CALLS = 200  # routing calls timed alone after the traced window
CHECK_RAYS = 2048  # judged rays of each batch


class Driver(common.Driver):
    def prepare(self):
        import torch

        from tpu_rt_torch.raygen import RayGen

        mix = self.mix
        if self.shared is None:
            self.shared = Port(self.mesh, self.config, self.device, self.spans)
        port = self.port = self.shared
        w, h = mix["width"], mix["height"]
        ao = mix["ray_type"] == "ao"
        self.any_hit = ao
        self.batches = []
        for p, cam in enumerate(self.cams):
            gen = RayGen(mix["max_batch"])
            rays, _, _ = gen.primary(self.port_cams[p], w, h, device=port.device)
            if not ao:
                self.batches.append({"pose": p, "lo": 0, "rays": rays, "count": w * h})
                continue
            hits = port.route(port.tables, rays, any_hit=False)
            first = True
            while True:
                out = gen.ao(rays, hits, port.tri_normal, mix["samples"], self.radius, first,
                             seed=self.ao_seed)
                first = False
                if out is None:
                    break
                batch, _, _, (lo, _) = out
                live = int((batch.tmax >= 0).sum())
                self.batches.append({"pose": p, "lo": lo, "rays": batch, "count": live})
        port.sync()
        # The judged rays of each batch, drawn from the seed.
        k = CHECK_RAYS
        for b in self.batches:
            n = b["rays"].num
            b["check"] = np.sort(self.rng.choice(n, size=min(k, n), replace=False))
        self.route = port.route
        self.tables = port.tables
        self.counts = [b["count"] for b in self.batches]
        self.rays = [b["rays"] for b in self.batches]
        # One pass over every batch warms each shape.
        for r in self.rays:
            self.route(self.tables, r, any_hit=self.any_hit)
        port.sync()
        self.events = [torch.cuda.Event() if port.device.type == "cuda" else None
                       for _ in range(IN_FLIGHT)]

    def _loop(self, seconds: float):
        """Back-to-back calls for ``seconds``, whole cycles over the batches;
        returns (calls, rays, wall s) and keeps each batch's last hits."""
        route, tables, rays, any_hit = self.route, self.tables, self.rays, self.any_hit
        nb = len(rays)
        events = self.events
        depth = IN_FLIGHT
        calls = counted = 0
        kept = [None] * nb
        self.port.sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            i = calls % nb
            kept[i] = route(tables, rays[i], any_hit=any_hit)
            counted += self.counts[i]
            ev = events[calls % depth]
            if ev is not None:
                ev.record()
            calls += 1
            if calls >= depth and events[calls % depth] is not None:
                events[calls % depth].synchronize()
            if i == nb - 1 and time.perf_counter() >= end:
                break
        self.port.sync()
        wall = time.perf_counter() - t0
        self.kept = kept
        return calls, counted, wall

    def window(self, seconds: float) -> dict:
        calls, counted, wall = self._loop(seconds)
        self.attempted = calls
        return {"mrays_per_s": counted / wall / 1e6}

    def traced(self, seconds: float, rec: dict) -> None:
        with profile.Profile(self.port.device) as prof:
            calls, _, _ = self._loop(seconds)
        nb = len(self.rays)
        passed = sum(self.rays[c % nb].num for c in range(calls))
        rec["counters"]["trace_calls"] = calls
        rec["counters"]["trace_rays"] = passed
        rec["trace"] = prof.summary
        # The wrapper's host cost: each call alone after a synchronize.
        spent = 0.0
        n = HOST_CALLS
        for c in range(n):
            self.port.sync()
            r = self.rays[c % nb]
            t0 = time.perf_counter()
            self.route(self.tables, r, any_hit=self.any_hit)
            spent += time.perf_counter() - t0
        self.port.sync()
        rec["spans"]["trace.host_s"] = spent
        rec["counters"]["trace.host_calls"] = n

    def outputs(self) -> dict:
        """The judged items and the program's answers, on the host."""
        items = {"pose": [], "slot": [], "sample": [], "batch": []}
        ans = {k: [] for k in ("origin", "dirn", "tmin", "tmax", "tri", "t")}
        s = self.mix["samples"] if self.any_hit else 1
        for j, b in enumerate(self.batches):
            idx = b["check"]
            items["pose"].append(np.full(len(idx), b["pose"]))
            items["batch"].append(np.full(len(idx), j))
            if self.any_hit:
                items["slot"].append(b["lo"] + idx // s)
                items["sample"].append(idx % s)
            else:
                items["slot"].append(idx)
                items["sample"].append(np.full(len(idx), -1))
            r = b["rays"]
            for k, x in zip(("origin", "dirn", "tmin", "tmax"), r):
                ans[k].append(common.host(x, idx))
            ans["tri"].append(common.host(self.kept[j].tri, idx).astype(np.int64))
            ans["t"].append(common.host(self.kept[j].t, idx))
        return ({k: np.concatenate(v) for k, v in items.items()},
                {k: np.concatenate(v) for k, v in ans.items()})

    def free(self):
        self.batches = self.rays = self.route = self.tables = self.kept = None
        self.port = self.shared = None

    def judge(self, ref, items, answers) -> dict:
        from rtbench.reference import judge

        return judge.judge_trace(ref, self.cams, self.mix, items, answers, self.ao_seed,
                                 self.radius)

    def control(self, ref, items):
        from rtbench.reference import control

        return control.trace_answers(ref, self.cams, self.mix, items, self.ao_seed, self.radius)

    def units(self, items) -> np.ndarray:
        return items["batch"]
