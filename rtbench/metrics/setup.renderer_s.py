"""Seconds of the set-up span ``setup.renderer_s`` (``drivers/frames.py``):
the scene, then the renderer's first frame, which loads or builds the SBVH,
collapses the quad tree, puts the tables on the device, makes the routing
tracer and loads the kernel library."""


def read(rec: dict):
    return rec["spans"].get("setup.renderer_s")
