"""The trace kernels' share of their least time in the frame cell's traced
window, in %: ``trace_kernels_roofline``'s byte bound (each ray read once,
32 B, each hit written once, 8 B, over the card's HBM rate) over the
``quad_*`` / ``flat_*`` kernels' device time, the rays being those the
window's frames traced (``trace_rays``: the primary pre-trace and the
secondary batches, ``drivers/diffuse_frames.py``)."""

from rtbench import run

read = run.load_module("metrics", "trace_kernels_roofline").read
