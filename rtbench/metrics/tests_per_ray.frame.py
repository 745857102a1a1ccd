"""Node and triangle tests per ray over the frame cell's batches, each
routed once more after the traced window (``drivers/diffuse_frames.py``'s
stats pass, ``Renderer.frame_stats``): ``tests_per_ray.trace``'s
``(trace.node_tests + trace.tri_tests) / trace.stats_rays`` over the
frame's own sorted batches.  A port without those counters gives nothing."""

from rtbench import run

read = run.load_module("metrics", "tests_per_ray.trace").read
