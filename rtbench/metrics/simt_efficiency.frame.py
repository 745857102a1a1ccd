"""The share of a warp's lanes that test a node or a triangle while the
warp's loop runs, in %, over the frame cell's batches in its stats pass
(``drivers/diffuse_frames.py``, ``Renderer.frame_stats``):
``simt_efficiency.trace``'s ``(trace.node_tests + trace.tri_tests) / (32 x
trace.warp_tests)`` over the frame's own sorted batches.  A port without
those counters gives nothing."""

from rtbench import run

read = run.load_module("metrics", "simt_efficiency.trace").read
