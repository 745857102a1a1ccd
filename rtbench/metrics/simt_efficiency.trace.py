"""The share of a warp's lanes that test a node or a triangle while the
warp's loop runs (Aila & Laine's SIMD efficiency), in %, over the cell's
batches in the stats pass (``drivers/diffuse.py``): ``(trace.node_tests +
trace.tri_tests) / (32 x trace.warp_tests)``, where ``trace.warp_tests``
sums over each 32 consecutive rays their largest node_tests + tri_tests
(``tpu_rt_torch.trace.common.warp_work``).  A port without those counters
gives nothing."""

WARP = 32


def read(rec: dict):
    c = rec["counters"]
    if not c.get("trace.warp_tests"):
        return None
    return (c["trace.node_tests"] + c["trace.tri_tests"]) / (WARP * c["trace.warp_tests"]) * 100.0
