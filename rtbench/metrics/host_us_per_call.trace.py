"""Host microseconds per routing call (``make_routing_tracer``'s function
and ``CudaTraceKernel``'s checks and launch), each call made alone after a
synchronize, after the traced window."""

from rtbench.metrics._util import per


def read(rec: dict):
    return per(rec, "trace.host_s", "trace.host_calls", 1e6)
