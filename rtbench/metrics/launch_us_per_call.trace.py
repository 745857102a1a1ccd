"""Host microseconds per routing call inside the traced window, calls queued
as the window queues them: the mean of the program's ``trace.launch`` spans
(``tpu_rt_torch.spans``; ``trace_quad`` / ``trace_flat`` whole: the checks,
allocations, launch and u, v fills) that no ``frame`` span encloses.  Read
under ``torch.profiler``, the value holds the profiler's cost of each op the
wrapper issues."""

from rtbench.metrics._spans import closed, records, under


def read(rec: dict):
    recs = records(rec)
    if not recs:
        return None
    spent = closed(recs, lambda i, name: name == "trace.launch"
                   and not under(recs, i, "frame"))
    return sum(spent) / len(spent) * 1e6 if spent else None
