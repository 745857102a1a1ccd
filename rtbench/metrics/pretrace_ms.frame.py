"""Milliseconds per frame of the primary pre-trace of a secondary frame: the
program's ``trace.primary`` spans (``tpu_rt_torch.spans``; host time, its
wait for the kernel included), summed over the traced window, over its
``frame`` spans."""

from rtbench.metrics._spans import per_frame_ms


def read(rec: dict):
    return per_frame_ms(rec, lambda i, name: name == "trace.primary")
