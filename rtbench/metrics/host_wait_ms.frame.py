"""Milliseconds per frame that the host spends blocked on the device: the
program's ``*.wait`` spans (``tpu_rt_torch.spans``; the phases' synchronizes,
the trace's CUDA event, the read of the hit count, the image's copy to the
host), summed over the traced window, over its ``frame`` spans.  Read under
``torch.profiler``, the value holds what the profiler adds to the waits
(the image's copy most)."""

from rtbench.metrics._spans import per_frame_ms


def read(rec: dict):
    return per_frame_ms(rec, lambda i, name: name.endswith(".wait"))
