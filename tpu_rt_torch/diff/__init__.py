from tpu_rt_torch.diff.tracer import trace_diff, moller_trumbore_tuv
from tpu_rt_torch.diff.shading import shade_hits_diff, render_image_diff

__all__ = ["trace_diff", "moller_trumbore_tuv", "shade_hits_diff", "render_image_diff"]
