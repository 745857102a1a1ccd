from tpu_rt_torch.core.types import AABB, FlatBVH, Hits, Rays, SENTINEL, concat_rays, make_rays, pad_rays
from tpu_rt_torch.core import math as rtmath

__all__ = ["AABB", "FlatBVH", "Hits", "Rays", "SENTINEL", "concat_rays", "make_rays", "pad_rays", "rtmath"]
