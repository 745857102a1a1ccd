from tpu_rt_torch.raygen.generators import gen_primary_rays
from tpu_rt_torch.raygen.raygen import RayGen

__all__ = ["gen_primary_rays", "RayGen"]
