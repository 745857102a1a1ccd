from tpu_rt_torch.raygen.generators import gen_ao_rays, gen_primary_rays, gen_shadow_rays
from tpu_rt_torch.raygen.raygen import RayGen

__all__ = ["gen_ao_rays", "gen_primary_rays", "gen_shadow_rays", "RayGen"]
