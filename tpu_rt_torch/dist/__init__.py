from tpu_rt_torch.dist.sharding import (
    make_ray_mesh,
    shard_rays,
    trace_sharded,
    render_diff_sharded,
    grad_step_sharded,
    collective_audit,
)
from tpu_rt_torch.dist.multihost import init_multihost, measure_scaling

__all__ = [
    "make_ray_mesh",
    "shard_rays",
    "trace_sharded",
    "render_diff_sharded",
    "grad_step_sharded",
    "collective_audit",
    "init_multihost",
    "measure_scaling",
]
