from tpu_rt_torch.rays.buffer import (
    RayBuffer,
    morton_sort_device,
    morton_sort_device_coarse,
    ray_morton_keys_device,
    sort_dead_last_device,
    trace_live_prefix,
)

__all__ = ["RayBuffer", "ray_morton_keys_device", "morton_sort_device",
           "morton_sort_device_coarse", "sort_dead_last_device", "trace_live_prefix"]
