from tpu_rt_torch.debug.dumps import (
    dump_hex_words,
    dump_bvh_nodes,
    dump_woop_triangles,
    dump_rays,
    dump_ray_results,
    load_hex_words,
)

__all__ = [
    "dump_hex_words",
    "dump_bvh_nodes",
    "dump_woop_triangles",
    "dump_rays",
    "dump_ray_results",
    "load_hex_words",
]
