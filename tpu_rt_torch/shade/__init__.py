from tpu_rt_torch.shade.reconstruct import reconstruct_image, count_hits

__all__ = ["reconstruct_image", "count_hits"]
