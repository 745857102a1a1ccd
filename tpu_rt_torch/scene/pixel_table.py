"""Morton pixel swizzle table (reference src/rt/ray/PixelTable.cc).

Counterpart of ``tpu_rt.scene.pixel_table``: primary ray i targets pixel
``index_to_pixel[i]``.  The LUT math is the host numpy
``tpu_rt_torch.core.math.pixel_morton_luts``; this wrapper caches the tables
per resolution and keeps one device copy per device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.core.math import pixel_morton_luts


class PixelTable:
    def __init__(self):
        self._size = (0, 0)
        self.index_to_pixel: np.ndarray | None = None
        self.pixel_to_index: np.ndarray | None = None
        self._dev: dict[torch.device, torch.Tensor] = {}

    def set_size(self, width: int, height: int) -> None:
        if (width, height) == self._size:
            return
        self._size = (width, height)
        self.index_to_pixel, self.pixel_to_index = pixel_morton_luts(width, height)
        self._dev = {}

    @property
    def size(self):
        return self._size

    def index_to_pixel_device(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = torch.as_tensor(self.index_to_pixel, dtype=torch.int32, device=device)
        return self._dev[device]
