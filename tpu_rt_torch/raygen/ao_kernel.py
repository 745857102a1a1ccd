"""The AO / diffuse ray generator's CUDA kernel (``csrc/raygen_ao.cu``).

``gen_ao_rays`` launches it for inputs on a CUDA device, one launch a batch;
``gen_ao_rays_plain`` (``generators.py``) is its plain PyTorch version, which
the CPU runs and the tests hold it to.  ``KERNEL.launches`` counts its
launches, so that a run can show which version served its AO batches.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from tpu_rt_torch import spans
from tpu_rt_torch._build import build_shared
from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.trace.common import CSRC, NVCC_FLAGS, nvcc

_vp, _ci, _cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# raygen_ao_launch(in_origin, in_dirn, in_t, in_tri, tri_normal, n_tri, r,
# num_samples, max_dist, seed, task_offset, out_origin, out_dirn, out_tmin,
# out_tmax, out_id, stream)
ARGTYPES = [_vp] * 5 + [_ci] * 3 + [ctypes.c_float, _cu, _cu] + [_vp] * 6


class RaygenAoKernel:
    """Wrapper of ``csrc/raygen_ao.cu``: builds and loads it at first use,
    checks its inputs, allocates its outputs, launches it on the current
    stream and counts launches in ``launches``."""

    name = "raygen_ao"

    def __init__(self):
        self.source = os.path.join(CSRC, f"{self.name}.cu")
        self.launches = 0
        self.build_log = ""
        self.build_s = 0.0
        self._fn = None

    def reset_counts(self) -> None:
        self.launches = 0

    def load(self):
        if self._fn is None:
            with spans.span("setup.kernel_load", timed=True) as load:
                path, self.build_log = build_shared(self.name, [self.source],
                                                    [nvcc()] + NVCC_FLAGS)
                fn = ctypes.CDLL(path).raygen_ao_launch
            self.build_s = load.seconds
            fn.restype = _ci
            fn.argtypes = ARGTYPES
            self._fn = fn
        return self._fn

    def __call__(self, in_origin, in_dirn, in_t, in_tri, tri_normal, num_samples: int,
                 max_dist: float, seed: int, task_offset: int = 0):
        """``gen_ao_rays_plain``'s arguments and results: (Rays [r * S],
        slot_to_id, id_to_slot), the ids the identity, on the inputs'
        device.  No launch when there is no output ray."""
        dev = in_origin.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got {dev}")
        r, s = in_origin.shape[0], int(num_samples)
        if s < 0:
            raise ValueError(f"num_samples must be >= 0, got {num_samples}")
        n = r * s
        if n >= 2**31:
            raise ValueError(f"{self.name} indexes rays with int32: {r} x {s}")
        f32, i32 = torch.float32, torch.int32
        checks = [("in_origin", in_origin, f32, (r, 3)), ("in_dirn", in_dirn, f32, (r, 3)),
                  ("in_t", in_t, f32, (r,)), ("in_tri", in_tri, i32, (r,)),
                  ("tri_normal", tri_normal, f32, (tri_normal.shape[0], 3))]
        for name, x, dtype, shape in checks:
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"{name}: need {dtype} {shape} on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name}: must be contiguous")
        rays = Rays(origin=torch.empty((n, 3), dtype=f32, device=dev),
                    dirn=torch.empty((n, 3), dtype=f32, device=dev),
                    tmin=torch.empty((n,), dtype=f32, device=dev),
                    tmax=torch.empty((n,), dtype=f32, device=dev))
        ids = torch.empty((n,), dtype=i32, device=dev)
        if n == 0:
            return rays, ids, ids
        fn = self.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(in_origin.data_ptr(), in_dirn.data_ptr(), in_t.data_ptr(),
                     in_tri.data_ptr(), tri_normal.data_ptr(), tri_normal.shape[0], r, s,
                     float(np.float32(max_dist)), int(seed) & 0xFFFFFFFF,
                     int(task_offset) & 0xFFFFFFFF,
                     *(x.data_ptr() for x in rays), ids.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        return rays, ids, ids


KERNEL = RaygenAoKernel()
