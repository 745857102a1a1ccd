"""The coarse Morton sort's CUDA kernels (``csrc/morton_coarse.cu``).

``buffer.sort_batch_coarse`` runs them for rays on a CUDA device, around one
``torch.sort`` of their int32 keys; on the CPU it runs the torch chain
(``morton_sort_device_coarse``, ``permute_rays``, ``inverse_permutation``),
which the tests hold them to.  ``KERNEL.launches`` counts the kernels
launched (two a ``keys`` call, two a ``permute`` call), so that a run can
show which version served its batches.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_rt_torch import spans
from tpu_rt_torch._build import build_shared
from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.trace.common import CSRC, NVCC_FLAGS, nvcc

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# morton_coarse_keys(origin, n, box, keys, stream)
KEYS_ARGTYPES = [_vp, _ci, _vp, _vp, _vp]
# morton_coarse_permute(order, n, origin, dirn, tmin, tmax, s2i, i2s,
# out_origin, out_dirn, out_tmin, out_tmax, out_s2i, out_i2s, inv, stream)
PERMUTE_ARGTYPES = [_vp, _ci] + [_vp] * 14


class MortonCoarseKernel:
    """Wrapper of ``csrc/morton_coarse.cu``: builds and loads it at first
    use, checks its inputs, allocates its outputs and scratch, launches on
    the current stream and counts kernel launches in ``launches``."""

    name = "morton_coarse"

    def __init__(self):
        self.source = os.path.join(CSRC, f"{self.name}.cu")
        self.launches = 0
        self.build_log = ""
        self.build_s = 0.0
        self._lib = None

    def reset_counts(self) -> None:
        self.launches = 0

    def load(self):
        if self._lib is None:
            with spans.span("setup.kernel_load", timed=True) as load:
                path, self.build_log = build_shared(self.name, [self.source],
                                                    [nvcc()] + NVCC_FLAGS)
                lib = ctypes.CDLL(path)
            self.build_s = load.seconds
            for fn, argtypes in ((lib.morton_coarse_keys, KEYS_ARGTYPES),
                                 (lib.morton_coarse_permute, PERMUTE_ARGTYPES)):
                fn.restype = _ci
                fn.argtypes = argtypes
            self._lib = lib
        return self._lib

    @staticmethod
    def _check(dev, named):
        if dev.type != "cuda":
            raise ValueError(f"morton_coarse needs CUDA tensors, got {dev}")
        for name, x, dtype, shape in named:
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"{name}: need {dtype} {shape} on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name}: must be contiguous")

    @staticmethod
    def _run(err, what):
        if err != 0:
            raise RuntimeError(f"morton_coarse {what} failed: cudaError {err}")

    def keys(self, origin: torch.Tensor) -> torch.Tensor:
        """[N] int32 30-bit keys of ``origin`` [N, 3] f32: the values of
        ``morton_keys_coarse_device(origin)``."""
        dev, n = origin.device, origin.shape[0]
        if n >= 2**31:
            raise ValueError(f"morton_coarse indexes rays with int32: {n}")
        self._check(dev, [("origin", origin, torch.float32, (n, 3))])
        keys = torch.empty((n,), dtype=torch.int32, device=dev)
        if n == 0:
            return keys
        box = torch.empty((6,), dtype=torch.int32, device=dev)
        lib = self.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            self._run(lib.morton_coarse_keys(origin.data_ptr(), n, box.data_ptr(),
                                             keys.data_ptr(), stream), "keys")
        self.launches += 2
        return keys

    def permute(self, rays: Rays, s2i: torch.Tensor, i2s: torch.Tensor,
                order: torch.Tensor) -> tuple[Rays, torch.Tensor, torch.Tensor]:
        """``(permute_rays(rays, order), s2i[order],
        inverse_permutation(order)[i2s])`` for ``order`` an int64
        permutation of the N rays and int32 maps of N entries, ``i2s``'s
        slots in [0, N)."""
        dev, n = rays.origin.device, rays.num
        if n >= 2**31:
            raise ValueError(f"morton_coarse indexes rays with int32: {n}")
        f32, i32 = torch.float32, torch.int32
        self._check(dev, [("order", order, torch.int64, (n,)),
                          ("origin", rays.origin, f32, (n, 3)), ("dirn", rays.dirn, f32, (n, 3)),
                          ("tmin", rays.tmin, f32, (n,)), ("tmax", rays.tmax, f32, (n,)),
                          ("s2i", s2i, i32, (n,)), ("i2s", i2s, i32, (n,))])
        out = Rays(*(torch.empty_like(x) for x in rays))
        out_s2i, out_i2s = torch.empty_like(s2i), torch.empty_like(i2s)
        if n == 0:
            return out, out_s2i, out_i2s
        inv = torch.empty((n,), dtype=i32, device=dev)
        lib = self.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            self._run(lib.morton_coarse_permute(
                order.data_ptr(), n, *(x.data_ptr() for x in rays), s2i.data_ptr(),
                i2s.data_ptr(), *(x.data_ptr() for x in out), out_s2i.data_ptr(),
                out_i2s.data_ptr(), inv.data_ptr(), stream), "permute")
        self.launches += 2
        return out, out_s2i, out_i2s


KERNEL = MortonCoarseKernel()
