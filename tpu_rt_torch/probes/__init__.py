"""Probes: fixed-trip kernels that time one piece of a traversal kernel on
the card, the counterparts of ``tpu_rt``'s ``tools/`` ablations.  Each
module (``mxu_ablate``, ``ablate2``, ``mosaic_probe3``) has its kernel in
``tpu_rt_torch/csrc/``, a ``ProbeKernel`` wrapper, a plain PyTorch version
and a ``run()``."""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from tpu_rt_torch._build import build_shared
from tpu_rt_torch.trace.common import CSRC, NVCC_FLAGS, headers, nvcc


class ProbeKernel:
    """Wrapper of one probe library, ``csrc/<name>.cu``, whose C entry point
    ``<name>_launch(form, *args, stream)`` returns the first CUDA error:
    builds and loads it at first use, launches a form on the current stream
    and counts launches (``launches``, and per form ``launches_by_form``).
    ``argtypes`` are the ctypes types of ``args``."""

    def __init__(self, name: str, forms: tuple, argtypes: list):
        self.name = name
        self.forms = forms
        self.argtypes = argtypes
        self.source = f"{CSRC}/{name}.cu"
        self.build_log = ""
        self.build_s = 0.0
        self.path = None
        self._lib = None
        self._fn = None
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_form = dict.fromkeys(self.forms, 0)

    def load(self):
        if self._fn is None:
            t0 = time.perf_counter()
            self.path, self.build_log = build_shared(self.name, [self.source],
                                                     [nvcc()] + NVCC_FLAGS, deps=headers())
            self._lib = ctypes.CDLL(self.path)
            fn = getattr(self._lib, f"{self.name}_launch")
            self.build_s = time.perf_counter() - t0
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, *self.argtypes, ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def occupancy(self, form, dev: torch.device) -> dict:
        """What ``dev`` makes of ``form``'s kernel, from the library's
        ``<name>_occupancy(form, int[4])`` (``ablate2`` and
        ``mosaic_probe3``): resident blocks per SM
        (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
        local-memory bytes a thread, static shared-memory bytes a block
        (``cudaFuncGetAttributes``), and the device's SMs."""
        self.load()
        fn = getattr(self._lib, f"{self.name}_occupancy")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(dev):
            err = fn(self.forms.index(form), ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"{self.name} occupancy of {form!r} failed: cudaError {err}")
        return {"blocks_per_sm": out[0], "registers": out[1], "local_bytes": out[2],
                "shared_bytes": out[3],
                "sms": torch.cuda.get_device_properties(dev).multi_processor_count}

    def launch(self, form, dev: torch.device, *args) -> None:
        """Launch ``form`` with ``args`` (checked by the caller) on the
        current stream of ``dev``, and count it."""
        fn = self.load()
        with torch.cuda.device(dev):
            err = fn(self.forms.index(form), *args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        self.launches_by_form[form] += 1


def time_ms(fn, repeats: int) -> float:
    """Median milliseconds of ``repeats`` calls of ``fn`` from CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def call_ms(fn):
    """``fn()``'s result and the milliseconds of that one call from CUDA
    events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def iterate(step, state: tuple, iters: int = 0, until=None) -> tuple:
    """``state`` after ``iters`` calls of ``state = step(state)``, or after
    as many as keep ``until(state)`` (a bool tensor) true.  ``step`` changes
    no tensor in place and returns a tensor of the state's shape and type
    in each place (or the one it was given there).  On the CPU the steps
    run one by one; on a CUDA device one step is captured in a CUDA graph
    and replayed, so that thousands of steps of a plain version cost the
    time of its kernels, not of the host's dispatch of each operation."""
    dev = state[0].device
    if dev.type != "cuda":
        if until is None:
            for _ in range(iters):
                state = step(state)
        else:
            while bool(until(state)):
                state = step(state)
        return state
    static = tuple(t.clone() for t in state)
    side, main = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step(static)                          # warm-up outside the graph
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for old, new in zip(static, step(static)):
            if new is not old:
                old.copy_(new)
    if until is None:
        for _ in range(iters):
            graph.replay()
    else:
        while bool(until(static)):
            graph.replay()
    return static


def same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element of two f32 tensors: equal bits, or both NaN (a kernel's
    NaN is canonical)."""
    return (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
