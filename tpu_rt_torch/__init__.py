"""tpu_rt_torch — the PyTorch + CUDA port of tpu_rt for NVIDIA Hopper.

The JAX package ``tpu_rt`` beside it is the reference.  This package imports
torch and numpy, never JAX or ``tpu_rt``, and mirrors ``tpu_rt``'s layout
so the counterpart of every module is easy to find:

    core/    SoA Rays/Hits (torch), host math + hashing, host intersection
             primitives
    scene/   meshes (OBJ / MTL import and export), Scene flattening, camera
             (+ signature codec), Morton pixel table, procedural test scenes
    bench/   reference-calibrated workload (suite cameras, AO radii), the
             scaling run (``torchrun -m tpu_rt_torch.bench.scaling``)
    bvh/     SBVH builder (host), flatten + Woop transform, 4-wide collapse,
             hash-keyed build cache
    native/  the C++ SBVH builder (its own copy of sbvh.cc) via ctypes
    raygen/  primary, AO / diffuse and shadow ray generation, batching
    trace/   the 4-wide and binary BVH traversals, closest and any hit, with
             optional u, v and per-ray counters: CUDA kernels
             (csrc/quad_trace.cu, csrc/flat_trace.cu) and their plain
             PyTorch versions; the wavefront tracer; the host oracles
    rays/    RayBuffer and the device Morton sorts of secondary batches
    shade/   image reconstruction
    diff/    differentiable trace and shading (torch autograd), the training
             loop with checkpoint / resume
    dist/    rays sharded over torch.distributed ranks: the sharded trace,
             render and grad step, the collective audit, scaling, dry run
    debug/   golden hex-word and ray dumps
    image.py pixel formats, blit, PPM / npy files
    renderer.py  the frame orchestrator

Device work takes an explicit ``device``.  What is not ported yet is listed
in ROADMAP.md.
"""

__version__ = "0.1.0"
