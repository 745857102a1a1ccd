#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main paths once through the entry points a user calls,
and holds every kernel form against its plain PyTorch version and the host
oracles ``trace_quad_scalar`` (4-wide) and ``trace_flat_scalar`` (binary):

1.   builds every kernel library (quad_trace.cu, quad_trace_c.cu,
     flat_trace.cu, flat_trace_c.cu, flat_trace_mxu.cu, mxu_ablate.cu,
     ablate2.cu, mosaic_probe3.cu; one nvcc each, all run together;
     28 + 24 + 52 + 48 + 50 + 6 + 10 + 9 forms) and prints ptxas' registers,
     stack and spills per form; the vmem f32 frame forms of the persistent
     kernels and their first versions must keep their registers and stack
     (``PTXAS_VMEM_F32``), no persistent frame form (the tensor-core ones
     included) may spill; the quad frame forms' ptxas at 40 registers
     (``register_cap_ptxas``); the registers and shared memory of the
     tensor-core forms; the SASS (cuobjdump) of each tensor-core form and
     of each probe variant that takes mma must hold DMMA, and the probes'
     SASS must hold each level's and mode's work (``sass_checks``).
2-5. bunny (144,500 triangles), SBVH build, 4-wide collapse, Morton-ordered
     primary rays at 640x480, the closest-hit trace through
     ``Renderer(tracer="auto")`` (the CUDA quad kernel) and the image; the
     kernel against its plain version on every ray and the oracle on a
     strided subset; both timed with CUDA events.
6-7. conference (350,949 triangles) AO frame at 640x480, 8 samples, the
     suite camera and AO radius: a closest-hit primary trace, then two
     any-hit batches (2,097,152 + the rest); the any-hit kernel against
     its plain version on every ray of batch 1 and the oracle on 8,192
     rays, and the image at those pixels against the oracle's hit / miss.
8.   conference diffuse frame, 1 sample: the closest-hit kernel on
     secondary rays, against its plain version and the oracle.
9.   kernel-only times of the any-hit kernel (AO batch 1, and a 1-sample
     AO batch), its plain version, and the closest-hit kernel on the
     diffuse batch.
10.  binary path, bunny primary frame through ``Renderer(tracer="packet")``
     (the CUDA binary kernel): against its plain version on every ray and
     ``trace_flat_scalar`` on the subset; t bit-equal to the quad kernel's
     on every ray, tri and image pixels differing only at exact-t ties.
11.  binary path, conference AO and diffuse frames: the any-hit kernel
     against plain on every ray of batch 1, against the oracle on 8,192
     rays (the same occluder), per-ray hit / miss equal to the quad
     any-hit kernel's; the closest-hit kernel on the diffuse batch.
12.  want_uv and with_stats forms of both kernels through
     ``make_routing_tracer(..., want_uv=True)``: bunny primary (closest
     and any hit) and conference AO batch 1, against the plain versions on
     every ray and the oracles on the subsets; node / triangle tests per
     ray, 2-wide against 4-wide, and warp efficiency.
13.  the "xla" route (the wavefront tracer) on bunny primary: tri against
     the binary kernel's, disputed rays adjudicated by the oracle.
14.  kernel-only times of the binary kernel (bunny primary, diffuse batch,
     AO batch 1) and of the uv and stats forms of both kernels.
15.  dragon (910,348 triangles), the large-scene path: SBVH into the shared
     cache, quad collapses at leaf 16 and 32, table bytes, the card's L2
     and the routing decisions at the default budget (none), at the
     card's largest persisting-L2 set-aside and at tpu_rt's 12 MiB.
16.  the dragon primary frame through ``Renderer(tracer="auto")`` and
     ``Renderer(tracer="packet")`` at the default budget (vmem f32).
17.  the dragon AO frame, 8 samples, ``suite_ao_radius``, through
     ``Renderer(tracer="packet")``.
18.  tpu_rt's forced large-scene forms (binary bf16 mixed, binary f32 hbm,
     quad leaf 32 mixed) and the other layouts (bf16 vmem and hbm, f32
     mixed, quad mixed and hbm) through ``make_routing_tracer``, each a
     path of its own on the same rays (launch counts set to 0 just
     before it): every form (frame, uv and stats, closest and any hit)
     against its plain version on every ray of the primary frame and AO
     batch 1, ``t`` bit-equal across forms and trees, hit / miss equal to
     the AO frame's; against ``trace_flat_scalar`` on 8,192 rays of each
     (tri disputes only at exact-``t`` ties, adjudicated with the
     triangle's own Woop test) and the quad forms against
     ``trace_quad_scalar``.
19.  kernel times of every dragon form, in two passes (the second in
     reverse order, the persisting L2 released after each form), and of
     the plain versions, and the census (node and triangle tests per ray,
     f32 against bf16, warp efficiency).
20.  the triangle phase on bunny: the primary frame through
     ``Renderer(tracer="packet", mxu=True)`` (the tensor-core leaf test)
     and ``Renderer(tracer="packet", cursors=2)`` (postponed leaves), each
     a path of its own, against the binary frame of phase 10.
21.  the conference AO frame (8 samples, 2 batches) through "packet" with
     mxu=True, "packet" with cursors=3 and "packet4" with cursors=2, each
     a path of its own, against the first versions' AO frames.
22.  every form of the three triangle-phase libraries (frame, uv, stats;
     closest hit on the bunny primary frame's rays, any hit on AO batch 1)
     against its plain version on every ray, bit for bit (the tensor-core
     forms at 1-4 cursors, and at 2 and 3 on the bf16 hbm and f32 mixed
     tables), the postponed forms against the first versions' results, and
     all against the oracles on 8,192 rays; the census at 1, 2 and 3
     cursors and with mxu.
23.  kernel times of the first versions' and the new forms on the same
     rays, in two passes, the second in reverse order.
24.  the MXU ablation probe (``tpu_rt_torch.probes.mxu_ablate``) at 16,384
     and 262,144 rays: ns per iteration of each variant (the tile phase's
     full, noL, noM, epi0, the product-table phase's smem, and scalar),
     each checked against its plain version.
25.  the traversal-step ablation (``tpu_rt_torch.probes.ablate2``) on
     bunny's node records and Woop rows, on a full card and at the tool's
     8,192 rays: ns per iteration of each level, the output of each
     level's timed launch against its plain version on every ray.
26.  the row-cursor primitives (``tpu_rt_torch.probes.mosaic_probe3``) on a
     full card and on the tool's one packet: ns per iteration and per row
     step of each mode, the output of each mode's timed launch against its
     plain version on every packet; and the gather and scatter-add rates
     of PyTorch indexing at the tool's sizes.
27.  the persistent kernels against their first versions (one ray per
     thread): the four vmem f32 frame forms on the same rays (bunny
     primary, conference AO batch 1, the conference diffuse batch, dragon
     primary and AO batch 1 on the binary f32 and quad leaf-16 trees), and
     the two tensor-core frame forms on bunny primary and AO batch 1, in
     turns, in two passes, the second in reverse order: ms, Mray/s and
     new/old; the stack-placement A/B (local against shared memory) on
     bunny primary and AO batch 1; every design's hits against the
     persistent kernel's and its launch shape against ``persistent_grid``
     (and ``MXU_SMEM``); the refill threshold.

Run from the root of the repository:  python3 chip_smoke.py
It needs a CUDA device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and g++;
it builds the kernels from the sources in the checkout, and the renderers
share one BVH cache under the git-ignored ``build/``.  Any failed phase ends
the run with a nonzero exit and no result line.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
form with the path it was counted on and its launches in that path's run,
its largest deviation from the plain version, both versions' times, and
its bound: the larger of the operations its node and triangle tests need
over the peak of their type (f32; the tensor-core form's dot products at
the FP64 tensor rate) and the table rows its rays read, rays and hits over
the memory rate (``bound``).  The new forms' entries say in ``timed_on``
which rays their times were taken on; their ``plain_ms`` is one call of
the plain version's full form (u, v and counters), timed with CUDA events
in phase 22; the probes' times are per iteration (``ablate2``'s of its full
step, level 8; ``mosaic_probe3``'s of ``rowstep``; both on a full card),
with ``ns_per_iter`` of every variant, level or mode.  The four frame
forms' entries carry ``first_ms``, their first version's time, and their
``ms`` from the same A/B (phase 27); the tensor-core frame forms' entries
carry ``first_ms`` and ``ab_ms`` (the designs in phase 27) and their
``launch_shape``.  No single PyTorch call computes a BVH traversal or a
probe, so ``library_ms`` is null.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

WIDTH, HEIGHT = 640, 480
SCENE = "bunny"
SECONDARY_SCENE = "conference"
DRAGON = "dragon"             # the large-scene path (tools/bench_suite.py FULLFRAME_TARGETS)
AO_SAMPLES = 8
AO_MAX_BATCH = 1 << 21        # the Renderer's default: 2 AO batches at 640x480
WARMUP, REPEATS = 2, 5        # as bench.py: BENCH_WARMUP / BENCH_REPEATS
PLAIN_WARMUP, PLAIN_REPEATS = 1, 3
ORACLE_RAYS = 8192
DEVICE = "cuda"
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_bvhcache")
PACKET2 = "tpu_rt/trace/packet2.py:404"


def probe_form(lib: str, index: int) -> str:
    """The form name of instantiation ``index`` of a probe's kernel: the
    module's variant, level or mode of that index."""
    from tpu_rt_torch.probes import ablate2, mosaic_probe3, mxu_ablate

    forms = {"mxu_ablate": mxu_ablate.VARIANTS, "ablate2": [f"level={lv}" for lv in ablate2.LEVELS],
             "mosaic_probe3": mosaic_probe3.MODES}[lib]
    return f"{lib}<{forms[index]}>"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def phase(name: str, t0: float) -> None:
    print(f"[{time.perf_counter() - t0:8.2f} s] {name}", flush=True)


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int, repeats: int) -> list[float]:
    """Per-call milliseconds from CUDA events around each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def median(xs) -> float:
    return float(np.median(xs))


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def np_bits_differ(a: np.ndarray, b: np.ndarray) -> int:
    return int((np.asarray(a, np.float32).view(np.int32)
                != np.asarray(b, np.float32).view(np.int32)).sum())


def subset(rays, idx):
    from tpu_rt_torch.core.types import Rays

    return Rays(*(x[idx].contiguous() for x in rays))


def strided(n: int, dev) -> torch.Tensor:
    return torch.arange(0, n, max(n // ORACLE_RAYS, 1), device=dev)[:ORACLE_RAYS]


# ptxas of the vmem f32 frame forms (registers, stack + spill bytes): the
# persistent kernels', and the first versions' as they were before the
# persistent kernels.
PTXAS_VMEM_F32 = {"quad_trace<any=0,uv=0,stats=0>": (48, 256),
                  "quad_trace<any=1,uv=0,stats=0>": (48, 256),
                  "flat_trace<any=0,uv=0,stats=0>": (44, 256),
                  "flat_trace<any=1,uv=0,stats=0>": (45, 256),
                  "quad_trace<any=0,uv=0,stats=0>/first": (53, 256),
                  "quad_trace<any=1,uv=0,stats=0>/first": (48, 256),
                  "flat_trace<any=0,uv=0,stats=0>/first": (32, 256),
                  "flat_trace<any=1,uv=0,stats=0>/first": (36, 256)}
# The template flags of each traversal kernel, in order.
KERNEL_FLAGS = {"quad_trace": ("any", "uv", "stats", "sn", "st", "c", "shared"),
                "flat_trace": ("any", "uv", "stats", "bf16", "sn", "st", "c", "shared"),
                "flat_trace_mxu": ("any", "uv", "stats", "bf16", "sn", "st"),
                "quad_first": ("any",), "flat_first": ("any",), "flat_mxu_first": ("any",)}
# The library of each kernel template.
KERNEL_LIB = {"quad_trace": "quad_trace", "flat_trace": "flat_trace",
              "flat_trace_mxu": "flat_trace_mxu", "quad_first": "quad_trace",
              "flat_first": "flat_trace", "flat_mxu_first": "flat_trace_mxu"}
# quad (+ 2 first versions and 2 with the shared-memory stack), quad_c, flat
# (+ 2 + 2), flat_c, flat_mxu (+ 2 first versions); the probes mxu_ablate,
# ablate2, mosaic_probe3
N_FORMS = 24 + 4 + 24 + 48 + 4 + 48 + 48 + 2 + 6 + 10 + 9
# The mxu_ablate variants whose SASS holds DMMA (noM replaces each mma by an
# add and a subtract; scalar has none).
DMMA_VARIANTS = ("full", "noL", "epi0", "smem")


# A __launch_bounds__ minimum of 12 blocks of 128 threads per SM holds a
# kernel to 40 registers (65,536 over 1,536 threads, in steps of 8).
MIN_BLOCKS, REGISTER_CAP = 12, 40


def with_min_blocks(ptx: str, blocks: int) -> tuple[str, int]:
    """``ptx`` with every entry of 128 threads given a minimum of ``blocks``
    blocks per SM (``.minnctapersm``, in place of any it had), and the
    number of entries changed."""
    ptx = re.sub(r"\n[ \t]*\.minnctapersm[ \t]+\d+", "", ptx)
    return re.subn(r"(\.maxntid\s+128,\s*1,\s*1)", rf"\1\n.minnctapersm {blocks}", ptx)


def register_cap_ptxas(common) -> list[tuple[str, int, int, int, str]]:
    """ptxas of quad_trace.cu's forms under a __launch_bounds__ minimum of
    MIN_BLOCKS blocks per SM (``.minnctapersm`` added to every entry of its
    PTX; nvcc's -maxrregcount does not apply to a kernel with launch
    bounds), compiled only: what that minimum costs the quad frame forms
    (``ptxas_forms``' entries)."""
    base = os.path.join(os.path.dirname(CACHE), f"quad_trace-min{MIN_BLOCKS}")
    os.makedirs(os.path.dirname(base), exist_ok=True)
    drop = {"-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v"}
    flags = [f for f in common.NVCC_FLAGS if f not in drop]
    proc = subprocess.run([common.nvcc(), "-arch=sm_90a", *flags, "-ptx",
                           os.path.join(common.CSRC, "quad_trace.cu"), "-o", f"{base}.ptx"],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"quad_trace.cu to PTX:\n{(proc.stdout + proc.stderr)[-4000:]}")
    with open(f"{base}.ptx") as f:
        ptx, n = with_min_blocks(f.read(), MIN_BLOCKS)
    check(n == ptx.count(".entry "), f"quad_trace.cu PTX: {n} launch bounds, "
          f"{ptx.count('.entry ')} entries")
    with open(f"{base}-bounded.ptx", "w") as f:
        f.write(ptx)
    ptxas = os.path.join(os.path.dirname(common.nvcc()), "ptxas")
    proc = subprocess.run([ptxas, "-arch=sm_90a", "-v", f"{base}-bounded.ptx", "-o",
                           f"{base}.cubin"], capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"ptxas of quad_trace.cu at {MIN_BLOCKS} blocks:\n{log[-4000:]}")
    return ptxas_forms(log)


def ptxas_forms(log: str) -> list[tuple[str, int, int, int, str]]:
    """One entry per compiled kernel form: (name, registers, stack frame
    bytes, spill bytes (stores + loads), the line to print).  The name is the
    library (the kernel, "_c" for its postponed-leaf forms), its three form
    flags, then the layout: "@" + residency (+ "-bf16"), nothing for vmem
    f32, then "/first" for a first version and "/shared_stack" for the
    persistent kernel with its stack in shared memory; the probes' are
    "mxu_ablate<variant>", "ablate2<level=N>" and "mosaic_probe3<mode>"."""
    out, name, stack, frame, spill = [], None, "", 0, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            flags = re.search(r"(quad_trace|flat_trace_mxu|flat_trace|quad_first|flat_first|"
                              r"flat_mxu_first)_kernelI((?:Lb[01]E)+)E", m.group(1))
            probe = re.search(r"(mxu_ablate|ablate2|mosaic_probe3)_kernelILi(\d)E", m.group(1))
            if flags:
                f = dict(zip(KERNEL_FLAGS[flags.group(1)],
                             (int(x) for x in re.findall(r"Lb([01])E", flags.group(2)))))
                res = ("hbm" if f.get("sn") else "mixed") if f.get("st") else "vmem"
                bf16 = f.get("bf16", 0) == 1
                lay = "" if res == "vmem" and not bf16 else f"@{res}" + ("-bf16" if bf16 else "")
                lib = KERNEL_LIB[flags.group(1)] + ("_c" if f.get("c") else "")
                if flags.group(1).endswith("_first"):
                    lay += "/first"
                elif f.get("shared"):
                    lay += "/shared_stack"
                name = (f"{lib}<any={f['any']},uv={f.get('uv', 0)},stats={f.get('stats', 0)}>"
                        f"{lay}")
            elif probe:
                name = probe_form(probe.group(1), int(probe.group(2)))
            else:
                name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            stack = f"{m.group(1)} B stack, spills {m.group(2)}/{m.group(3)} B"
            frame, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), frame, spill,
                        f"{name}: {m.group(1)} registers, {stack}"))
            name = None
    return out


# SASS opcode classes counted per probe form (``sass_counts``).
SASS_CLASSES = {
    "LDG": ("LDG",), "local": ("LDL", "STL"), "LDS": ("LDS",), "STS": ("STS",),
    "SHFL": ("SHFL",), "VOTE": ("VOTE", "VOTEU"), "BAR": ("BAR",), "F2I": ("F2I",),
    "FP32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK"),
}
# What each ablate2 level adds to the SASS of the level below: its own class
# of instruction, which must grow, while no class of ABLATE2_KEPT that the
# level below has may vanish (counts of the others move a little with the
# compiler's scheduling); level 9 differs from 8 in its loop and keeps 8's
# classes.
ABLATE2_MARKS = {1: "LDG", 2: "LDG", 3: "FP32", 4: "VOTE", 5: "local", 6: "LDG", 7: "MUFU.RCP",
                 8: "FP32"}
ABLATE2_KEPT = ("LDG", "local", "VOTE", "SHFL", "MUFU.RCP", "FP32")
# (mode, class, mode it must have more of): each mosaic_probe3 mode's work.
# fetch16 reads only row 0's M[0, 0]; its LDG is every warp's fetch.
MOSAIC_MARKS = (("x16", "BAR", "empty"), ("x16", "F2I", "empty"), ("fetch16", "LDG", "empty"),
                ("fetch16T", "SHFL", "fetch16"), ("onehot_stack", "STS", "empty"),
                ("onehot_stack", "LDS", "empty"), ("rowstep", "LDG", "empty"),
                ("rowstep", "VOTE", "empty"), ("rowstep", "SHFL", "fetch16"),
                ("div8", "MUFU.RCP", "divmul"), ("divmul", "MUFU.RCP", "mul8"),
                ("mul8", "FP32", "empty"))


def sass_counts(path: str) -> dict[str, dict]:
    """Per kernel function of the library at ``path`` (``cuobjdump -sass``):
    the count of each SASS_CLASSES class, of MUFU.RCP and of all
    instructions, and the opcodes in order (``ops``)."""
    from tpu_rt_torch.trace import common

    cuobjdump = os.path.join(os.path.dirname(common.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    ops, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = ops.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P(?:T|\d+)\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and cur is not None:
            cur.append(m.group(1))
    out = {}
    for fn, seq in ops.items():
        c = {k: sum(op.split(".")[0] in v for op in seq) for k, v in SASS_CLASSES.items()}
        c.update({"MUFU.RCP": sum(op.startswith("MUFU.RCP") for op in seq), "all": len(seq),
                  "ops": seq})
        out[fn] = c
    return out


def sass_forms(path: str, lib: str) -> dict:
    """``sass_counts`` of a probe library by form index."""
    return {int(re.search(rf"{lib}_kernelILi(\d)E", fn).group(1)): c
            for fn, c in sass_counts(path).items() if f"{lib}_kernel" in fn}


def sass_checks(ablate_path: str, mosaic_path: str) -> None:
    """Phase 1: the probes' SASS holds the work that each level and mode
    times (the compiler folds x - x and closed-form loops; the sources keep
    their terms live with a run-time zero): ABLATE2_MARKS / ABLATE2_KEPT,
    MOSAIC_MARKS."""
    from tpu_rt_torch.probes import mosaic_probe3

    def line(name, c):
        print(f"sass {name}: " + ", ".join(f"{k} {c[k]}" for k in (*SASS_CLASSES, "MUFU.RCP",
                                                                     "all")))

    ab = sass_forms(ablate_path, "ablate2")
    check(sorted(ab) == list(range(10)), f"ablate2 SASS forms {sorted(ab)}")
    for lv in range(10):
        line(f"ablate2<level={lv}>", ab[lv])
    for lv, mark in ABLATE2_MARKS.items():
        check(ab[lv][mark] > ab[lv - 1][mark], f"ablate2 level {lv}: {mark} {ab[lv][mark]}, "
              f"level {lv - 1} {ab[lv - 1][mark]}: the level's work is not in the SASS")
    for lv in range(1, 10):
        lost = [k for k in ABLATE2_KEPT if ab[lv - 1][k] and not ab[lv][k]]
        check(not lost, f"ablate2 level {lv} has no {lost}, which level {lv - 1} has")
    check(ab[9]["ops"] != ab[8]["ops"], "ablate2 level 9's SASS equals level 8's")
    mp = {mosaic_probe3.MODES[i]: c for i, c in sass_forms(mosaic_path, "mosaic_probe3").items()}
    check(sorted(mp) == sorted(mosaic_probe3.MODES), f"mosaic_probe3 SASS forms {sorted(mp)}")
    for mode in mosaic_probe3.MODES:
        line(f"mosaic_probe3<{mode}>", mp[mode])
    for mode, cls, than in MOSAIC_MARKS:
        check(mp[mode][cls] > mp[than][cls], f"mosaic_probe3 {mode}: {cls} {mp[mode][cls]}, "
              f"{than} {mp[than][cls]}: the mode's work is not in the SASS")


def against_plain(kernel, plain, tables, rays, any_hit, frame_tri, what):
    """The kernel's frame form against its plain version on every ray (tri
    equal, t bit-equal), and a repeat launch against the frame's own hits.
    The plain version runs in its full form (u, v and counters), which the
    uv and stats phases reuse, and records the table rows it reads (for
    ``bound``).  Returns (largest |t| deviation, plain, rows read)."""
    got = kernel(tables, rays, any_hit=any_hit)
    seen = {}
    want, counts = plain(tables, rays, any_hit, True, True, visited=seen)
    torch.cuda.synchronize()
    tri_bad = int((got.tri != want.tri).sum())
    t_bad = bits_differ(got.t, want.t)
    max_abs_err = float((got.t - want.t).abs().max())
    frame_bad = int((got.tri != frame_tri).sum())
    print(f"{what}: kernel vs plain on {rays.num} rays: tri mismatches {tri_bad}, t bit "
          f"mismatches {t_bad}, max |dt| {max_abs_err}; vs the frame's own hits: {frame_bad} "
          "tri mismatches (tolerance: tri equal, t bit-equal)")
    check(tri_bad == 0 and t_bad == 0, f"{what}: kernel differs from the plain version")
    check(frame_bad == 0, f"{what}: repeat trace differs from the frame's")
    return max_abs_err, (want, counts), seen


def against_oracle(kernel, tables, oracle, sub, any_hit, what, stats=None):
    """The kernel against a host oracle (``trace_quad_scalar`` or
    ``trace_flat_scalar``, bound to its tree with ``partial``) on ``sub`` (tri equal, t bit-equal).  Returns the
    oracle's (tri, t, u, v)."""
    t0 = time.perf_counter()
    args = [x.cpu().numpy() for x in sub]
    out = oracle(*args, any_hit=any_hit) if stats is None else oracle(*args, any_hit=any_hit,
                                                                       stats=stats)
    oracle_s = time.perf_counter() - t0
    k = kernel(tables, sub, any_hit=any_hit)
    k_tri, k_t = k.tri.cpu().numpy(), k.t.cpu().numpy()
    tri_bad = int((k_tri != out[0]).sum())
    t_bad = np_bits_differ(k_t, out[1])
    print(f"{what}: kernel vs {oracle.func.__name__}(any_hit={any_hit}) on {sub.num} rays "
          f"({oracle_s:.1f} s on the host): tri mismatches {tri_bad}, t bit mismatches {t_bad}, "
          f"hit fraction {float(np.mean(out[0] >= 0)):.4f}")
    check(tri_bad == 0 and t_bad == 0, f"{what}: kernel differs from the host oracle")
    return out


def render(renderer, camera, kernel, idle=None):
    """One frame through the user's entry points, launch counts reset just
    before and read just after; ``idle`` is a kernel that must not launch.
    Returns (stats, image, launches by form (nonzero only), wall s)."""
    kernel.reset_counts()
    if idle is not None:
        idle.reset_counts()
    t0 = time.perf_counter()
    stats = renderer.render_frame(camera)
    image = renderer.update_result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(idle is None or idle.launches == 0, f"{idle and idle.name} launched in this frame")
    return stats, image, {k: v for k, v in kernel.launches_by_form.items() if v}, wall


def frame_line(name, renderer, stats, counts, wall):
    tri = renderer.primary.hits.tri
    hit_frac = float((tri >= 0).float().mean())
    print(f"{name}: tracer {stats['tracer']} launches {counts} batches {stats.get('batches')} "
          f"total_rays {stats['total_rays']} rays_traced {stats['rays_traced']} primary hit "
          f"fraction {hit_frac:.4f} trace {stats['trace_time_s'] * 1e3:.3f} ms -> "
          f"{stats['mrays_per_s']:.2f} Mray/s; per-batch kernel ms "
          f"{[round(x * 1e3, 4) for x in stats.get('batch_trace_s', [])]}; phase_s "
          f"{json.dumps({k: round(v, 6) for k, v in renderer.phase_s.items()})}; set-up "
          f"{renderer.setup_s:.2f} s; wall {wall:.2f} s (set-up included)")
    return hit_frac


def check_image(image, what):
    check(image.shape == (HEIGHT, WIDTH, 4) and bool(np.isfinite(image).all()),
          f"{what}: image shape or finiteness")
    check(len(np.unique(image.reshape(-1, 4), axis=0)) > 2, f"{what}: image is uniform")


def timing_line(what, ms, rays, n=None):
    n = rays.num if n is None else n
    print(f"timing {what} ({rays.num} rays, {n} counted): ms {[round(x, 4) for x in ms]} "
          f"best {min(ms):.4f} median {median(ms):.4f} -> {n / (median(ms) * 1e3):.2f} Mray/s "
          "at the median")


def bunny_primary(t0, kernel, dev):
    """Phases 2-5: the bunny primary frame, its checks and its timing."""
    from tpu_rt_torch.bench.workload import suite_camera
    from tpu_rt_torch.bvh import load_or_collapse_quad
    from tpu_rt_torch.bvh.collapse import MAX_LEAF4, trace_quad_scalar
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.scene import Scene, procedural
    from tpu_rt_torch.shade.reconstruct import BG_COLOR
    from tpu_rt_torch.trace import quad_kernel

    # 2. The main path: scene, SBVH, collapse, primary frame, image.
    t1 = time.perf_counter()
    scene = Scene(procedural.scene_by_name(SCENE))
    camera = suite_camera(SCENE, scene)
    renderer = Renderer(WIDTH, HEIGHT, RendererParams(cache_dir=CACHE, device=DEVICE))
    renderer.set_scene(scene)
    print(f"scene: {SCENE} {scene.num_triangles} tris, {scene.num_vertices} vertices "
          f"({time.perf_counter() - t1:.2f} s)")
    stats, image, counts, wall = render(renderer, camera, kernel)
    tables = renderer.tracer_tables
    flat = renderer.flat
    print(f"bvh: {flat.num_nodes} binary nodes, {flat.num_refs} refs, "
          f"{renderer.bvh_stats.num_duplicates} duplicates; quad: {tables.nodes.shape[0]} nodes "
          f"({tables.nodes.numel() * 4 / 1e6:.2f} MB), {tables.woop.shape[0]} woop rows "
          f"({tables.woop.numel() * 4 / 1e6:.2f} MB), depth {tables.depth}, leaf_max {MAX_LEAF4}")
    hit_frac = frame_line(f"{SCENE} primary frame", renderer, stats, counts, wall)
    check(stats["tracer"] == "quad-cuda", f"auto tracer is {stats['tracer']}")
    check(counts == {"closest": 1}, f"the primary path launched {counts}, want the closest-hit "
          "kernel only")
    check_image(image, "primary")
    check(0.05 < hit_frac < 0.95, f"hit fraction {hit_frac}")
    phase("bunny main path done", t0)

    # 3. Kernel vs plain PyTorch version on every ray of the frame.
    rays = renderer.primary.rays
    tri = renderer.primary.hits.tri
    max_abs_err, full, seen = against_plain(kernel, quad_kernel.trace_quad_plain, tables, rays,
                                            False, tri, "bunny primary")
    phase("kernel == plain", t0)

    # 4. Strided subset against the host oracle trace_quad_scalar.
    idx = strided(rays.num, dev)
    quad = load_or_collapse_quad(flat, leaf_max=MAX_LEAF4, cache_dir=CACHE)
    oracle = against_oracle(kernel, tables, partial(trace_quad_scalar, quad),
                            subset(rays, idx), False, "bunny primary")
    s_id = oracle[0]
    # The image at those pixels is the oracle's hit colour.
    pix = renderer.primary.slot_to_id[idx].cpu().numpy()
    expect = np.where((s_id >= 0)[:, None], scene.tri_shaded[np.maximum(s_id, 0)], BG_COLOR[None, :])
    img_bad = int((image.reshape(-1, 4)[pix] != expect).any(axis=1).sum())
    print(f"bunny primary: image pixel mismatches against the oracle's colours {img_bad}")
    check(img_bad == 0, "image differs from the oracle's colours")
    phase("kernel == oracle", t0)

    # 5. Kernel-only times at the main-path shape (CUDA events).
    k_ms = time_ms(lambda: kernel(tables, rays), WARMUP, REPEATS)
    p_ms = time_ms(lambda: quad_kernel.trace_quad_plain(tables, rays), PLAIN_WARMUP, PLAIN_REPEATS)
    best = min(k_ms)
    print(f"timing ({WIDTH}x{HEIGHT} = {rays.num} rays): kernel ms {[round(x, 4) for x in k_ms]} "
          f"best {best:.4f} median {median(k_ms):.4f} -> {WIDTH * HEIGHT / (best * 1e3):.2f} "
          f"Mray/s at best; plain ms {[round(x, 2) for x in p_ms]} median {median(p_ms):.2f} "
          f"-> {WIDTH * HEIGHT / (median(p_ms) * 1e3):.2f} Mray/s")
    phase("bunny timed", t0)
    entry = {"path": f"{SCENE} primary frame, Renderer(tracer='auto')",
             "launches": counts["closest"], "max_abs_err": max_abs_err,
             "ms": median(k_ms), "plain_ms": median(p_ms)}
    ctx = {"scene": scene, "camera": camera, "renderer": renderer, "image": image,
           "idx": idx, "quad": quad, "quad_oracle": oracle, "plain": full, "seen": seen}
    return entry, ctx


def conference(t0, kernel, dev):
    """Phases 6-9: the conference AO and diffuse frames, their checks and
    the timing of both kernel forms on their batches."""
    from tpu_rt_torch.bench.workload import suite_ao_radius, suite_camera
    from tpu_rt_torch.bvh import load_or_collapse_quad
    from tpu_rt_torch.bvh.collapse import MAX_LEAF4, trace_quad_scalar
    from tpu_rt_torch.raygen import RayGen
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.scene import Scene, procedural
    from tpu_rt_torch.shade.reconstruct import BG_COLOR
    from tpu_rt_torch.trace import quad_kernel

    plain = quad_kernel.trace_quad_plain

    # 6. The AO frame through the user's entry points.
    t1 = time.perf_counter()
    scene = Scene(procedural.scene_by_name(SECONDARY_SCENE))
    camera = suite_camera(SECONDARY_SCENE, scene)
    radius = suite_ao_radius(SECONDARY_SCENE, scene)
    scene_s = time.perf_counter() - t1
    print(f"scene: {SECONDARY_SCENE} {scene.num_triangles} tris ({scene_s:.2f} s), "
          f"AO radius {radius:.4f}")
    ao = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type="ao", num_samples=AO_SAMPLES, ao_radius=radius, max_batch=AO_MAX_BATCH,
        cache_dir=CACHE, device=DEVICE))
    ao.set_scene(scene)
    stats, image, counts, wall = render(ao, camera, kernel)
    tables = ao.tracer_tables
    print(f"bvh: {ao.flat.num_nodes} binary nodes, {ao.flat.num_refs} refs; quad: "
          f"{tables.nodes.shape[0]} nodes ({tables.nodes.numel() * 4 / 1e6:.2f} MB), "
          f"{tables.woop.shape[0]} woop rows ({tables.woop.numel() * 4 / 1e6:.2f} MB), "
          f"depth {tables.depth}")
    hit_frac = frame_line(f"{SECONDARY_SCENE} AO frame", ao, stats, counts, wall)
    hits = int((ao.primary.hits.tri >= 0).sum())
    live = sum(int((b.rays.tmax >= 0).sum()) for b in ao._batches)
    occluded = sum(int(((b.rays.tmax >= 0) & (b.hits.tri >= 0)).sum()) for b in ao._batches)
    print(f"AO: primary hits {hits}, live AO rays {live}, occluded fraction {occluded / live:.4f}")
    check(stats["tracer"] == "quad-cuda", f"auto tracer is {stats['tracer']}")
    per_batch = AO_MAX_BATCH // AO_SAMPLES
    want_batches = -(-WIDTH * HEIGHT // per_batch)
    check(stats["batches"] == want_batches,
          f"AO frame has {stats['batches']} batches, want {want_batches}")
    check(counts == {"closest": 1, "any": stats["batches"]},
          f"AO frame launched {counts}: want 1 closest-hit (primary) and 1 any-hit per batch")
    check(stats["total_rays"] == hits * AO_SAMPLES == live, "AO Mray/s numerator")
    check(0.5 < hit_frac and 0.0 < occluded / live < 1.0, "AO hit / occluded fractions")
    check_image(image, "AO")
    ao_counts = counts
    phase("conference AO frame done", t0)

    # 7. Any-hit kernel vs plain on every ray of batch 1, vs the oracle on
    # 8,192 of its rays: all 8 samples of 1,024 pixel-strided primary slots.
    b1 = ao._batches[0]
    lo, hi = b1.input_range
    check(lo == 0 and b1.rays.num == (hi - lo) * AO_SAMPLES == per_batch * AO_SAMPLES,
          "AO batch 1 shape")
    any_err, b1_plain, b1_seen = against_plain(kernel, plain, tables, b1.rays, True, b1.hits.tri,
                                               "AO batch 1")
    quad = load_or_collapse_quad(ao.flat, leaf_max=MAX_LEAF4, cache_dir=CACHE)
    n_px = ORACLE_RAYS // AO_SAMPLES
    slots = torch.arange(0, hi, hi // n_px, device=dev)[:n_px]
    ids = (slots[:, None] * AO_SAMPLES + torch.arange(AO_SAMPLES, device=dev)).reshape(-1)
    b1_idx = b1.id_to_slot[ids].long()
    b1_oracle = against_oracle(kernel, tables, partial(trace_quad_scalar, quad),
                               subset(b1.rays, b1_idx), True, "AO batch 1")
    s_id = b1_oracle[0]
    # The AO colour of those pixels from the oracle's hit / miss.
    colors = np.where((s_id >= 0)[:, None], np.float32([0, 0, 0, 1]), np.float32(1.0))
    expect = colors.reshape(n_px, AO_SAMPLES, 4).mean(axis=1, dtype=np.float32)
    primary_miss = (ao.primary.hits.tri[slots] < 0).cpu().numpy()
    expect[primary_miss] = BG_COLOR
    pix = ao.primary.slot_to_id[slots].cpu().numpy()
    img_bad = int((image.reshape(-1, 4)[pix] != expect).any(axis=1).sum())
    print(f"AO: image pixel mismatches against the oracle's hit / miss at {n_px} pixels: {img_bad}")
    check(img_bad == 0, "AO image differs from the oracle's occlusion")
    phase("any-hit kernel == plain, oracle", t0)

    # 8. The diffuse frame (1 sample): the closest-hit kernel on secondary rays.
    dif = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type="diffuse", num_samples=1, cache_dir=CACHE, device=DEVICE))
    dif.set_scene(scene)
    stats_d, image_d, counts_d, wall_d = render(dif, camera, kernel)
    frame_line(f"{SECONDARY_SCENE} diffuse frame", dif, stats_d, counts_d, wall_d)
    check(bits_differ(dif.tracer_tables.nodes, tables.nodes) == 0
          and bits_differ(dif.tracer_tables.woop, tables.woop) == 0, "rebuilt tables differ")
    check(torch.equal(dif.primary.hits.tri, ao.primary.hits.tri), "primary hits differ")
    check(stats_d["batches"] == 1 and counts_d == {"closest": 2},
          f"diffuse frame launched {counts_d} in {stats_d['batches']} batches")
    check(stats_d["total_rays"] == hits, "diffuse Mray/s numerator")
    check_image(image_d, "diffuse")
    bd = dif._batches[0]
    dif_err, _, _ = against_plain(kernel, plain, tables, bd.rays, False, bd.hits.tri,
                                  "diffuse batch")
    d_idx = strided(bd.rays.num, dev)
    against_oracle(kernel, tables, partial(trace_quad_scalar, quad),
                   subset(bd.rays, d_idx), False, "diffuse batch")
    phase("diffuse frame, closest-hit kernel == plain, oracle", t0)

    # 9. Kernel-only times; Mray/s as bench.py counts it: primary hits x
    # samples over kernel time.
    b1_live = int((b1.rays.tmax >= 0).sum())
    k_b1 = time_ms(lambda: kernel(tables, b1.rays, any_hit=True), WARMUP, REPEATS)
    rays_s1 = RayGen().ao(ao.primary.rays, ao.primary.hits,
                          torch.as_tensor(scene.tri_normal, device=dev), 1, radius, True)[0]
    k_s1 = time_ms(lambda: kernel(tables, rays_s1, any_hit=True), WARMUP, REPEATS)
    k_dif = time_ms(lambda: kernel(tables, bd.rays), WARMUP, REPEATS)
    p_b1 = time_ms(lambda: plain(tables, b1.rays, any_hit=True), PLAIN_WARMUP, PLAIN_REPEATS)
    timing_line("any-hit kernel, AO batch 1", k_b1, b1.rays, b1_live)
    timing_line("any-hit kernel, 1-sample AO batch", k_s1, rays_s1, hits)
    timing_line("closest-hit kernel, diffuse batch", k_dif, bd.rays, hits)
    timing_line("plain any-hit, AO batch 1", p_b1, b1.rays, b1_live)
    phase("conference timed", t0)
    anyhit = {"path": f"{SECONDARY_SCENE} AO frame, Renderer(tracer='auto')",
              "launches": ao_counts["any"], "max_abs_err": any_err,
              "ms": median(k_b1), "plain_ms": median(p_b1)}
    closest = {"max_abs_err": dif_err}
    ctx = {"scene": scene, "camera": camera, "radius": radius, "ao": ao, "dif": dif,
           "b1_idx": b1_idx, "d_idx": d_idx, "b1_plain": b1_plain, "b1_oracle": b1_oracle,
           "b1_seen": b1_seen,
           "occluded": occluded / live, "occluded_n": occluded,
           "b1_live": b1_live, "hits": hits}
    return anyhit, closest, ctx


def binary_bunny(t0, flat_k, quad_k, bctx):
    """Phase 10: the bunny primary frame on the binary kernel."""
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.trace import RayStats, flat_kernel, trace_flat_scalar

    scene, camera, quad_r = bctx["scene"], bctx["camera"], bctx["renderer"]
    r = Renderer(WIDTH, HEIGHT, RendererParams(cache_dir=CACHE, device=DEVICE, tracer="packet"))
    r.set_scene(scene)
    stats, image, counts, wall = render(r, camera, flat_k, idle=quad_k)
    tables = r.tracer_tables
    print(f"binary bvh: {tables.nodes.shape[0]} nodes ({tables.nodes.numel() * 4 / 1e6:.2f} MB), "
          f"{tables.woop.shape[0]} woop rows ({tables.woop.numel() * 4 / 1e6:.2f} MB), depth "
          f"{tables.depth} (quad depth {quad_r.tracer_tables.depth})")
    hit_frac = frame_line(f"{SCENE} primary frame, binary", r, stats, counts, wall)
    check(stats["tracer"] == "flat-cuda", f"packet tracer is {stats['tracer']}")
    check(counts == {"closest": 1}, f"the binary primary path launched {counts}")
    check_image(image, "binary primary")
    check(0.05 < hit_frac < 0.95, f"hit fraction {hit_frac}")
    rays, hits = r.primary.rays, r.primary.hits
    check(all(torch.equal(a, b) for a, b in zip(rays, quad_r.primary.rays)),
          "the two renderers' primary rays differ")
    phase("binary bunny main path done", t0)

    err, full, seen = against_plain(flat_k, flat_kernel.trace_flat_plain, tables, rays, False,
                                    hits.tri, "binary bunny primary")
    st = RayStats()
    flat = r.flat
    oracle = against_oracle(flat_k, tables,
                            partial(trace_flat_scalar, flat),
                            subset(rays, bctx["idx"]), False, "binary bunny primary", stats=st)
    # Against the quad kernel's frame: the same geometric query, so t is
    # bit-equal on every ray; tri may differ only at exact-t ties, and the
    # image only at those pixels.
    q_hits = quad_r.primary.hits
    t_bad = bits_differ(hits.t, q_hits.t)
    tie = (hits.tri != q_hits.tri).cpu().numpy()
    tie_px = set(r.primary.slot_to_id.cpu().numpy()[np.nonzero(tie)[0]].tolist())
    img_px = set(np.nonzero((image.reshape(-1, 4) != bctx["image"].reshape(-1, 4)).any(1))[0]
                 .tolist())
    print(f"binary vs quad frame: t bit mismatches {t_bad}, tri differing at exact-t ties "
          f"{int(tie.sum())}, image pixels differing {len(img_px)} (all at tie pixels: "
          f"{img_px <= tie_px})")
    check(t_bad == 0, "binary and quad t differ")
    check(img_px <= tie_px, "binary and quad images differ off the tie pixels")
    phase("binary kernel == plain, oracle, quad", t0)
    entry = {"path": f"{SCENE} primary frame, Renderer(tracer='packet')",
             "launches": counts["closest"], "max_abs_err": err}
    return entry, {"renderer": r, "plain": full, "oracle": oracle, "stats": st, "seen": seen}


def binary_conference(t0, flat_k, quad_k, cctx):
    """Phase 11: the conference AO and diffuse frames on the binary kernel."""
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.trace import RayStats, flat_kernel, trace_flat_scalar

    scene, camera, quad_ao = cctx["scene"], cctx["camera"], cctx["ao"]
    plain = flat_kernel.trace_flat_plain
    ao = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type="ao", num_samples=AO_SAMPLES, ao_radius=cctx["radius"], max_batch=AO_MAX_BATCH,
        cache_dir=CACHE, device=DEVICE, tracer="packet"))
    ao.set_scene(scene)
    stats, image, counts, wall = render(ao, camera, flat_k, idle=quad_k)
    tables = ao.tracer_tables
    print(f"binary bvh: {tables.nodes.shape[0]} nodes ({tables.nodes.numel() * 4 / 1e6:.2f} MB), "
          f"{tables.woop.shape[0]} woop rows ({tables.woop.numel() * 4 / 1e6:.2f} MB), depth "
          f"{tables.depth}")
    frame_line(f"{SECONDARY_SCENE} AO frame, binary", ao, stats, counts, wall)
    live = sum(int((b.rays.tmax >= 0).sum()) for b in ao._batches)
    occluded = sum(int(((b.rays.tmax >= 0) & (b.hits.tri >= 0)).sum()) for b in ao._batches)
    check(stats["tracer"] == "flat-cuda", f"packet tracer is {stats['tracer']}")
    check(counts == {"closest": 1, "any": stats["batches"]}, f"binary AO frame launched {counts}")
    check_image(image, "binary AO")
    b1, q_b1 = ao._batches[0], quad_ao._batches[0]
    # The primary pre-trace: t bit-equal to the quad path's; tri may differ
    # at exact-t ties, and then that pixel's AO rays start from another
    # triangle's normal.
    p_t_bad = bits_differ(ao.primary.hits.t, quad_ao.primary.hits.t)
    p_ties = int((ao.primary.hits.tri != quad_ao.primary.hits.tri).sum())
    b1_differ = int((b1.rays.dirn != q_b1.rays.dirn).any(1).sum())
    print(f"binary AO: occluded fraction {occluded / live:.4f} ({occluded} of {live}; quad path "
          f"{cctx['occluded']:.4f}); primary pre-trace t bit mismatches {p_t_bad}, tri differing "
          f"at exact-t ties {p_ties}; batch-1 rays differing from the quad path's {b1_differ}")
    check(p_t_bad == 0, "binary and quad primary t differ")
    phase("binary conference AO frame done", t0)

    any_err, full, seen = against_plain(flat_k, plain, tables, b1.rays, True, b1.hits.tri,
                                        "binary AO batch 1")
    st = RayStats()
    flat = ao.flat
    oracle = against_oracle(flat_k, tables, partial(trace_flat_scalar, flat),
                            subset(b1.rays, cctx["b1_idx"]), True, "binary AO batch 1", stats=st)
    # Hit / miss per ray equal to the quad any-hit kernel's on the same
    # rays (every batch), so the occluded fractions are equal exactly.
    hm_bad, q_occluded = 0, 0
    for b in ao._batches:
        q = quad_k(quad_ao.tracer_tables, b.rays, any_hit=True)
        hm_bad += int(((q.tri >= 0) != (b.hits.tri >= 0)).sum())
        q_occluded += int(((b.rays.tmax >= 0) & (q.tri >= 0)).sum())
    print(f"binary AO: hit / miss mismatches against the quad any-hit kernel on the same rays "
          f"{hm_bad} of {ao.rays_traced}; occluded {occluded} (binary) and {q_occluded} (quad) of "
          f"{live}; the quad path's own frame {cctx['occluded_n']}")
    check(hm_bad == 0 and occluded == q_occluded,
          "binary and quad any-hit kernels disagree on occlusion")
    phase("binary any-hit kernel == plain, oracle, quad", t0)

    dif = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type="diffuse", num_samples=1, cache_dir=CACHE, device=DEVICE, tracer="packet"))
    dif.set_scene(scene)
    stats_d, image_d, counts_d, wall_d = render(dif, camera, flat_k, idle=quad_k)
    frame_line(f"{SECONDARY_SCENE} diffuse frame, binary", dif, stats_d, counts_d, wall_d)
    check(stats_d["batches"] == 1 and counts_d == {"closest": 2},
          f"binary diffuse frame launched {counts_d}")
    check_image(image_d, "binary diffuse")
    bd = dif._batches[0]
    dif_err, _, _ = against_plain(flat_k, plain, tables, bd.rays, False, bd.hits.tri,
                                  "binary diffuse batch")
    against_oracle(flat_k, tables, partial(trace_flat_scalar, flat),
                   subset(bd.rays, cctx["d_idx"]), False, "binary diffuse batch")
    phase("binary diffuse frame, closest-hit kernel == plain, oracle", t0)
    anyhit = {"path": f"{SECONDARY_SCENE} AO frame, Renderer(tracer='packet')",
              "launches": counts["any"], "max_abs_err": any_err}
    closest = {"max_abs_err": dif_err}
    return anyhit, closest, {"ao": ao, "dif": dif, "plain": full, "oracle": oracle, "stats": st,
                             "seen": seen}


def warp_efficiency(work: torch.Tensor) -> float:
    """Mean work per ray over the mean, over 32-ray launch-order groups, of
    the group's largest: the share of a warp's lanes busy per step."""
    w = work.float()
    pad = (-w.numel()) % 32
    w = torch.cat([w, w.new_zeros(pad)])
    return float(w.sum() / (w.view(-1, 32).amax(1).sum() * 32))


def uv_and_stats(t0, quad_k, flat_k, bctx, fb, cctx, fc):
    """Phase 12: the want_uv and with_stats forms of both kernels through
    make_routing_tracer, on bunny primary (uv: closest and any hit; stats:
    closest hit) and conference AO batch 1 (stats: any hit), against the
    plain versions on every ray and the oracles on the subsets."""
    from tpu_rt_torch.bvh.collapse import trace_quad_scalar
    from tpu_rt_torch.trace import (
        RayStats,
        flat_kernel,
        make_routing_tracer,
        quad_kernel,
        trace_flat_scalar,
    )
    from tpu_rt_torch.trace.common import form_name

    dev = torch.device(DEVICE, 0)
    bunny, conf = "bunny primary", "conference AO batch 1"
    # Each kernel on its own renderer's rays (a primary hit that ties in t
    # may pick another triangle, and then its AO rays differ).
    cases = ((bunny, {"quad": bctx["renderer"].primary.rays, "flat": fb["renderer"].primary.rays},
              bctx["idx"], fb["renderer"].flat, (False, True), False),
             (conf, {"quad": cctx["ao"]._batches[0].rays, "flat": fc["ao"]._batches[0].rays},
              cctx["b1_idx"], fc["ao"].flat, (), True))
    kernels = (("quad", quad_k, "packet4", quad_kernel.trace_quad_plain),
               ("flat", flat_k, "packet", flat_kernel.trace_flat_plain))
    # Full-form plain results and oracle results the earlier phases made.
    plains = {("quad", bunny, False): bctx["plain"], ("quad", conf, True): cctx["b1_plain"],
              ("flat", bunny, False): fb["plain"], ("flat", conf, True): fc["plain"]}
    oracles = {("quad", bunny, False): (bctx["quad_oracle"], None),
               ("quad", conf, True): (cctx["b1_oracle"], None),
               ("flat", bunny, False): (fb["oracle"], fb["stats"]),
               ("flat", conf, True): (fc["oracle"], fc["stats"])}
    out = {name: {"uv_err": 0.0, "stats_err": 0.0} for name, *_ in kernels}
    census = []
    for label, ray_sets, idx, flat, uv_any, stats_any in cases:
        for name, kern, prefer, plain in kernels:
            rays = ray_sets[name]
            sub = subset(rays, idx)
            sub_np = [x.cpu().numpy() for x in sub]
            fn_uv, kind, tables = make_routing_tracer(flat, prefer=prefer, device=dev,
                                                      want_uv=True, cache_dir=CACHE)
            fn, kind2, _ = make_routing_tracer(flat, prefer=prefer, device=dev, cache_dir=CACHE)
            check(kind == kind2 == f"{name}-cuda", f"{prefer} route is {kind}")
            # The user's calls, launch counts reset just before, read after.
            kern.reset_counts()
            got = [(a, False, fn_uv(tables, rays, any_hit=a)) for a in uv_any]
            got.append((stats_any, True, fn(tables, rays, any_hit=stats_any, with_stats=True)))
            torch.cuda.synchronize()
            counts = {k: v for k, v in kern.launches_by_form.items() if v}
            want_counts = {form_name(a, not st, st): 1 for a, st, _ in got}
            print(f"{label}, {name}: launches {counts}")
            check(counts == want_counts, f"{label} {name} launched {counts}, want {want_counts}")
            if label == bunny:
                # The kernels line's uv and stats entries: this run's counts.
                for what in ("uv", "stats"):
                    out[name][f"{what}_launches"] = sum(v for k, v in counts.items()
                                                        if f"_{what}" in k)
            for a, st, res in got:
                what = "stats" if st else "uv"
                hits, cnt = res if st else (res, None)
                key = (name, label, a)
                if key not in plains:
                    plains[key] = plain(tables, rays, a, True, True)
                want, want_cnt = plains[key]
                fields = ("t",) if st else ("t", "u", "v")
                bad = {k: bits_differ(getattr(hits, k), getattr(want, k)) for k in fields}
                bad["tri"] = int((hits.tri != want.tri).sum())
                if st:
                    bad.update({k: int((cnt[k] != want_cnt[k]).sum()) for k in cnt})
                    check(not hits.u.any() and not hits.v.any(), "the stats form wrote u, v")
                err = max(float((getattr(hits, k) - getattr(want, k)).abs().max()) for k in fields)
                out[name][f"{what}_err"] = max(out[name][f"{what}_err"], err)
                print(f"{label}, {name} {what} form (any_hit={a}) vs plain on {rays.num} rays: "
                      f"mismatches {bad}, max |d| {err}")
                check(not any(bad.values()), f"{label} {name} {what} form differs from plain")
                # The oracles on the subset: tri, t (and u, v) bit-equal; the
                # binary kernel's counters equal RayStats.
                if key not in oracles:
                    t1 = time.perf_counter()
                    if name == "quad":
                        oracles[key] = (trace_quad_scalar(bctx["quad"], *sub_np, any_hit=a), None)
                    else:
                        rs = RayStats()
                        oracles[key] = (trace_flat_scalar(flat, *sub_np, any_hit=a, stats=rs), rs)
                    print(f"{name} oracle (any_hit={a}) on {sub.num} rays: "
                          f"{time.perf_counter() - t1:.1f} s on the host")
                s, rs = oracles[key]
                k = [x[idx].cpu().numpy() for x in hits]
                bad = {"tri": int((k[0] != s[0]).sum())}
                bad.update({f: np_bits_differ(k[i], s[i]) for i, f in enumerate(("t", "u", "v"), 1)
                            if f in fields})
                if st and rs is not None:
                    bad["node_tests"] = int((cnt["node_tests"][idx].cpu().numpy()
                                             != rs.per_ray_node_tests).sum())
                    bad["tri_tests"] = int((cnt["tri_tests"][idx].cpu().numpy()
                                            != rs.per_ray_tri_tests).sum())
                print(f"{label}, {name} {what} form (any_hit={a}) vs the oracle on {sub.num} "
                      f"rays: mismatches {bad}")
                check(not any(bad.values()), f"{label} {name} {what} form differs from the oracle")
                if st:
                    census.append((label, name, cnt))
    for label in (bunny, conf):
        parts = []
        for label2, name, cnt in census:
            if label2 == label:
                nt, tt = cnt["node_tests"], cnt["tri_tests"]
                parts.append(f"{name}: node_tests/ray {float(nt.float().mean()):.3f}, "
                             f"tri_tests/ray {float(tt.float().mean()):.3f}, warp efficiency "
                             f"{warp_efficiency(nt + tt):.4f}")
        print(f"census, {label}: " + "; ".join(parts))
    phase("uv and stats forms == plain, oracles", t0)
    return out


def xla_route(t0, fb, bctx):
    """Phase 13: the wavefront tracer ("xla") on bunny primary."""
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.trace import trace_flat_scalar

    r = Renderer(WIDTH, HEIGHT, RendererParams(cache_dir=CACHE, device=DEVICE, tracer="xla"))
    r.set_scene(bctx["scene"])
    t1 = time.perf_counter()
    stats = r.render_frame(bctx["camera"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    check(stats["tracer"] == "wavefront", f"xla tracer is {stats['tracer']}")
    got, want = r.primary.hits, fb["renderer"].primary.hits
    bad = (got.tri != want.tri).cpu().numpy()
    ids = np.nonzero(bad)[0]
    wrong = 0
    if ids.size:
        # bench.py's rules: an fp tie or an edge graze is allowed.  The
        # wavefront divides Oz / Dz where the oracle multiplies by 1 / Dz,
        # so the graze may be on either side: the oracle's hit near an edge,
        # or the wavefront's (its own u, v).
        rays = r.primary.rays
        s_id, s_t, s_u, s_v = trace_flat_scalar(fb["renderer"].flat,
                                                *(x.cpu().numpy()[ids] for x in rays))
        g_tri, g_t, g_u, g_v = (x.cpu().numpy()[ids] for x in got)
        exact = g_tri == s_id
        tie = ~exact & np.isclose(g_t, s_t, rtol=2e-4, atol=1e-5)
        margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
        g_margin = np.minimum(np.minimum(g_u, g_v), 1.0 - g_u - g_v)
        graze = ~exact & ~tie & (((s_id >= 0) & (margin < 1e-3))
                                 | ((g_tri >= 0) & (g_margin < 1e-3)))
        wrong = int((~exact & ~tie & ~graze).sum())
        for i in range(ids.size):
            print(f"  disputed ray {ids[i]}: wavefront tri {g_tri[i]} t {g_t[i]} u {g_u[i]} "
                  f"v {g_v[i]}; oracle tri {s_id[i]} t {s_t[i]} u {s_u[i]} v {s_v[i]}; "
                  f"{'exact' if exact[i] else 'tie' if tie[i] else 'graze' if graze[i] else 'WRONG'}")
    hit = (want.tri >= 0)
    dt = float((got.t - want.t)[hit].abs().max()) if bool(hit.any()) else 0.0
    print(f"xla route (wavefront) on {WIDTH}x{HEIGHT}: wall {wall:.3f} s (set-up {r.setup_s:.2f} s; "
          f"trace {stats['trace_time_s']:.3f} s); tri differing from the binary kernel {ids.size}, "
          f"wrong after oracle adjudication {wrong}; max |dt| on hits {dt}")
    check(wrong == 0, "the wavefront disagrees with the oracle")
    phase("xla route == binary kernel", t0)
    return wall


def binary_timing(t0, quad_k, flat_k, bctx, fb, cctx, fc):
    """Phase 14: kernel-only times of the binary kernel and of the uv and
    stats forms of both kernels, each beside its plain version."""
    from tpu_rt_torch.trace import flat_kernel, quad_kernel

    rays = fb["renderer"].primary.rays
    ft, qt = fb["renderer"].tracer_tables, bctx["renderer"].tracer_tables
    ft_c = fc["ao"].tracer_tables
    b1 = fc["ao"]._batches[0]
    bd = fc["dif"]._batches[0]
    fplain, qplain = flat_kernel.trace_flat_plain, quad_kernel.trace_quad_plain
    res = {}
    for what, kern, tables, r, a, n in (
            ("flat closest-hit, bunny primary", flat_k, ft, rays, False, rays.num),
            ("flat closest-hit, diffuse batch", flat_k, ft_c, bd.rays, False, cctx["hits"]),
            ("flat any-hit, AO batch 1", flat_k, ft_c, b1.rays, True, cctx["b1_live"])):
        k = time_ms(lambda: kern(tables, r, any_hit=a), WARMUP, REPEATS)
        p = time_ms(lambda: fplain(tables, r, any_hit=a), PLAIN_WARMUP, PLAIN_REPEATS)
        timing_line(what, k, r, n)
        timing_line(f"plain {what}", p, r, n)
        res[what] = (median(k), median(p))
    for name, kern, tables, plain in (("quad", quad_k, qt, qplain), ("flat", flat_k, ft, fplain)):
        for a in (False, True):
            for uv, stats in ((False, False), (True, False), (False, True), (True, True)):
                k = time_ms(lambda: kern(tables, rays, a, uv, stats), WARMUP, REPEATS)
                timing_line(f"{name} any_hit={a} want_uv={uv} with_stats={stats}, bunny primary",
                            k, rays)
                res[(name, a, uv, stats)] = median(k)
        for uv, stats in ((True, False), (False, True)):
            p = time_ms(lambda: plain(tables, rays, False, uv, stats), PLAIN_WARMUP,
                        PLAIN_REPEATS)
            timing_line(f"plain {name} want_uv={uv} with_stats={stats}, bunny primary", p, rays)
            res[(name, "plain", uv, stats)] = median(p)
    phase("binary and uv / stats forms timed", t0)
    return res


# ---------------------------------------------------------------------------
# Phases 15-19: the large-scene path on dragon
# ---------------------------------------------------------------------------

# Operations per slab test of one child box (6 mul, 6 sub, 10 min/max,
# 3 compares) and per Woop triangle test (the part every test runs: Oz and
# Dz, 1 / Dz, t, two compares), and per ray (1 / d, o / d); the operation
# term of a kernel's bound counts these for this run's node and triangle
# tests (the plain version's counters).
SLAB_OPS, WOOP_OPS, RAY_OPS = 25, 15, 6
PEAK_F32_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
PEAK_F64_TENSOR_FLOPS = 67e12   # H100 SXM, FP64 tensor cores (DMMA)
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
RAY_IN_BYTES, HIT_OUT_BYTES = 32, 8
# The tensor-core leaf test per candidate: 6 dot products of 4 terms (48
# f64 operations on the tensor cores), then the f32 epilogue (a division,
# 2 multiplies, 3 adds and 6 compares).
MXU_DOT_OPS, MXU_EPI_OPS = 48, 12


def bound(what, tables, rays, counts, seen, boxes, want_uv=False, with_stats=False, mxu=False):
    """The least time of one trace (ms) and what bounds it: the larger of
    the operations its node and triangle tests need over the peak of their
    type (f32; with ``mxu`` the triangle tests' dot products at the FP64
    tensor rate), and the bytes it must move over the memory rate: each
    table row that this run's rays read (``seen``, the plain version's
    ``visited`` masks), once, plus rays in and hits out.  Prints both
    terms."""
    nt = float(counts["node_tests"].double().sum())
    tt = float(counts["tri_tests"].double().sum())
    if mxu:
        ops = nt * boxes * SLAB_OPS + tt * MXU_EPI_OPS + rays.num * RAY_OPS
        t_dots = tt * MXU_DOT_OPS / PEAK_F64_TENSOR_FLOPS * 1e3
    else:
        ops = nt * boxes * SLAB_OPS + tt * WOOP_OPS + rays.num * RAY_OPS
        t_dots = 0.0
    rows = {}
    for name, mask in seen.items():
        x = getattr(tables, name)
        rows[name] = (int(mask.sum()), mask.numel(),
                      x.element_size() * (x.shape[1] if x.dim() > 1 else 1))
    table_b = sum(r * b for r, _, b in rows.values())
    out_b = HIT_OUT_BYTES + (8 if want_uv else 0) + (8 if with_stats else 0)
    nbytes = table_b + rays.num * (RAY_IN_BYTES + out_b)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3 + t_dots, nbytes / PEAK_BYTES * 1e3
    print(f"bound {what}: rows read " + ", ".join(f"{k} {r} of {n} ({r * b} B)"
                                                  for k, (r, n, b) in rows.items())
          + f"; {nbytes} B in all -> {t_bytes:.6f} ms; {ops:.6g} f32 operations"
          + (f" + {tt * MXU_DOT_OPS:.6g} f64 tensor operations" if mxu else "")
          + f" -> {t_ops:.6f} ms")
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes
            else "bytes"}


def woop_hit(flat, tri, o, d, tmin, tmax):
    """(t, accepted) of triangle ``tri`` along each ray, in the kernels' f32
    ops and order (trace_common.cuh ``drain``)."""
    tri_index = np.asarray(flat.tri_index)
    rows = np.array([np.flatnonzero(tri_index == i)[0] for i in tri], np.int64)
    w = np.asarray(flat.tri_woop, np.float32)[rows]
    oz = w[:, 3] - o[:, 0] * w[:, 0] - o[:, 1] * w[:, 1] - o[:, 2] * w[:, 2]
    dz = d[:, 0] * w[:, 0] + d[:, 1] * w[:, 1] + d[:, 2] * w[:, 2]
    t = oz * (np.float32(1.0) / dz)
    ox = w[:, 7] + o[:, 0] * w[:, 4] + o[:, 1] * w[:, 5] + o[:, 2] * w[:, 6]
    dx = d[:, 0] * w[:, 4] + d[:, 1] * w[:, 5] + d[:, 2] * w[:, 6]
    oy = w[:, 11] + o[:, 0] * w[:, 8] + o[:, 1] * w[:, 9] + o[:, 2] * w[:, 10]
    dy = d[:, 0] * w[:, 8] + d[:, 1] * w[:, 9] + d[:, 2] * w[:, 10]
    u, v = ox + t * dx, oy + t * dy
    return t, (t > tmin) & (t < tmax) & (u >= 0) & (v >= 0) & (u + v <= 1.0)


def adjudicate(flat, sub_np, got_tri, got_t, s_id, s_t, what):
    """A closest-hit result against the oracle's on a subset: t bit-equal
    on every ray; where tri differs, the result's own triangle must be hit
    at exactly the oracle's t (an exact-t tie).  Returns the tie count."""
    t_bad = np_bits_differ(got_t, s_t)
    ids = np.nonzero(got_tri != s_id)[0]
    wrong = 0
    if ids.size:
        o, d, tmin, tmax = (x[ids] for x in sub_np)
        both = (got_tri[ids] >= 0) & (s_id[ids] >= 0)
        tt, ok = woop_hit(flat, np.maximum(got_tri[ids], 0), o, d, tmin, tmax)
        tie = both & ok & (tt.view(np.int32) == np.asarray(s_t[ids], np.float32).view(np.int32))
        wrong = int((~tie).sum())
        for i, j in enumerate(ids):
            print(f"  {what}: disputed ray {j}: tri {got_tri[j]} (its own t {tt[i]}) against the "
                  f"oracle's {s_id[j]} at t {s_t[j]}: {'exact-t tie' if tie[i] else 'WRONG'}")
    print(f"{what}: vs trace_flat_scalar on {len(s_id)} rays: t bit mismatches {t_bad}, tri "
          f"disputes {ids.size}, of them not an exact-t tie {wrong}")
    check(t_bad == 0 and wrong == 0, f"{what}: differs from the oracle beyond exact-t ties")
    return ids.size


def replaces(kernel: str, residency: str, bf16_nodes: bool, any_hit: bool) -> str:
    """The ``replaces`` field of a form of this slice: the TPU kernel's lines
    of its node unit, its residency and, for the binary kernel, bf16 nodes."""
    unit = ("4-wide node unit :618-679, trace_packet4 :1168-1175" if kernel == "quad_trace"
            else "bf16 node unit :680-703 on pack_tables2 :238-255" if bf16_nodes
            else "binary f32 node unit :704-770")
    res = "" if residency == "vmem" else f", {residency} residency :501-515, :906-944"
    return f"{PACKET2} ({unit}{res}{', any_hit=True :552-567' if any_hit else ''})"


def dragon_setup(t0, quad_k, flat_k, dev):
    """Phase 15: the dragon scene, its BVH (built once into the shared
    cache), both quad collapses, table bytes, the card's L2 and the routing
    decisions at the default budget (none), at the card's largest
    persisting-L2 set-aside and at tpu_rt's 12 MiB."""
    from tpu_rt_torch.bvh import BuildParams, Platform, load_or_build_bvh, load_or_collapse_quad
    from tpu_rt_torch.scene import Scene, procedural
    from tpu_rt_torch.trace import choose_node_format, quad_policy
    from tpu_rt_torch.trace.common import tree_depth
    from tpu_rt_torch.trace.tables import (
        BF16_NODE_BYTES,
        FLAT_NODE_BYTES,
        QUAD_NODE_BYTES,
        TABLE_BUDGET,
        VMEM_TABLE_BUDGET,
        WOOP_ROW_BYTES,
        quad_residency,
    )

    t1 = time.perf_counter()
    scene = Scene(procedural.scene_by_name(DRAGON))
    mesh_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    flat, bstats = load_or_build_bvh(scene, Platform.gpu(), BuildParams(), cache_dir=CACHE)
    sbvh_s = time.perf_counter() - t1
    quads, collapse_s = {}, {}
    for leaf in (16, 32):
        t1 = time.perf_counter()
        quads[leaf] = load_or_collapse_quad(flat, leaf_max=leaf, cache_dir=CACHE)
        collapse_s[leaf] = time.perf_counter() - t1
    n, r = flat.nodes.shape[0], flat.tri_woop.shape[0]
    depth = tree_depth(np.ascontiguousarray(flat.nodes[:, 12:14]).view(np.int32))
    q_depth = {k: tree_depth(np.ascontiguousarray(q.nodes[:, 24:28]).view(np.int32))
               for k, q in quads.items()}
    print(f"scene: {DRAGON} {scene.num_triangles} tris, {scene.num_vertices} vertices; mesh "
          f"{mesh_s:.2f} s, SBVH {sbvh_s:.2f} s, collapse leaf 16 {collapse_s[16]:.2f} s, leaf 32 "
          f"{collapse_s[32]:.2f} s")
    print(f"bvh: binary {n} nodes, depth {depth}, {bstats.num_duplicates} duplicates; quad leaf 16 "
          f"{quads[16].nodes.shape[0]} nodes, depth {q_depth[16]}; quad leaf 32 "
          f"{quads[32].nodes.shape[0]} nodes, depth {q_depth[32]}")
    sizes = {"binary f32 nodes": n * FLAT_NODE_BYTES, "binary bf16 nodes": n * BF16_NODE_BYTES,
             "woop rows": r * WOOP_ROW_BYTES,
             "quad nodes leaf 16": quads[16].nodes.shape[0] * QUAD_NODE_BYTES,
             "quad nodes leaf 32": quads[32].nodes.shape[0] * QUAD_NODE_BYTES,
             "quad woop rows leaf 16": quads[16].tri_woop.shape[0] * WOOP_ROW_BYTES,
             "quad woop rows leaf 32": quads[32].tri_woop.shape[0] * WOOP_ROW_BYTES}
    print("table bytes: " + ", ".join(f"{k} {v} ({v / 1e6:.2f} MB)" for k, v in sizes.items()))
    check(scene.num_triangles == 910_348, "dragon triangle count")
    l2 = flat_k.l2_info(dev)
    print(f"L2: {l2['l2_bytes']} B, largest persisting set-aside {l2['max_persisting_l2']} B, "
          f"largest access-policy window {l2['max_window']} B")
    decisions = {}
    for label, budget in (("default", TABLE_BUDGET), ("L2 set-aside", l2["max_persisting_l2"]),
                          ("tpu_rt 12 MiB", VMEM_TABLE_BUDGET)):
        res, bf16 = choose_node_format(flat, budget)
        leaf = quad_policy(flat, CACHE, budget)
        q = quads[leaf]
        qres = quad_residency(q.nodes.shape[0] * QUAD_NODE_BYTES,
                              max(q.tri_woop.shape[0], 1) * WOOP_ROW_BYTES, budget)
        decisions[label] = {"binary": (res, bf16), "quad": (leaf, qres)}
        print(f"routing at {label} ({budget} B): packet -> {res} {'bf16' if bf16 else 'f32'} "
              f"nodes; auto -> quad leaf {leaf} {qres}")
    check(decisions["default"] == {"binary": ("vmem", False), "quad": (16, "vmem")},
          "the default budget must keep dragon on the vmem f32 forms")
    check(decisions["tpu_rt 12 MiB"] == {"binary": ("mixed", True), "quad": (32, "mixed")},
          "at 12 MiB the policy must give tpu_rt's dragon targets")
    phase("dragon set-up done", t0)
    return {"scene": scene, "flat": flat, "quads": quads, "decisions": decisions,
            "sizes": sizes, "l2": l2}


def tree_of(tables) -> str:
    from tpu_rt_torch.trace import FlatTables

    if isinstance(tables, FlatTables):
        return "binary bf16" if tables.bf16_nodes else "binary f32"
    return f"quad {tables.nodes.shape[0]} nodes"


def kernel_of(tables, quad_k, flat_k):
    from tpu_rt_torch.trace import FlatTables

    return flat_k if isinstance(tables, FlatTables) else quad_k


def layout_key(tables) -> str:
    from tpu_rt_torch.trace.common import layout_name

    return layout_name(tables.residency, getattr(tables, "bf16_nodes", False))


def dragon_frames(t0, quad_k, flat_k, dev, dctx):
    """Phases 16-18: the dragon primary frame through Renderer("auto") and
    Renderer("packet") at the default budget, the AO frame through
    Renderer("packet"), and tpu_rt's forced large-scene forms on the same
    rays through make_routing_tracer, each its own path; every form against
    its plain version on every ray, against the oracles on 8,192 rays, and
    t across forms."""
    from tpu_rt_torch.bench.workload import suite_ao_radius, suite_camera
    from tpu_rt_torch.bvh.collapse import trace_quad_scalar
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.trace import (
        VMEM_TABLE_BUDGET,
        flat_kernel,
        make_routing_tracer,
        quad_kernel,
        release_persisting_l2,
        trace_flat_scalar,
    )

    scene, flat, dec = dctx["scene"], dctx["flat"], dctx["decisions"]["default"]
    camera = suite_camera(DRAGON, scene)
    res, bf16 = dec["binary"]
    leaf, qres = dec["quad"]
    want_packet = "flat-cuda" + ("" if res == "vmem" else f"-{res}") + ("-bf16" if bf16 else "")
    want_auto = "quad-cuda" + ("" if qres == "vmem" else f"-{qres}")

    # 16. The primary frame through the user's entry points, default budget.
    frames = {}
    for prefer, kern, idle, want in (("auto", quad_k, flat_k, want_auto),
                                     ("packet", flat_k, quad_k, want_packet)):
        r = Renderer(WIDTH, HEIGHT, RendererParams(cache_dir=CACHE, device=DEVICE, tracer=prefer))
        r.set_scene(scene)
        stats, image, counts, wall = render(r, camera, kern, idle=idle)
        hit_frac = frame_line(f"{DRAGON} primary frame, tracer={prefer!r}", r, stats, counts, wall)
        check(stats["tracer"] == want, f"{prefer} tracer is {stats['tracer']}, want {want}")
        key = "closest" + layout_key(r.tracer_tables)
        check(counts == {key: 1}, f"dragon {prefer} frame launched {counts}, want {{{key}: 1}}")
        check_image(image, f"dragon {prefer} primary")
        check(0.05 < hit_frac < 0.95, f"hit fraction {hit_frac}")
        frames[prefer] = {"renderer": r, "image": image, "counts": counts}
    if isinstance(frames["auto"]["renderer"].tracer_tables, quad_kernel.QuadTables):
        check(frames["auto"]["renderer"].tracer_tables.nodes.shape[0]
              == dctx["quads"][leaf].nodes.shape[0], "auto's quad tree is not the policy's")
    rays = frames["packet"]["renderer"].primary.rays
    check(all(torch.equal(a, b) for a, b in zip(rays, frames["auto"]["renderer"].primary.rays)),
          "the two renderers' primary rays differ")
    phase("dragon primary frames done", t0)

    # 17. The AO frame, 8 samples, through Renderer("packet").
    radius = suite_ao_radius(DRAGON, scene)
    ao = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type="ao", num_samples=AO_SAMPLES, ao_radius=radius, max_batch=AO_MAX_BATCH,
        cache_dir=CACHE, device=DEVICE, tracer="packet"))
    ao.set_scene(scene)
    stats, ao_image, ao_counts, wall = render(ao, camera, flat_k, idle=quad_k)
    frame_line(f"{DRAGON} AO frame (radius {radius:.4f}), tracer='packet'", ao, stats, ao_counts,
               wall)
    lay = layout_key(ao.tracer_tables)
    check(ao_counts == {"closest" + lay: 1, "any" + lay: stats["batches"]},
          f"dragon AO frame launched {ao_counts}")
    check_image(ao_image, "dragon AO")
    live = sum(int((b.rays.tmax >= 0).sum()) for b in ao._batches)
    occluded = sum(int(((b.rays.tmax >= 0) & (b.hits.tri >= 0)).sum()) for b in ao._batches)
    check(bits_differ(ao.primary.hits.t, frames["packet"]["renderer"].primary.hits.t) == 0,
          "AO primary pre-trace differs from the primary frame")
    print(f"dragon AO: live AO rays {live}, occluded {occluded} ({occluded / max(live, 1):.4f})")
    phase("dragon AO frame done", t0)

    # 18a. The default routes' tables, then tpu_rt's forced large-scene
    # forms (FULLFRAME_TARGETS) and the other layouts through
    # make_routing_tracer, on the same primary rays and AO batches.
    defaults = {"auto (default)": "auto", "packet (default)": "packet"}
    configs = [
        ("auto (default)", frames["auto"]["renderer"].routing,
         frames["auto"]["renderer"].tracer_tables, want_auto),
        ("packet (default)", frames["packet"]["renderer"].routing,
         frames["packet"]["renderer"].tracer_tables, want_packet),
    ]
    forced = (("packet at 12 MiB", "packet", {"budget_bytes": VMEM_TABLE_BUDGET},
               "flat-cuda-mixed-bf16"),
              ("auto at 12 MiB", "auto", {"budget_bytes": VMEM_TABLE_BUDGET}, "quad-cuda-mixed"),
              ("packet hbm f32", "packet", {"residency": "hbm", "bf16_nodes": False},
               "flat-cuda-hbm"),
              ("packet vmem bf16", "packet", {"residency": "vmem", "bf16_nodes": True},
               "flat-cuda-bf16"),
              ("packet hbm bf16", "packet", {"residency": "hbm", "bf16_nodes": True},
               "flat-cuda-hbm-bf16"),
              ("packet mixed f32", "packet", {"residency": "mixed", "bf16_nodes": False},
               "flat-cuda-mixed"),
              ("packet4 hbm", "packet4", {"residency": "hbm"}, "quad-cuda-hbm"),
              ("packet4 mixed", "packet4", {"residency": "mixed"}, "quad-cuda-mixed"))
    for label, prefer, kw, want in forced:
        fn, kind, tables = make_routing_tracer(flat, prefer=prefer, device=dev, cache_dir=CACHE,
                                               **kw)
        check(kind == want, f"{label}: kind {kind}, want {want}")
        configs.append((label, fn, tables, kind))
    for label, _, tables, kind in configs:
        if tables.residency == "mixed":
            kern = kernel_of(tables, quad_k, flat_k)
            table_b = tables.nodes.numel() * tables.nodes.element_size()
            window, set_aside = kern.l2_window(table_b, dev)
            print(f"{label} ({kind}): L2 window {window} B over a node table of {table_b} B "
                  f"(clipped: {window < table_b}), persisting set-aside {set_aside} B, hitRatio "
                  f"{min(1.0, set_aside / window):.4f}")
    # Each forced form is a path of its own: the primary frame's rays
    # (closest hit) and every AO batch (any hit), launch counts set to 0
    # just before and read just after.  The default routes' primary frames
    # were counted in phase 16; here they trace the AO batches.
    got, runs = {}, {}
    for label, fn, tables, kind in configs:
        kern = kernel_of(tables, quad_k, flat_k)
        for k in (quad_k, flat_k):
            k.reset_counts()
        closest = fn(tables, rays) if label not in defaults else None
        anyhit = [fn(tables, b.rays, any_hit=True) for b in ao._batches]
        torch.cuda.synchronize()
        release_persisting_l2()
        got[label] = (closest, anyhit)
        runs[label] = {k: v for k, v in kern.launches_by_form.items() if v}
        lay_c = layout_key(tables)
        want = {"any" + lay_c: len(ao._batches), **({} if closest is None
                                                    else {"closest" + lay_c: 1})}
        print(f"{label} ({kind}): launches {runs[label]}")
        check(runs[label] == want and (quad_k if kern is flat_k else flat_k).launches == 0,
              f"{label}: launched {runs[label]}, want {want}")
    phase("dragon forced forms traced", t0)

    # 18b. Every form against its plain version: the frame form (closest,
    # primary) and the uv and stats forms on every ray; the any-hit form on
    # every ray of AO batch 1; t across forms and trees; hit / miss against
    # the AO frame's own.
    b1 = ao._batches[0]
    plains, err = {}, {}
    ref = None
    for label, fn, tables, kind in configs:
        tree = tree_of(tables)
        kern = kernel_of(tables, quad_k, flat_k)
        plain = (flat_kernel.trace_flat_plain if kern is flat_k else quad_kernel.trace_quad_plain)
        if tree not in plains:
            t1 = time.perf_counter()
            seen = {"closest": {}, "any": {}}
            plains[tree] = {"closest": plain(tables, rays, False, True, True,
                                             visited=seen["closest"]),
                            "any": plain(tables, b1.rays, True, True, True, visited=seen["any"]),
                            "tables": tables, "plain": plain, "seen": seen}
            torch.cuda.synchronize()
            print(f"plain {tree}: closest on {rays.num} + any on {b1.rays.num} rays in "
                  f"{time.perf_counter() - t1:.1f} s")
        want, want_cnt = plains[tree]["closest"]
        if ref is None:
            ref = want
        closest = got[label][0] if got[label][0] is not None else (
            frames[defaults[label]]["renderer"].primary.hits)
        uv = kern(tables, rays, False, True, False)
        hits_s, cnt = kern(tables, rays, False, False, True)
        anyb1 = got[label][1][0]
        want_a, _ = plains[tree]["any"]
        torch.cuda.synchronize()
        release_persisting_l2()
        bad = {"tri": int((closest.tri != want.tri).sum()), "t": bits_differ(closest.t, want.t),
               "uv_tri": int((uv.tri != want.tri).sum()), "u": bits_differ(uv.u, want.u),
               "v": bits_differ(uv.v, want.v), "stats_t": bits_differ(hits_s.t, want.t),
               "node_tests": int((cnt["node_tests"] != want_cnt["node_tests"]).sum()),
               "tri_tests": int((cnt["tri_tests"] != want_cnt["tri_tests"]).sum()),
               "any_tri": int((anyb1.tri != want_a.tri).sum()),
               "any_t": bits_differ(anyb1.t, want_a.t),
               "t_vs_binary_f32": bits_differ(closest.t, ref.t),
               "hit_miss_vs_ao_frame": sum(int(((a.tri >= 0) != (b.hits.tri >= 0)).sum())
                                           for a, b in zip(got[label][1], ao._batches))}
        err[label] = max(float((closest.t - want.t).abs().max()),
                         float((anyb1.t - want_a.t).abs().max()))
        print(f"{label} ({kind}, {tree}): vs plain on {rays.num} primary + {b1.rays.num} AO rays: "
              f"mismatches {bad}")
        check(not any(bad.values()), f"{label}: differs from its plain version or the f32 t")
    phase("dragon forms == plain on every ray", t0)

    # 18c. The oracles on 8,192 strided primary rays and on 8,192 rays of
    # AO batch 1: t bit-equal for every form; tri equal for the binary f32
    # forms, and at worst an exact-t tie for bf16 and quad forms; any hit:
    # hit / miss equal, and the binary f32 forms' occluder the oracle's.
    idx = strided(rays.num, dev)
    sub = subset(rays, idx)
    sub_np = [x.cpu().numpy() for x in sub]
    t1 = time.perf_counter()
    s_id, s_t, _, _ = trace_flat_scalar(flat, *sub_np)
    a_idx = strided(b1.rays.num, dev)
    a_sub_np = [x.cpu().numpy() for x in subset(b1.rays, a_idx)]
    a_id, _, _, _ = trace_flat_scalar(flat, *a_sub_np, any_hit=True)
    print(f"trace_flat_scalar on {len(s_id)} primary + {len(a_id)} AO rays: "
          f"{time.perf_counter() - t1:.1f} s on the host; primary hit fraction "
          f"{float(np.mean(s_id >= 0)):.4f}, AO occluded {float(np.mean(a_id >= 0)):.4f}")
    ties = {}
    q_oracles = {}
    for label, fn, tables, kind in configs:
        closest = got[label][0] if got[label][0] is not None else (
            frames[defaults[label]]["renderer"].primary.hits)
        k_tri, k_t = closest.tri[idx].cpu().numpy(), closest.t[idx].cpu().numpy()
        ties[label] = adjudicate(flat, sub_np, k_tri, k_t, s_id, s_t, f"{label} ({kind})")
        a_tri = got[label][1][0].tri[a_idx].cpu().numpy()
        hm_bad = int(((a_tri >= 0) != (a_id >= 0)).sum())
        occ_bad = int((a_tri != a_id).sum()) if tree_of(tables) == "binary f32" else 0
        print(f"{label} ({kind}) any hit vs trace_flat_scalar(any_hit=True) on {len(a_id)} rays: "
              f"hit / miss mismatches {hm_bad}, occluder mismatches (binary f32 forms) {occ_bad}")
        check(hm_bad == 0 and occ_bad == 0, f"{label}: any hit differs from the oracle")
        if isinstance(tables, quad_kernel.QuadTables):
            # The quad forms against the quad oracle on their own tree:
            # tri and t bit-equal.
            n_q = tables.nodes.shape[0]
            if n_q not in q_oracles:
                q = next(q for q in dctx["quads"].values() if q.nodes.shape[0] == n_q)
                t1 = time.perf_counter()
                q_oracles[n_q] = trace_quad_scalar(q, *sub_np)
                print(f"trace_quad_scalar (quad {n_q} nodes) on {len(s_id)} rays: "
                      f"{time.perf_counter() - t1:.1f} s on the host")
            qs = q_oracles[n_q]
            q_bad = int((k_tri != qs[0]).sum()) + np_bits_differ(k_t, qs[1])
            print(f"{label} ({kind}) vs trace_quad_scalar on its tree: mismatches {q_bad}")
            check(q_bad == 0, f"{label}: differs from trace_quad_scalar")
    phase("dragon forms == oracles", t0)
    return {"rays": rays, "ao": ao, "b1": b1, "configs": configs, "plains": plains, "err": err,
            "runs": runs, "frames": frames, "ties": ties, "live": live, "occluded": occluded}


def dragon_timing(t0, quad_k, flat_k, dctx, fctx):
    """Phase 19: kernel times of every dragon form (closest hit on the
    primary frame, any hit on AO batch 1), its plain version's, and the
    census: node and triangle tests per ray and warp efficiency.  The forms
    are timed in two passes, the second in reverse order, and the
    persisting L2 is released after each form, so that no form runs in
    another's set-aside; a form's time is the median over both passes."""
    from tpu_rt_torch.trace import release_persisting_l2

    rays, b1 = fctx["rays"], fctx["b1"]
    b1_live = int((b1.rays.tmax >= 0).sum())
    configs = fctx["configs"]
    samples = {label: ([], []) for label, *_ in configs}
    passes = {}
    for n_pass, seq in enumerate((configs, configs[::-1]), 1):
        for label, fn, tables, kind in seq:
            k_c = time_ms(lambda: fn(tables, rays), WARMUP, REPEATS)
            k_a = time_ms(lambda: fn(tables, b1.rays, any_hit=True), WARMUP, REPEATS)
            release_persisting_l2()
            timing_line(f"dragon pass {n_pass} {label} ({kind}) closest hit, primary", k_c, rays)
            timing_line(f"dragon pass {n_pass} {label} ({kind}) any hit, AO batch 1", k_a,
                        b1.rays, b1_live)
            samples[label][0].extend(k_c)
            samples[label][1].extend(k_a)
            passes[(label, n_pass)] = (median(k_c), median(k_a))
    times = {label: (median(c), median(a)) for label, (c, a) in samples.items()}
    for label, _, _, kind in configs:
        print(f"dragon A/B {label} ({kind}): primary ms pass 1 {passes[(label, 1)][0]:.4f} pass 2 "
              f"{passes[(label, 2)][0]:.4f}; AO batch 1 ms pass 1 {passes[(label, 1)][1]:.4f} "
              f"pass 2 {passes[(label, 2)][1]:.4f}")
    plain_ms = {}
    for tree, p in fctx["plains"].items():
        p_c = time_ms(lambda: p["plain"](p["tables"], rays), PLAIN_WARMUP, PLAIN_REPEATS)
        p_a = time_ms(lambda: p["plain"](p["tables"], b1.rays, any_hit=True), PLAIN_WARMUP,
                      PLAIN_REPEATS)
        timing_line(f"dragon plain {tree} closest hit, primary", p_c, rays)
        timing_line(f"dragon plain {tree} any hit, AO batch 1", p_a, b1.rays, b1_live)
        plain_ms[tree] = (median(p_c), median(p_a))
    for tree, p in fctx["plains"].items():
        parts = []
        for what, (_, cnt) in (("primary", p["closest"]), ("AO batch 1", p["any"])):
            nt, tt = cnt["node_tests"], cnt["tri_tests"]
            parts.append(f"{what}: node_tests/ray {float(nt.float().mean()):.3f}, tri_tests/ray "
                         f"{float(tt.float().mean()):.3f}, warp efficiency "
                         f"{warp_efficiency(nt + tt):.4f}")
        print(f"census, dragon, {tree}: " + "; ".join(parts))
    phase("dragon timed", t0)
    return times, plain_ms


def dragon_entries(quad_k, flat_k, fctx, times, plain_ms):
    """The kernels-line entries of the forms this slice added: each layout's
    closest-hit and any-hit frame forms, timed on the dragon primary frame
    and AO batch 1, with the launches of the first path that ran the form
    (its own run, counts set to 0 just before it)."""
    entries, seen = [], set()
    rays, b1 = fctx["rays"], fctx["b1"]
    for label, fn, tables, kind in fctx["configs"]:
        lay = layout_key(tables)
        if not lay:
            continue    # vmem f32: the earlier slices' forms, listed with their scenes
        kern = kernel_of(tables, quad_k, flat_k)
        tree = tree_of(tables)
        boxes = 2 if kern is flat_k else 4
        for any_hit in (False, True):
            form = ("any" if any_hit else "closest") + lay
            # One entry per form: the first config of that form gives its
            # path, launches and times.
            name = f"{kern.name}{'_anyhit' if any_hit else ''}{lay}"
            if name in seen:
                continue
            seen.add(name)
            r = b1.rays if any_hit else rays
            which = "any" if any_hit else "closest"
            _, cnt = fctx["plains"][tree][which]
            entries.append({
                "name": name, "route": "cuda", "source": f"tpu_rt_torch/csrc/{kern.name}.cu",
                "replaces": replaces(kern.name, tables.residency,
                                     getattr(tables, "bf16_nodes", False), any_hit),
                "path": f"{DRAGON} primary frame and AO batches, {label} ({kind})",
                "launches": fctx["runs"][label].get(form, 0),
                "max_abs_err": fctx["err"][label],
                "ms": times[label][1 if any_hit else 0],
                "plain_ms": plain_ms[tree][1 if any_hit else 0],
                **bound(name, tables, r, cnt, fctx["plains"][tree]["seen"][which], boxes),
                "library_ms": None,
            })
    return entries


# ---------------------------------------------------------------------------
# Phases 20-24: the triangle phase (postponed leaves, the tensor-core leaf
# test) and its ablation probe
# ---------------------------------------------------------------------------

LEAF_CURSORS = f"{PACKET2} (C > 1 leaf cursors :72-77, refill :572-587, drain :783-897"
MXU_UNIT = f"{PACKET2} (MXU triangle unit :792-862, ray matrix :978-993, U = MAX_LEAF :1110-1111"


def trace_kernels():
    from tpu_rt_torch.trace import flat_kernel, quad_kernel

    return (*quad_kernel.KERNELS, *flat_kernel.KERNELS)


def render_path(renderer, camera):
    """One frame through the user's entry points, every traversal library's
    launch counts set to 0 just before and read just after.  Returns
    (stats, image, {library: {form: launches}} (nonzero only), wall s)."""
    kernels = trace_kernels()
    for k in kernels:
        k.reset_counts()
    t0 = time.perf_counter()
    stats = renderer.render_frame(camera)
    image = renderer.update_result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: {f: v for f, v in k.launches_by_form.items() if v} for k in kernels}
    return stats, image, {k: v for k, v in counts.items() if v}, wall


def rays_equal(a, b) -> torch.Tensor:
    """Per ray: all of origin, dirn, tmin, tmax the same bits."""
    same = torch.ones(a.num, dtype=torch.bool, device=a.origin.device)
    for x, y in zip(a, b):
        eq = x.view(torch.int32) == y.view(torch.int32)
        same &= eq.all(1) if eq.dim() > 1 else eq
    return same


def triangle_paths(t0, bctx, fb, cctx, fc):
    """Phases 20-21: the triangle-phase options through the Renderer, each a
    path of its own: bunny primary with tracer="packet" and mxu=True, and
    with cursors=2; conference AO (8 samples, 2 batches) with "packet" and
    mxu=True, with cursors=3, and "packet4" with cursors=2.  Each frame
    against the same kernel's first-versions frame of phases 2-11: t
    bit-equal for postponed leaves (tri at exact-t ties only), the AO
    samples' hit / miss equal on every ray both frames share; the MXU form
    the same but for rays that graze an edge."""
    from tpu_rt_torch.renderer import Renderer, RendererParams

    paths = {}
    for label, kw, lib, kind in (("packet, mxu=True", {"mxu": True}, "flat_trace_mxu",
                                  "flat-cuda-mxu"),
                                 ("packet, cursors=2", {"cursors": 2}, "flat_trace_c",
                                  "flat-cuda-c2")):
        r = Renderer(WIDTH, HEIGHT, RendererParams(cache_dir=CACHE, device=DEVICE, tracer="packet",
                                                   **kw))
        r.set_scene(bctx["scene"])
        stats, image, counts, wall = render_path(r, bctx["camera"])
        frame_line(f"{SCENE} primary frame, {label}", r, stats, counts, wall)
        form = "closest" + ("_mxu" if "mxu" in kw else "_c")
        check(stats["tracer"] == kind, f"{label}: tracer {stats['tracer']}, want {kind}")
        check(counts == {lib: {form: 1}}, f"{label}: the primary path launched {counts}")
        check_image(image, f"{SCENE} primary, {label}")
        base, hits = fb["renderer"].primary.hits, r.primary.hits
        t_bad = bits_differ(hits.t, base.t)
        tri_bad = int((hits.tri != base.tri).sum())
        print(f"{label} vs the binary kernel's frame (phase 10): t bit mismatches {t_bad}, tri "
              f"mismatches {tri_bad} of {hits.t.numel()}")
        if "cursors" in kw:
            check(t_bad == 0, f"{label}: t differs from the first versions' frame")
        else:
            check(tri_bad <= 1e-3 * hits.t.numel(), f"{label}: tri differs on {tri_bad} rays")
        paths[(SCENE, label)] = {"renderer": r, "counts": counts}
    phase("bunny triangle-phase frames done", t0)

    for label, prefer, kw, lib, kind in (
            ("packet, mxu=True", "packet", {"mxu": True}, "flat_trace_mxu", "flat-cuda-mxu"),
            ("packet, cursors=3", "packet", {"cursors": 3}, "flat_trace_c", "flat-cuda-c3"),
            ("packet4, cursors=2", "packet4", {"cursors": 2}, "quad_trace_c", "quad-cuda-c2")):
        ao = Renderer(WIDTH, HEIGHT, RendererParams(
            ray_type="ao", num_samples=AO_SAMPLES, ao_radius=cctx["radius"],
            max_batch=AO_MAX_BATCH, cache_dir=CACHE, device=DEVICE, tracer=prefer, **kw))
        ao.set_scene(cctx["scene"])
        stats, image, counts, wall = render_path(ao, cctx["camera"])
        frame_line(f"{SECONDARY_SCENE} AO frame, {label}", ao, stats, counts, wall)
        suffix = "_mxu" if "mxu" in kw else "_c"
        want = {lib: {"closest" + suffix: 1, "any" + suffix: stats["batches"]}}
        check(stats["tracer"] == kind, f"{label}: tracer {stats['tracer']}, want {kind}")
        check(counts == want, f"{label}: the AO path launched {counts}, want {want}")
        check_image(image, f"{SECONDARY_SCENE} AO, {label}")
        base = fc["ao"] if prefer == "packet" else cctx["ao"]
        p_t_bad = bits_differ(ao.primary.hits.t, base.primary.hits.t)
        p_tri_bad = int((ao.primary.hits.tri != base.primary.hits.tri).sum())
        shared = hm_bad = 0
        for b, bb in zip(ao._batches, base._batches):
            same = rays_equal(b.rays, bb.rays)
            shared += int(same.sum())
            hm_bad += int((((b.hits.tri >= 0) != (bb.hits.tri >= 0)) & same).sum())
        print(f"{label} AO vs the first versions' frame: primary t bit mismatches {p_t_bad}, tri "
              f"mismatches {p_tri_bad}; hit / miss mismatches {hm_bad} on the {shared} of "
              f"{ao.rays_traced} AO rays both frames share")
        if "cursors" in kw:
            check(p_t_bad == 0 and hm_bad == 0, f"{label}: AO frame differs from the first "
                  "versions'")
        else:
            check(hm_bad <= 1e-3 * shared, f"{label}: AO hit / miss differs on {hm_bad} rays")
        paths[(SECONDARY_SCENE, label)] = {"renderer": ao, "counts": counts}
    phase("conference triangle-phase AO frames done", t0)
    return paths


def agree_mxu(got_tri, got_t, s_id, s_t, what):
    """test_pallas.py's rule for the MXU unit against the oracle: more than
    0.999 of the ids equal, t to rtol 1e-4, atol 1e-5 where they agree on
    a hit."""
    agree = got_tri == s_id
    hit = agree & (s_id >= 0)
    dt = np.abs(got_t[hit] - s_t[hit])
    bad_t = int((dt > 1e-5 + 1e-4 * np.abs(s_t[hit])).sum())
    print(f"{what}: vs trace_flat_scalar on {len(s_id)} rays: id agreement "
          f"{float(agree.mean()):.6f} ({int((~agree).sum())} disputed), t outside rtol 1e-4 / "
          f"atol 1e-5 {bad_t}, max |dt| {float(dt.max()) if dt.size else 0.0}")
    check(agree.mean() > 0.999 and bad_t == 0, f"{what}: differs from the oracle")


def triangle_checks(t0, bctx, fb, cctx, fc, dev):
    """Phase 22: every form of the triangle-phase libraries (frame, uv and
    stats; closest hit on the bunny primary frame's rays, any hit on
    conference AO batch 1) against its plain version on every ray: tri, t,
    u, v and the counters bit for bit; then against the oracles on their
    8,192-ray subsets, and the census.  Postponed leaves (flat_trace_c at 2
    cursors on bunny, 3 on AO; quad_trace_c at 2): t bit-equal to the first
    versions' and the oracle's (tri disputes only at exact-t ties).  The
    tensor-core form (flat_trace_mxu) at 1-4 cursors on the Renderer's vmem
    f32 tables, and at 2 and 3 on bf16 hbm and f32 mixed tables: against
    the oracle test_pallas.py's rule."""
    from tpu_rt_torch.trace import (
        flat_kernel,
        make_routing_tracer,
        quad_kernel,
        release_persisting_l2,
    )

    bunny, conf = f"{SCENE} primary", f"{SECONDARY_SCENE} AO batch 1"
    ray_sets = {("flat", bunny): (fb["renderer"].primary.rays, fb["renderer"].flat, bctx["idx"]),
                ("flat", conf): (fc["ao"]._batches[0].rays, fc["ao"].flat, cctx["b1_idx"]),
                ("quad", bunny): (bctx["renderer"].primary.rays, fb["renderer"].flat, bctx["idx"]),
                ("quad", conf): (cctx["ao"]._batches[0].rays, fc["ao"].flat, cctx["b1_idx"])}
    first = {("flat", bunny): fb["plain"][0], ("flat", conf): fc["plain"][0],
             ("quad", bunny): bctx["plain"][0], ("quad", conf): cctx["b1_plain"][0]}
    oracles = {("flat", bunny): fb["oracle"], ("flat", conf): fc["oracle"],
               ("quad", bunny): fb["oracle"], ("quad", conf): cctx["b1_oracle"]}
    # (name, wrapper, tree, route, options on bunny, on AO, table layout)
    mxu_k = flat_kernel.KERNEL_MXU
    families = (
        ("flat_trace_mxu", mxu_k, "flat", "packet", {"mxu": True}, {"mxu": True}, {}),
        *((f"flat_trace_mxu C={c}", mxu_k, "flat", "packet", {"mxu": True, "cursors": c},
           {"mxu": True, "cursors": c}, {}) for c in (2, 3, 4)),
        ("flat_trace_mxu C=2 @hbm-bf16", mxu_k, "flat", "packet", {"mxu": True, "cursors": 2},
         {"mxu": True, "cursors": 2}, {"residency": "hbm", "bf16_nodes": True}),
        ("flat_trace_mxu C=3 @mixed", mxu_k, "flat", "packet", {"mxu": True, "cursors": 3},
         {"mxu": True, "cursors": 3}, {"residency": "mixed", "bf16_nodes": False}),
        ("flat_trace_c", flat_kernel.KERNEL_C, "flat", "packet", {"cursors": 2}, {"cursors": 3},
         {}),
        ("quad_trace_c", quad_kernel.KERNEL_C, "quad", "packet4", {"cursors": 2},
         {"cursors": 2}, {}),
    )
    out = {}
    for name, kern, tree, prefer, kw_b, kw_a, layout in families:
        plain_fn = (flat_kernel.trace_flat_plain if tree == "flat"
                    else quad_kernel.trace_quad_plain)
        for label, any_hit, kw in ((bunny, False, kw_b), (conf, True, kw_a)):
            rays, flat, idx = ray_sets[(tree, label)]
            cursors = kw.get("cursors", 1)
            mxu = kw.get("mxu", False)
            fn, kind, tables = make_routing_tracer(flat, prefer, dev, cache_dir=CACHE, **kw,
                                                   **layout)
            plain = partial(plain_fn, **kw)
            seen = {}
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want, want_cnt = plain(tables, rays, any_hit, True, True, visited=seen)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            frame = fn(tables, rays, any_hit=any_hit)
            uv = kern(tables, rays, any_hit, True, False, cursors)
            hits_s, cnt = kern(tables, rays, any_hit, False, True, cursors)
            torch.cuda.synchronize()
            if tables.residency == "mixed":
                release_persisting_l2()
            bad = {"tri": sum(int((h.tri != want.tri).sum()) for h in (frame, uv, hits_s))}
            bad.update({f: bits_differ(getattr(uv, f), getattr(want, f)) for f in "tuv"})
            bad["t_frame"] = bits_differ(frame.t, want.t)
            bad["t_stats"] = bits_differ(hits_s.t, want.t)
            bad.update({k: int((cnt[k] != want_cnt[k]).sum()) for k in cnt})
            if not mxu:
                # Against the first versions (cursors = 1): closest hit t
                # bit-equal; any hit, hit / miss.
                base = first[(tree, label)]
                bad["vs_first"] = (int(((frame.tri >= 0) != (base.tri >= 0)).sum()) if any_hit
                                   else bits_differ(frame.t, base.t))
            print(f"{name} ({kind}) {label}, any_hit={any_hit}: vs plain"
                  f"{'' if mxu else ' (and the first versions)'} on {rays.num} rays: "
                  f"mismatches {bad}")
            check(not any(bad.values()), f"{name} {label}: differs from its plain version")
            # The oracles on the subset.
            s = oracles[(tree, label)]
            k_tri, k_t = frame.tri[idx].cpu().numpy(), frame.t[idx].cpu().numpy()
            if any_hit:
                hm = (k_tri >= 0) == (s[0] >= 0)
                print(f"{name} {label}: any hit vs the oracle on {len(k_tri)} rays: hit / miss "
                      f"mismatches {int((~hm).sum())}")
                check(hm.all() if not mxu else hm.mean() > 0.999,
                      f"{name} {label}: any hit differs from the oracle")
            elif mxu:
                agree_mxu(k_tri, k_t, s[0], s[1], f"{name} {label}")
            else:
                adjudicate(flat, [x.cpu().numpy() for x in subset(rays, idx)], k_tri, k_t, s[0],
                           s[1], f"{name} {label}")
            err = float((frame.t - want.t).abs().max())
            out[(name, label)] = {"err": err, "plain_ms": plain_ms, "counts": want_cnt,
                                  "seen": seen, "tables": tables, "rays": rays, "kind": kind}
    phase("triangle-phase forms == plain, first versions, oracles", t0)

    # The census: node and triangle tests per ray and warp efficiency, at
    # 1, 2 and 3 cursors and with the tensor-core leaf test (the plain
    # versions' counters, which the stats forms equal).
    census = {}
    for tree, label in (("flat", bunny), ("flat", conf), ("quad", bunny), ("quad", conf)):
        rays = ray_sets[(tree, label)][0]
        any_hit = label == conf
        runs = {"1": {("flat", bunny): fb["plain"][1], ("flat", conf): fc["plain"][1],
                      ("quad", bunny): bctx["plain"][1],
                      ("quad", conf): cctx["b1_plain"][1]}[(tree, label)]}
        if tree == "flat":
            tables = out[("flat_trace_c", label)]["tables"]
            for c in (2, 3):
                key = (("flat_trace_c", label) if c == (2 if label == bunny else 3) else None)
                runs[str(c)] = (out[key]["counts"] if key else flat_kernel.trace_flat_plain(
                    tables, rays, any_hit, False, True, cursors=c)[1])
            runs["mxu"] = out[("flat_trace_mxu", label)]["counts"]
        else:
            runs["2"] = out[("quad_trace_c", label)]["counts"]
        parts = []
        for c, cnt in runs.items():
            nt, tt = cnt["node_tests"], cnt["tri_tests"]
            census[(tree, label, c)] = (float(nt.float().mean()), float(tt.float().mean()),
                                        warp_efficiency(nt + tt))
            parts.append(f"{'mxu' if c == 'mxu' else 'C=' + c}: node_tests/ray "
                         f"{census[(tree, label, c)][0]:.3f}, tri_tests/ray "
                         f"{census[(tree, label, c)][1]:.3f}, warp efficiency "
                         f"{census[(tree, label, c)][2]:.4f}")
        print(f"census, {label}, {tree}: " + "; ".join(parts))
    phase("triangle-phase census", t0)
    return out


def triangle_timing(t0, bctx, fb, cctx, fc):
    """Phase 23: kernel times of the first versions' forms and of the new
    ones on the same rays (closest hit on the bunny primary frame, any hit
    on conference AO batch 1), in two passes, the second in reverse order;
    a form's time is the median over both."""
    from tpu_rt_torch.trace import trace_flat, trace_quad

    f_tab = {False: fb["renderer"].tracer_tables, True: fc["ao"].tracer_tables}
    q_tab = {False: bctx["renderer"].tracer_tables, True: cctx["ao"].tracer_tables}
    f_rays = {False: fb["renderer"].primary.rays, True: fc["ao"]._batches[0].rays}
    q_rays = {False: bctx["renderer"].primary.rays, True: cctx["ao"]._batches[0].rays}
    forms = [("binary C=1", trace_flat, f_tab, f_rays, {}),
             ("binary C=2", trace_flat, f_tab, f_rays, {"cursors": 2}),
             ("binary C=3", trace_flat, f_tab, f_rays, {"cursors": 3}),
             ("binary mxu", trace_flat, f_tab, f_rays, {"mxu": True}),
             ("binary mxu C=2", trace_flat, f_tab, f_rays, {"mxu": True, "cursors": 2}),
             ("binary mxu C=3", trace_flat, f_tab, f_rays, {"mxu": True, "cursors": 3}),
             ("binary mxu C=4", trace_flat, f_tab, f_rays, {"mxu": True, "cursors": 4}),
             ("quad C=1", trace_quad, q_tab, q_rays, {}),
             ("quad C=2", trace_quad, q_tab, q_rays, {"cursors": 2})]
    samples = {(f[0], a): [] for f in forms for a in (False, True)}
    passes = {}
    for n_pass, seq in enumerate((forms, forms[::-1]), 1):
        for label, fn, tabs, rays, kw in seq:
            for a in (False, True):
                ms = time_ms(lambda: fn(tabs[a], rays[a], any_hit=a, **kw), WARMUP, REPEATS)
                samples[(label, a)].extend(ms)
                passes[(label, a, n_pass)] = median(ms)
    times = {k: median(v) for k, v in samples.items()}
    for label, *_ in forms:
        print(f"timing {label}: bunny primary closest ms pass 1 {passes[(label, False, 1)]:.4f} "
              f"pass 2 {passes[(label, False, 2)]:.4f} (median {times[(label, False)]:.4f}); AO "
              f"batch 1 any hit ms pass 1 {passes[(label, True, 1)]:.4f} pass 2 "
              f"{passes[(label, True, 2)]:.4f} (median {times[(label, True)]:.4f})")
    phase("triangle-phase forms timed", t0)
    return times


def probe_phase(t0, fb, bctx, dev):
    """Phase 24: the MXU ablation probe (python -m tpu_rt_torch.probes.
    mxu_ablate) on bunny's Woop rows, at 16,384 rays and at its own 262,144:
    ns per iteration of each variant, each checked against its plain
    version; the launch counts are those of the timed runs."""
    from tpu_rt_torch.probes import mxu_ablate

    # A launch of 128 blocks (one per SM, 4 warps each) first, then the
    # probe's own size (2,048 blocks, as many warps as the SMs hold); the
    # kernels line takes the second.
    for n_rays, hi, lo in ((1 << 14, 400, 100), (None, None, None)):
        res = mxu_ablate.run(fb["renderer"].flat, bctx["scene"], dev, n_rays, hi, lo)
        print(f"mxu_ablate: {res['n_rays']} rays, {res['n_rows']} Woop rows, trip counts "
              f"{res['niter']}, launches {res['launches']}")
        for variant, r in res["variants"].items():
            print(f"  {variant:6s} {r['ns_per_iter']:10.1f} ns/iter (hi {r['ms_hi']:.4f} ms, lo "
                  f"{r['ms_lo']:.4f} ms); vs plain on {r['check_rays']} rays x "
                  f"{r['check_iters']}: t bits differ {r['t_bits_differ']}, max rel err "
                  f"{r['max_rel_err']:.3g}, tri sums differ {r['tri_differ']}")
        print(f"  plain full: {res['variants']['full']['plain_ns_per_iter']:.1f} ns/iter")
        bad = mxu_ablate.check(res)
        check(not bad, f"mxu_ablate variants differ from their plain versions: {bad}")
        check(all(v > 0 for v in res["launches"].values()), f"mxu_ablate launches "
              f"{res['launches']}")
    phase("mxu_ablate probe done", t0)
    return res


def probe_bound(res) -> dict:
    """The least time of one iteration of the probe's ``full`` variant: its
    DMMA (24 per warp, 512 f64 operations each) at the FP64 tensor rate plus
    its f32 epilogue, against the Woop rows one iteration reads (the warps'
    8-row windows, a contiguous run of warps + 7 rows) and the accumulators
    over the memory rate."""
    warps = res["n_rays"] // 32
    dots = warps * 24 * 512
    epi = res["n_rays"] * 8 * MXU_EPI_OPS
    t_ops = dots / PEAK_F64_TENSOR_FLOPS * 1e3 + epi / PEAK_F32_FLOPS * 1e3
    nbytes = (warps + 7) * 64
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"bound mxu_ablate (per iteration): {dots} f64 tensor + {epi} f32 operations -> "
          f"{t_ops:.6f} ms; {nbytes} B -> {t_bytes:.6f} ms")
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def triangle_entries(paths, checks, times, probe):
    """The kernels-line entries of this slice: the frame forms of the three
    new libraries (closest hit timed on the bunny primary frame, any hit on
    conference AO batch 1), with the launches of their Renderer paths, and
    the probe (times per iteration)."""
    bunny, conf = f"{SCENE} primary", f"{SECONDARY_SCENE} AO batch 1"
    rows = (
        ("flat_trace_mxu", "closest_mxu", (SCENE, "packet, mxu=True"), "binary mxu",
         f"{MXU_UNIT}, via trace_packet2(mxu=True) :1052-1114)", False),
        ("flat_trace_mxu", "any_mxu", (SECONDARY_SCENE, "packet, mxu=True"), "binary mxu",
         f"{MXU_UNIT}, any_hit=True :845-849)", True),
        ("flat_trace_c", "closest_c", (SCENE, "packet, cursors=2"), "binary C=2",
         f"{LEAF_CURSORS}, binary node unit :704-770)", False),
        ("flat_trace_c", "any_c", (SECONDARY_SCENE, "packet, cursors=3"), "binary C=3",
         f"{LEAF_CURSORS}, binary node unit, any_hit=True :552-567)", True),
        ("quad_trace_c", "closest_c", (SECONDARY_SCENE, "packet4, cursors=2"), "quad C=2",
         f"{LEAF_CURSORS}, 4-wide node unit :618-679, trace_packet4 c= :1188)", False),
        ("quad_trace_c", "any_c", (SECONDARY_SCENE, "packet4, cursors=2"), "quad C=2",
         f"{LEAF_CURSORS}, 4-wide node unit, any_hit=True :552-567)", True))
    entries = []
    for lib, form, path, timed, replaces_, any_hit in rows:
        c = checks[(lib, conf if any_hit else bunny)]
        p = paths[path]
        what = f"{path[0]} {'AO' if path[0] == SECONDARY_SCENE else 'primary'} frame"
        entries.append({
            "name": lib + ("_anyhit" if any_hit else ""), "route": "cuda",
            "source": f"tpu_rt_torch/csrc/{lib}.cu", "replaces": replaces_,
            "path": f"{what}, Renderer(tracer={path[1].split(',')[0]!r},{path[1].split(',')[1]})",
            "launches": p["counts"].get(lib, {}).get(form, 0),
            "timed_on": f"{conf if any_hit else bunny} ({c['rays'].num} rays), {c['kind']}",
            "max_abs_err": c["err"], "ms": times[(timed, any_hit)], "plain_ms": c["plain_ms"],
            **bound(lib + ("_anyhit" if any_hit else ""), c["tables"], c["rays"], c["counts"],
                    c["seen"], 2 if lib.startswith("flat") else 4, mxu=lib == "flat_trace_mxu"),
            "library_ms": None,
        })
    full = probe["variants"]["full"]
    entries.append({
        "name": "mxu_ablate", "route": "cuda", "source": "tpu_rt_torch/csrc/mxu_ablate.cu",
        "replaces": "tools/mxu_ablate.py:48 (make_kernel; timed :174)",
        "path": f"python -m tpu_rt_torch.probes.mxu_ablate (run), {SCENE} Woop rows",
        "launches": sum(probe["launches"].values()),
        "timed_on": f"variant full, {probe['n_rays']} rays, per iteration "
                    f"(t({probe['niter'][0]}) - t({probe['niter'][1]})) / "
                    f"{probe['niter'][0] - probe['niter'][1]}",
        "max_abs_err": max(r["max_abs_err"] for r in probe["variants"].values()),
        "ms": full["ns_per_iter"] / 1e6, "plain_ms": full["plain_ns_per_iter"] / 1e6,
        **probe_bound(probe), "library_ms": None,
        "ns_per_iter": {v: r["ns_per_iter"] for v, r in probe["variants"].items()},
    })
    return entries


# ---------------------------------------------------------------------------
# Phases 25-26: the traversal-step ablation and the row-cursor primitives
# ---------------------------------------------------------------------------

def ablate2_phase(t0, fb, bctx, dev):
    """Phase 25: the traversal-step ablation (python -m tpu_rt_torch.probes.
    ablate2) on bunny's node records and Woop rows, on a full card and at
    the tool's 8,192 rays: ns per iteration of each level, the output of
    each timed launch at N against its plain version on every ray; the
    kernels line takes the full card's run."""
    from tpu_rt_torch.probes import ablate2

    runs = []
    for n_rays in (ablate2.full_card(dev), None):
        res = ablate2.run(fb["renderer"].flat, bctx["scene"], dev, n_rays)
        print(f"ablate2: {res['n_rays']} rays ({res['n_rays'] // ablate2.GROUP} blocks), "
              f"K={res['k']} U={res['u']}, trip counts {res['niter']} and {5 * res['niter']}, "
              f"launches {res['launches']}")
        for level, r in res["levels"].items():
            print(f"  level {level}: {r['ns_per_iter']:10.1f} ns/iter (+{r['delta_ns']:9.1f}) "
                  f"{r['name']}; lo {r['ms_lo']:.4f} ms, hi {r['ms_hi']:.4f} ms; plain "
                  f"{r['plain_ns_per_iter']:.1f} ns/iter; vs plain on {r['check_rays']} rays x "
                  f"{r['check_iters']}: bits differ {r['bits_differ']}, nodes differ "
                  f"{r['node_differ']}")
        bad = ablate2.check(res)
        check(not bad, f"ablate2 levels differ from their plain versions: {bad}")
        check(all(v > 0 for v in res["launches"].values()), f"ablate2 launches {res['launches']}")
        runs.append(res)
    phase("ablate2 probe done", t0)
    return runs


def mosaic_phase(t0, dev):
    """Phase 26: the row-cursor primitives (python -m tpu_rt_torch.probes.
    mosaic_probe3) on a full card and on the tool's one packet: ns per
    iteration and per row step of each mode, the output of each timed
    launch at ITERS against its plain version on every packet (the kernels
    line takes the full card's run); then the gather and scatter-add rates
    of PyTorch indexing at the tool's sizes."""
    from tpu_rt_torch.probes import mosaic_probe3

    runs = []
    for packets in (mosaic_probe3.full_card(dev), 1):
        res = mosaic_probe3.run(dev, packets)
        print(f"mosaic_probe3: {packets} packets of {mosaic_probe3.R} rows, trip counts "
              f"{res['iters']} and {5 * res['iters']}, launches {res['launches']}")
        for mode, r in res["modes"].items():
            print(f"  {mode:14s} {r['ns_per_iter']:9.1f} ns/iter ({r['ns_per_row_step']:7.2f} "
                  f"ns/row-step); lo {r['ms_lo']:.4f} ms, hi {r['ms_hi']:.4f} ms; plain "
                  f"{r['plain_ns_per_iter']:.1f} ns/iter; vs plain on {r['check_packets']} "
                  f"packets x {r['check_iters']}: bits differ {r['bits_differ']}, nodes "
                  f"differ {r['nodes_differ']}")
        bad = mosaic_probe3.check(res)
        check(not bad, f"mosaic_probe3 modes differ from their plain versions: {bad}")
        check(all(v > 0 for v in res["launches"].values()),
              f"mosaic_probe3 launches {res['launches']}")
        runs.append(res)
    gather = mosaic_probe3.gather_rates(dev)
    phase("mosaic_probe3 probe and gather rates done", t0)
    return runs, gather


# ---------------------------------------------------------------------------
# Phase 27: the persistent kernels against their first versions
# ---------------------------------------------------------------------------

def design_ab(t0, quad_k, flat_k, bctx, fb, cctx, fc, fctx):
    """Phase 27: the four vmem f32 frame forms (quad and binary, closest and
    any hit) in their first version (one ray per thread) and persistent,
    on the same rays, in turns, in two passes, the second in reverse order:
    bunny primary, conference AO batch 1 (any hit), the conference diffuse
    batch, dragon primary and dragon AO batch 1 (binary f32, quad leaf 16);
    the two tensor-core frame forms on bunny primary and conference AO
    batch 1; then the stack placement A/B (local against shared memory) on
    bunny primary and conference AO batch 1.  Every design's hits equal the
    persistent kernel's (which phases 3-22 held to the plain versions on
    these rays), and each launch's shape is the one ``persistent_grid`` /
    ``shared_stack_bytes`` / ``MXU_SMEM`` give.  A time is the median over
    both passes.  Returns {(kernel, rays): ms by design, and the persistent
    launch's shape}."""
    from tpu_rt_torch.trace.common import BLOCK, CSRC, persistent_grid, shared_stack_bytes
    from tpu_rt_torch.trace.flat_kernel import KERNEL_MXU, MXU_SMEM

    dragon, d_b1 = fctx["frames"], fctx["b1"].rays
    b1_q, b1_f = cctx["ao"]._batches[0], fc["ao"]._batches[0]
    d_q, d_f = cctx["dif"]._batches[0], fc["dif"]._batches[0]
    d_live = int((d_b1.tmax >= 0).sum())
    # (rays label, kernel, tables, rays, any hit, rays counted for Mray/s)
    cases = [
        ("bunny primary", quad_k, bctx["renderer"].tracer_tables, bctx["renderer"].primary.rays,
         False, WIDTH * HEIGHT),
        ("bunny primary", flat_k, fb["renderer"].tracer_tables, fb["renderer"].primary.rays,
         False, WIDTH * HEIGHT),
        ("conference AO batch 1", quad_k, cctx["ao"].tracer_tables, b1_q.rays, True,
         cctx["b1_live"]),
        ("conference AO batch 1", flat_k, fc["ao"].tracer_tables, b1_f.rays, True,
         cctx["b1_live"]),
        ("conference diffuse", quad_k, cctx["dif"].tracer_tables, d_q.rays, False, cctx["hits"]),
        ("conference diffuse", flat_k, fc["dif"].tracer_tables, d_f.rays, False, cctx["hits"]),
        ("dragon primary", quad_k, dragon["auto"]["renderer"].tracer_tables,
         dragon["auto"]["renderer"].primary.rays, False, WIDTH * HEIGHT),
        ("dragon primary", flat_k, dragon["packet"]["renderer"].tracer_tables,
         dragon["packet"]["renderer"].primary.rays, False, WIDTH * HEIGHT),
        ("dragon AO batch 1", quad_k, dragon["auto"]["renderer"].tracer_tables, d_b1, True,
         d_live),
        ("dragon AO batch 1", flat_k, dragon["packet"]["renderer"].tracer_tables, d_b1, True,
         d_live),
        ("bunny primary", KERNEL_MXU, fb["renderer"].tracer_tables, fb["renderer"].primary.rays,
         False, WIDTH * HEIGHT),
        ("conference AO batch 1", KERNEL_MXU, fc["ao"].tracer_tables, b1_f.rays, True,
         cctx["b1_live"]),
    ]
    for label, kern, tables, *_ in cases:
        check(tables.residency == "vmem" and not getattr(tables, "bf16_nodes", False),
              f"{label} {kern.name}: the A/B takes the vmem f32 tables")
    stack_ab = {("bunny primary", "quad_trace"), ("bunny primary", "flat_trace"),
                ("conference AO batch 1", "quad_trace"), ("conference AO batch 1", "flat_trace")}
    runs = [(i, d) for i, (label, kern, *_) in enumerate(cases)
            for d in (("first", "persistent", "shared_stack") if (label, kern.name) in stack_ab
                      else ("first", "persistent"))]
    ref, shapes = {}, {}
    for i, (label, kern, tables, rays, any_hit, _) in enumerate(cases):
        ref[i] = kern(tables, rays, any_hit=any_hit)
    samples, passes = {}, {}
    for n_pass, seq in enumerate((runs, runs[::-1]), 1):
        for i, design in seq:
            label, kern, tables, rays, any_hit, _ = cases[i]
            checks, args, opts = kern.launch_args(tables)
            run = partial(kern.launch, checks, args, rays, any_hit, False, False, design=design,
                          **opts)
            got = run()
            shape = dict(kern.last_shape)
            ms = time_ms(run, WARMUP, REPEATS)
            samples.setdefault((i, design), []).extend(ms)
            passes[(i, design, n_pass)] = median(ms)
            if n_pass == 1:
                bad = int((got.tri != ref[i].tri).sum()) + bits_differ(got.t, ref[i].t)
                need = opts["stack_need"]
                mxu = kern is KERNEL_MXU
                if design == "first":
                    want = {"grid": -(-rays.num // BLOCK), "blocks_per_sm": 0,
                            "smem_bytes": MXU_SMEM["first"] if mxu else 0}
                else:
                    want = {"grid": persistent_grid(rays.num, shape["sms"],
                                                    shape["blocks_per_sm"]),
                            "smem_bytes": (MXU_SMEM[design] if mxu
                                           else shared_stack_bytes(need)
                                           if design == "shared_stack" else 0)}
                    if design == "persistent":
                        shapes[i] = shape
                print(f"design {label}, {kern.name} any_hit={any_hit} {design}: launch {shape} "
                      f"(stack need {need}); tri / t mismatches against the persistent kernel "
                      f"{bad}")
                check(bad == 0, f"{label} {kern.name} {design}: hits differ from the persistent "
                      "kernel's")
                check(all(shape[k] == v for k, v in want.items())
                      and (design == "first" or shape["blocks_per_sm"] >= 1),
                      f"{label} {kern.name} {design}: launch shape {shape}, want {want}")
    out = {}
    for i, (label, kern, tables, rays, any_hit, counted) in enumerate(cases):
        first, new = median(samples[(i, "first")]), median(samples[(i, "persistent")])
        out[(kern.name, label)] = {"first": first, "persistent": new, "shape": shapes[i]}
        print(f"A/B {label}, {kern.name} {'any' if any_hit else 'closest'} hit ({rays.num} rays, "
              f"{counted} counted): first {first:.4f} ms ({counted / (first * 1e3):.2f} Mray/s; "
              f"passes {passes[(i, 'first', 1)]:.4f}, {passes[(i, 'first', 2)]:.4f}), "
              f"persistent {new:.4f} ms ({counted / (new * 1e3):.2f} Mray/s; passes "
              f"{passes[(i, 'persistent', 1)]:.4f}, {passes[(i, 'persistent', 2)]:.4f}); new/old "
              f"{new / first:.4f}")
        if (label, kern.name) in stack_ab:
            sh = median(samples[(i, "shared_stack")])
            out[(kern.name, label)]["shared_stack"] = sh
            print(f"stack A/B {label}, {kern.name}: local memory (the persistent kernel) "
                  f"{new:.4f} ms, shared memory {sh:.4f} ms (passes "
                  f"{passes[(i, 'shared_stack', 1)]:.4f}, {passes[(i, 'shared_stack', 2)]:.4f}); "
                  f"shared/local {sh / new:.4f}")
    with open(os.path.join(CSRC, "trace_common.cuh")) as f:
        refill = re.search(r"constexpr int kRefill = (\d+);", f.read()).group(1)
    print(f"refill threshold: a warp refills below {refill} of 32 active lanes "
          "(trace_common.cuh kRefill)")
    phase("persistent kernels against their first versions", t0)
    return out


# The probes are built with -fmad=false, so each f32 operation they count
# is an instruction of its own: one per lane per clock, half of the 67
# TFLOP/s peak, which counts a fused multiply-add as two.
PEAK_F32_INSTR = PEAK_F32_FLOPS / 2


def step_bound(what: str, ops: int, nbytes: int) -> dict:
    """The least time of one probe iteration on a full card: its f32
    operations at the FP32 instruction rate against the table bytes it
    reads over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32_INSTR * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"bound {what} (per iteration): {ops} f32 instructions -> {t_ops:.9f} ms; {nbytes} B "
          f"-> {t_bytes:.9f} ms")
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def probe_entries(ab_runs, mp_runs):
    """The kernels-line entries of the two probes, from their runs on a
    full card (where the whole card's peaks apply).  ``ms`` and
    ``plain_ms`` are per iteration of the full step (ablate2 level 8,
    mosaic_probe3 rowstep); the bound counts its f32 operations
    (``STEP_OPS`` per ray or packet) against the rows it reads: ablate2's
    K records and K U Woop rows (every warp walks the same cursors),
    mosaic_probe3's 16 records per packet, at most the table once."""
    from tpu_rt_torch.probes import ablate2, mosaic_probe3

    ab, mp = ab_runs[0], mp_runs[0]
    full, row = ab["levels"][ablate2.FULL_LEVEL], mp["modes"][mosaic_probe3.FULL_MODE]
    ab_bound = step_bound("ablate2", ab["n_rays"] * ablate2.STEP_OPS,
                          ab["k"] * (1 + ab["u"]) * ablate2.ROW_BYTES)
    mp_bound = step_bound("mosaic_probe3", mp["packets"] * mosaic_probe3.STEP_OPS,
                          min(mosaic_probe3.R * mp["packets"], mosaic_probe3.TABLE_ROWS)
                          * mosaic_probe3.RECORD_BYTES)
    return [{
        "name": "ablate2", "route": "cuda", "source": "tpu_rt_torch/csrc/ablate2.cu",
        "replaces": "tools/ablate2.py:38 (make_kernel(level); timed :188)",
        "path": f"python -m tpu_rt_torch.probes.ablate2 (run), {SCENE} node records and Woop rows",
        "launches": sum(ab["launches"].values()),
        "timed_on": f"level {ablate2.FULL_LEVEL} (the full step), {ab['n_rays']} rays, per "
                    f"iteration (t({5 * ab['niter']}) - t({ab['niter']})) / {4 * ab['niter']}",
        "max_abs_err": max(r["max_abs_err"] for r in ab["levels"].values()),
        "ms": full["ns_per_iter"] / 1e6, "plain_ms": full["plain_ns_per_iter"] / 1e6,
        **ab_bound, "library_ms": None,
        "ns_per_iter": {str(lv): r["ns_per_iter"] for lv, r in ab["levels"].items()},
    }, {
        "name": "mosaic_probe3", "route": "cuda", "source": "tpu_rt_torch/csrc/mosaic_probe3.cu",
        "replaces": "tools/mosaic_probe3.py:37 (make_kernel(mode, iters); called :185)",
        "path": "python -m tpu_rt_torch.probes.mosaic_probe3 (run), the tool's random table",
        "launches": sum(mp["launches"].values()),
        "timed_on": f"mode {mosaic_probe3.FULL_MODE}, {mp['packets']} packet(s), per iteration "
                    f"(t({5 * mp['iters']}) - t({mp['iters']})) / {4 * mp['iters']}",
        "max_abs_err": max(r["max_abs_err"] for r in mp["modes"].values()),
        "ms": row["ns_per_iter"] / 1e6, "plain_ms": row["plain_ns_per_iter"] / 1e6,
        **mp_bound, "library_ms": None,
        "ns_per_iter": {m: r["ns_per_iter"] for m, r in mp["modes"].items()},
        "ns_per_row_step": {m: r["ns_per_row_step"] for m, r in mp["modes"].items()},
    }]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from tpu_rt_torch.probes import ablate2, mosaic_probe3, mxu_ablate
    from tpu_rt_torch.trace import common, flat_kernel, quad_kernel

    t0 = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    print(gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    shutil.rmtree(CACHE, ignore_errors=True)

    # 1. Build every kernel of the paths from the checkout's sources, one
    # nvcc per library, all started together (the forms of each are
    # instantiations in one library).
    kernel, flat_k = quad_kernel.KERNEL, flat_kernel.KERNEL
    libs = (*quad_kernel.KERNELS, *flat_kernel.KERNELS, mxu_ablate.KERNEL, ablate2.KERNEL,
            mosaic_probe3.KERNEL)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        capped = pool.submit(register_cap_ptxas, common)
        list(pool.map(lambda k: k.load(), libs))
        capped = capped.result()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t1:.2f} s of wall time")
    built, spills = {}, {}
    for k in libs:
        print(f"build: {k.name}.cu in {k.build_s:.2f} s")
        for name, regs, frame, spill, ln in ptxas_forms(k.build_log):
            print(f"  ptxas {ln}")
            built[name] = (regs, frame + spill)
            spills[name] = spill
    check(len(built) == N_FORMS, f"{len(built)} kernel forms compiled, want {N_FORMS}: 24 + 4 + "
          "24 quad, 48 + 4 + 48 binary, 48 + 2 tensor-core binary, 6 + 10 + 9 probe forms")
    for name, want in PTXAS_VMEM_F32.items():
        check(built.get(name) == want, f"ptxas {name}: {built.get(name)} (registers, stack + "
              f"spill bytes), want {want}")
    # The persistent frame forms (every library, residency and node format;
    # no uv, no counters) spill nothing.
    frame = [n for n in spills
             if re.match(r"(quad|flat)_trace(_c|_mxu)?<any=[01],uv=0,stats=0>", n)
             and "/first" not in n]
    check(len(frame) == 2 * 6 + 3 * 12 + 4 and not any(spills[n] for n in frame),
          f"spills in the persistent frame forms: {[(n, spills[n]) for n in frame if spills[n]]}")
    # The tensor-core forms: registers (ptxas) and dynamic shared memory per
    # block (the warps' ray tables; the first version's product tables).
    mxu_regs = {n: built[n][0] for n in built if n.startswith("flat_trace_mxu<")}
    persistent = [v for n, v in mxu_regs.items() if "/" not in n]
    frame_regs = {n: r for n, r in mxu_regs.items() if "uv=0,stats=0>" in n}
    print(f"tensor-core forms: persistent {min(persistent)}-{max(persistent)} registers (frame "
          f"forms {sorted(set(v for n, v in frame_regs.items() if '/' not in n))}), dynamic "
          f"shared memory {flat_kernel.MXU_SMEM['persistent']} B per block; first version"
          f" {[v for n, v in frame_regs.items() if '/first' in n]} registers, "
          f"{flat_kernel.MXU_SMEM['first']} B per block")
    # What a __launch_bounds__ minimum of MIN_BLOCKS blocks would cost the
    # quad frame forms: their ptxas at REGISTER_CAP registers.
    capped = [c for c in capped if re.fullmatch(r"quad_trace<any=[01],uv=0,stats=0>", c[0])]
    for name, regs, frame_b, spill, ln in capped:
        print(f"launch bounds minimum {MIN_BLOCKS} blocks: {ln}")
    check(len(capped) == 2 and all(c[1] <= REGISTER_CAP for c in capped),
          f"quad frame forms at {MIN_BLOCKS} blocks: {capped}")
    # The tensor-core forms issue FP64 mma: DMMA in the SASS of each.
    dmma = {fn: sum(op.startswith("DMMA") for op in c["ops"])
            for fn, c in sass_counts(flat_kernel.KERNEL_MXU.path).items()
            if re.search(r"flat_trace_mxu_kernel|flat_mxu_first_kernel", fn)}
    print(f"sass: flat_trace_mxu: {len(dmma)} kernel forms, DMMA per form "
          f"{min(dmma.values(), default=0)}-{max(dmma.values(), default=0)}")
    check(len(dmma) == 50 and all(dmma.values()),
          f"flat_trace_mxu forms without DMMA: {[f for f, n in dmma.items() if not n]}")
    probe_dmma = {mxu_ablate.VARIANTS[i]: sum(op.startswith("DMMA") for op in c["ops"])
                  for i, c in sass_forms(mxu_ablate.KERNEL.path, "mxu_ablate").items()}
    print(f"sass: mxu_ablate DMMA per variant {probe_dmma}")
    check(sorted(v for v, n in probe_dmma.items() if n) == sorted(DMMA_VARIANTS)
          and len(probe_dmma) == len(mxu_ablate.VARIANTS),
          f"mxu_ablate: DMMA in {probe_dmma}, want it in {DMMA_VARIANTS} only")
    sass_checks(ablate2.KERNEL.path, mosaic_probe3.KERNEL.path)
    phase("kernels built", t0)

    closest, bctx = bunny_primary(t0, kernel, dev)
    anyhit, closest_secondary, cctx = conference(t0, kernel, dev)
    f_closest, fb = binary_bunny(t0, flat_k, kernel, bctx)
    f_anyhit, f_closest_secondary, fc = binary_conference(t0, flat_k, kernel, cctx)
    forms = uv_and_stats(t0, kernel, flat_k, bctx, fb, cctx, fc)
    xla_route(t0, fb, bctx)
    times = binary_timing(t0, kernel, flat_k, bctx, fb, cctx, fc)
    dctx = dragon_setup(t0, kernel, flat_k, dev)
    fctx = dragon_frames(t0, kernel, flat_k, dev, dctx)
    d_times, d_plain = dragon_timing(t0, kernel, flat_k, dctx, fctx)
    d_entries = dragon_entries(kernel, flat_k, fctx, d_times, d_plain)
    tri_paths = triangle_paths(t0, bctx, fb, cctx, fc)
    tri_checks = triangle_checks(t0, bctx, fb, cctx, fc, dev)
    tri_times = triangle_timing(t0, bctx, fb, cctx, fc)
    probe = probe_phase(t0, fb, bctx, dev)
    t_entries = triangle_entries(tri_paths, tri_checks, tri_times, probe)
    ab_runs = ablate2_phase(t0, fb, bctx, dev)
    mp_runs, _ = mosaic_phase(t0, dev)
    p_entries = probe_entries(ab_runs, mp_runs)
    ab = design_ab(t0, kernel, flat_k, bctx, fb, cctx, fc, fctx)
    # The tensor-core frame forms' first versions, from the same A/B.
    for e in t_entries:
        if e["name"] in ("flat_trace_mxu", "flat_trace_mxu_anyhit"):
            r = ab[("flat_trace_mxu", "conference AO batch 1" if e["name"].endswith("_anyhit")
                    else "bunny primary")]
            e.update({"first_ms": r["first"], "ab_ms": r["persistent"],
                      "launch_shape": r["shape"]})

    # The bound of each earlier entry, on the rays it was timed on, from
    # the plain version's counters on those rays.
    b_rays, b_quad = bctx["renderer"].primary.rays, bctx["renderer"].tracer_tables
    b_flat, ao_b1 = fb["renderer"].tracer_tables, cctx["ao"]._batches[0].rays
    f_b1_rays = fc["ao"]._batches[0].rays
    bounds = {"quad": bound("quad_trace", b_quad, b_rays, bctx["plain"][1], bctx["seen"], 4),
              "quad_any": bound("quad_trace_anyhit", cctx["ao"].tracer_tables, ao_b1,
                                cctx["b1_plain"][1], cctx["b1_seen"], 4),
              "flat": bound("flat_trace", b_flat, b_rays, fb["plain"][1], fb["seen"], 2),
              "flat_any": bound("flat_trace_anyhit", fc["ao"].tracer_tables, f_b1_rays,
                                fc["plain"][1], fc["seen"], 2)}

    def form_entries(name, src, base):
        f = forms[name]
        tables, counts, seen, boxes = ((b_quad, bctx["plain"][1], bctx["seen"], 4) if name == "quad"
                                       else (b_flat, fb["plain"][1], fb["seen"], 2))
        prefer = "packet4" if name == "quad" else "packet"
        return [{
            "name": f"{base}_uv", "route": "cuda", "source": src,
            "replaces": f"{PACKET2} (want_uv=True, :466-468, :568-571, :891-893, :902-904)",
            "path": f"{SCENE} primary rays, make_routing_tracer({prefer!r}, want_uv=True), "
                    "closest and any hit",
            "launches": f["uv_launches"], "max_abs_err": f["uv_err"],
            "ms": times[(name, False, True, False)], "plain_ms": times[(name, "plain", True, False)],
            **bound(f"{base}_uv", tables, b_rays, counts, seen, boxes, want_uv=True),
            "library_ms": None,
        }, {
            "name": f"{base}_stats", "route": "cuda", "source": src,
            "replaces": f"{PACKET2} (count_iters, :432-433, :921-933, :1006-1011, :1034-1036)",
            "path": f"{SCENE} primary rays, make_routing_tracer({prefer!r}), with_stats=True",
            "launches": f["stats_launches"], "max_abs_err": f["stats_err"],
            "ms": times[(name, False, False, True)],
            "plain_ms": times[(name, "plain", False, True)],
            **bound(f"{base}_stats", tables, b_rays, counts, seen, boxes, with_stats=True),
            "library_ms": None,
        }]

    quad_src, flat_src = "tpu_rt_torch/csrc/quad_trace.cu", "tpu_rt_torch/csrc/flat_trace.cu"
    f_bunny = times["flat closest-hit, bunny primary"]
    f_b1 = times["flat any-hit, AO batch 1"]
    print(json.dumps({"kernels": [{
        "name": "quad_trace",
        "route": "cuda",
        "source": quad_src,
        "replaces": PACKET2,
        "path": closest["path"],
        "launches": closest["launches"],
        "max_abs_err": max(closest["max_abs_err"], closest_secondary["max_abs_err"]),
        "ms": ab[("quad_trace", "bunny primary")]["persistent"],
        "first_ms": ab[("quad_trace", "bunny primary")]["first"],
        "plain_ms": closest["plain_ms"],
        **bounds["quad"], "library_ms": None,
    }, {
        "name": "quad_trace_anyhit",
        "route": "cuda",
        "source": quad_src,
        "replaces": f"{PACKET2} (any_hit=True, :552-567, :881-883)",
        **anyhit,
        "ms": ab[("quad_trace", "conference AO batch 1")]["persistent"],
        "first_ms": ab[("quad_trace", "conference AO batch 1")]["first"],
        **bounds["quad_any"], "library_ms": None,
    }, *form_entries("quad", quad_src, "quad_trace"), {
        "name": "flat_trace",
        "route": "cuda",
        "source": flat_src,
        "replaces": f"{PACKET2} (binary f32 node unit :704-770, via trace_packet2 :1052)",
        "path": f_closest["path"],
        "launches": f_closest["launches"],
        "max_abs_err": max(f_closest["max_abs_err"], f_closest_secondary["max_abs_err"]),
        "ms": ab[("flat_trace", "bunny primary")]["persistent"],
        "first_ms": ab[("flat_trace", "bunny primary")]["first"],
        "plain_ms": f_bunny[1],
        **bounds["flat"], "library_ms": None,
    }, {
        "name": "flat_trace_anyhit",
        "route": "cuda",
        "source": flat_src,
        "replaces": f"{PACKET2} (binary node unit :704-770, any_hit=True :552-567, :881-883)",
        **f_anyhit,
        "ms": ab[("flat_trace", "conference AO batch 1")]["persistent"],
        "first_ms": ab[("flat_trace", "conference AO batch 1")]["first"],
        "plain_ms": f_b1[1],
        **bounds["flat_any"], "library_ms": None,
    }, *form_entries("flat", flat_src, "flat_trace"), *d_entries, *t_entries, *p_entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
