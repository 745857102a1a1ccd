"""The persistent traversal kernels' launch shape and C ABI, on the CPU:
the grid and shared-stack helpers of ``tpu_rt_torch.trace.common``, the
ctypes ``argtypes`` of every traversal wrapper against the
``QUAD_LAUNCH_ARGS`` / ``FLAT_LAUNCH_ARGS`` macros of ``csrc/``, argument
for argument (a pointer that ctypes passes as a 32-bit int would be cut,
and nothing on the CPU would notice), and the constants the Python side
shares with the kernels."""

import ctypes
import os
import re

import pytest

from tpu_rt_torch.trace import common, flat_kernel, quad_kernel
from tpu_rt_torch.trace.common import (
    BLOCK,
    DESIGNS,
    MAX_SHARED_PER_BLOCK,
    STACK_SIZE,
    StackDepthError,
    persistent_grid,
    shared_stack_bytes,
)

CSRC = common.CSRC
C_TYPES = {"const void *": ctypes.c_void_p, "void *": ctypes.c_void_p, "int": ctypes.c_int,
           "size_t": ctypes.c_size_t}
WRAPPERS = {"quad_trace": quad_kernel.KERNEL, "quad_trace_c": quad_kernel.KERNEL_C,
            "flat_trace": flat_kernel.KERNEL, "flat_trace_c": flat_kernel.KERNEL_C,
            "flat_trace_mxu": flat_kernel.KERNEL_MXU}


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _macro(header: str, name: str) -> list[tuple[str, str]]:
    """The (C type, name) pairs of a parameter-list macro."""
    m = re.search(rf"#define {name}\s+((?:.*\\\n)*.*)", _read(header))
    assert m, f"{name} not in {header}"
    body = m.group(1).replace("\\\n", " ")
    out = []
    for param in (p.strip() for p in body.split(",")):
        pm = re.fullmatch(r"((?:const )?(?:void|int|size_t)\s*\*?)\s*(\w+)", param)
        assert pm, f"cannot read parameter {param!r} of {name}"
        out.append((re.sub(r"\s*\*", " *", pm.group(1)).strip(), pm.group(2)))
    return out


def _abi(lib: str) -> list[tuple[str, str]]:
    header, macro = (("quad_trace.cuh", "QUAD_LAUNCH_ARGS") if lib.startswith("quad")
                     else ("flat_trace.cuh", "FLAT_LAUNCH_ARGS"))
    return _macro(header, macro)


@pytest.mark.parametrize("n_rays, sms, per_sm, want", [
    (307_200, 132, 12, 1584),       # bunny primary: the card is the limit
    (2_097_152, 132, 16, 2112),     # AO batch 1
    (1000, 132, 12, 8),             # a small batch: its own blocks
    (128, 132, 12, 1),
    (129, 132, 12, 2),
    (0, 132, 12, 0),
])
def test_persistent_grid(n_rays, sms, per_sm, want):
    assert persistent_grid(n_rays, sms, per_sm) == want


def test_persistent_grid_refuses_no_occupancy():
    with pytest.raises(ValueError):
        persistent_grid(1000, 132, 0)
    with pytest.raises(ValueError):
        persistent_grid(1000, 0, 12)


@pytest.mark.parametrize("need, want", [(24, 24 * BLOCK * 4), (30, 30 * BLOCK * 4),
                                        (0, BLOCK * 4), (1, BLOCK * 4),
                                        (STACK_SIZE, STACK_SIZE * BLOCK * 4)])
def test_shared_stack_bytes(need, want):
    # check_stack's need of the tree, one int32 entry per thread and level.
    assert shared_stack_bytes(need) == want
    assert want <= MAX_SHARED_PER_BLOCK


def test_shared_stack_refuses_above_a_block():
    most = MAX_SHARED_PER_BLOCK // (BLOCK * 4)
    assert shared_stack_bytes(most) <= MAX_SHARED_PER_BLOCK
    with pytest.raises(StackDepthError, match="per block"):
        shared_stack_bytes(most + 1)
    with pytest.raises(StackDepthError):
        shared_stack_bytes(STACK_SIZE, block=1024)
    with pytest.raises(ValueError):
        shared_stack_bytes(-1)


@pytest.mark.parametrize("lib", sorted(WRAPPERS))
def test_argtypes_match_the_c_abi(lib):
    params = _abi(lib)
    got = WRAPPERS[lib].argtypes
    assert len(got) == len(params), (lib, len(got), len(params))
    for i, ((ctype, name), argtype) in enumerate(zip(params, got)):
        assert argtype is C_TYPES[ctype], f"{lib} argument {i} {name}: {ctype} but ctypes " \
                                          f"{argtype.__name__}"
    # The pointers the launch adds for the persistent kernels.
    names = [n for _, n in params]
    assert names[-5:] == ["design", "stack_need", "counter", "shape", "stream"]


@pytest.mark.parametrize("lib", sorted(WRAPPERS))
def test_entry_point_takes_the_macro(lib):
    src = _read(f"{lib}.cu")
    macro = "QUAD_LAUNCH_ARGS" if lib.startswith("quad") else "FLAT_LAUNCH_ARGS"
    assert re.search(rf'extern "C" int {lib}_launch\({macro}\)', src)
    call = "QUAD_LAUNCH_CALL" if lib.startswith("quad") else "FLAT_LAUNCH_CALL"
    assert call in src
    # The call macro passes the parameters in the order they are declared.
    header = "quad_trace.cuh" if lib.startswith("quad") else "flat_trace.cuh"
    m = re.search(rf"#define {call}\s+((?:.*\\\n)*.*)", _read(header))
    passed = [x.strip() for x in m.group(1).replace("\\\n", " ").split(",")]
    assert passed == [n for _, n in _abi(lib)]


# The designs each library keeps: the first versions of the vmem f32 frame
# forms in quad_trace, flat_trace and flat_trace_mxu, the shared-memory
# stack in the first two; the postponed-leaf libraries run persistent only.
KEPT = {"quad_trace": {"persistent", "first", "shared_stack"},
        "flat_trace": {"persistent", "first", "shared_stack"},
        "quad_trace_c": {"persistent"}, "flat_trace_c": {"persistent"},
        "flat_trace_mxu": {"persistent", "first"}}


@pytest.mark.parametrize("design", sorted(DESIGNS))
@pytest.mark.parametrize("lib", sorted(WRAPPERS))
def test_designs_each_library_keeps(lib, design):
    kern = WRAPPERS[lib]
    assert set(kern.designs) == KEPT[lib]
    lo, hi = kern.cursors
    if design in KEPT[lib] and (design == "persistent" or lo == 1):
        kern.check_design(design, cursors=lo)      # the frame forms on vmem f32
    else:
        with pytest.raises(ValueError):
            kern.check_design(design, cursors=lo)
    others = [{"want_uv": True}, {"with_stats": True}, {"residency": "mixed"},
              {"residency": "hbm"}, {"bf16_nodes": True}, {"cursors": hi if hi > 1 else 2}]
    for kw in others:
        if design == "persistent":
            kern.check_design(design, **{"cursors": lo, **kw})
        else:
            with pytest.raises(ValueError):
                kern.check_design(design, **{"cursors": lo, **kw})
    with pytest.raises(ValueError):
        kern.check_design("bogus")


def test_designs_and_block_match_the_kernels():
    src = _read("trace_common.cuh")
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kBlock"] == BLOCK
    assert consts["kPersistent"] == DESIGNS["persistent"]
    assert consts["kFirst"] == DESIGNS["first"]
    assert consts["kSharedStack"] == DESIGNS["shared_stack"]
    assert len(DESIGNS) == 3
    # kEmpty, the stack's sentinel, is the quad tree's empty-slot link.
    from tpu_rt_torch.bvh.collapse import SENT

    assert re.search(r"constexpr int kEmpty = 0x7FFFFFFF;", src) and SENT == 0x7FFFFFFF


def test_refill_threshold_is_a_kernel_constant():
    # The reference's 20 of 32 lanes (kepler_dynamic_fetch.cu:48), fixed in
    # the source: the build sets no schedule.
    src = _read("trace_common.cuh")
    assert re.search(r"^constexpr int kRefill = 20;$", src, re.M)
    assert not [f for f in common.NVCC_FLAGS if f.startswith("-D") and "STACK_SIZE" not in f]
    for header in ("trace_common.cuh", "quad_trace.cuh", "flat_trace.cuh"):
        assert "TRACE_" not in re.sub(r"//.*", "", _read(header)), header


def test_ptxas_names_of_the_new_forms():
    import chip_smoke

    mangled = {
        "_ZN12_GLOBAL__N_117quad_trace_kernelILb1ELb0ELb0ELb0ELb0ELb0ELb{s}EEEvN12tpu_rt_torch9"
        "TraceArgsE": "quad_trace<any=1,uv=0,stats=0>{lay}",
        "_ZN12_GLOBAL__N_117flat_trace_kernelILb0ELb1ELb0ELb1ELb1ELb1ELb1ELb{s}EEEvN12tpu_rt_"
        "torch9TraceArgsE": "flat_trace_c<any=0,uv=1,stats=0>@hbm-bf16{lay}",
        "_ZN12_GLOBAL__N_117quad_first_kernelILb0EEEvPK6float4iS3_PKfS5_S5_S5_PiPfi":
            "quad_trace<any=0,uv=0,stats=0>/first",
    }
    log = []
    want = []
    for i, (m, name) in enumerate(mangled.items()):
        for s in (0, 1):
            log += [f"ptxas info    : Compiling entry function '{m.format(s=s)}' for 'sm_90a'",
                    f"    {8 * i} bytes stack frame, {4 * s} bytes spill stores, {4 * s} bytes "
                    "spill loads",
                    f"ptxas info    : Used {30 + i} registers"]
            lay = "/shared_stack" if s else ""
            want.append((name.format(lay=lay), 30 + i, 8 * i, 8 * s))
            if "{s}" not in m:
                break
    got = [(n, r, b, s) for n, r, b, s, _ in chip_smoke.ptxas_forms("\n".join(log))]
    assert got == want


def test_min_blocks_rewrites_every_entry():
    # chip_smoke.py's ptxas of the quad frame forms under a minimum of 12
    # blocks: each entry's launch bounds gain (or replace) .minnctapersm.
    import chip_smoke

    ptx = (".visible .entry a(\n.param .u64 p\n)\n.maxntid 128, 1, 1\n.minnctapersm 1\n{\n}\n"
           ".visible .entry b(\n)\n.maxntid 128, 1, 1\n{\n}\n")
    got, n = chip_smoke.with_min_blocks(ptx, 12)
    assert n == 2 == got.count(".entry ")
    assert got.count(".minnctapersm 12") == 2 and ".minnctapersm 1\n" not in got
    assert got.index(".minnctapersm 12") > got.index(".maxntid 128, 1, 1")
