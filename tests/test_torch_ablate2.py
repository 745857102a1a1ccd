"""The traversal-step ablation probe (``tpu_rt_torch.probes.ablate2``) in its
plain version, against ``tools/ablate2.py``'s Pallas kernel in interpret
mode, one case per level, on ``pack_tables2``'s tables of a 700-triangle
blob; and what the CUDA wrapper refuses.

The tool parses ``sys.argv`` when it is imported (:29-32), so it is
imported with ``sys.argv`` holding its name alone; its K / U / NITER / S
globals are set as ``timed`` sets NITER (:186-187).  Its kernel leaves its
scratch uninitialised (the VMEM ctx read from level 3 up, the SMEM stack
and queue), which gives NaN from level 3 on, so it runs inside a test-side
kernel that zeroes the three scratch refs and then calls it: the port's
versions start them at zero.  ``tools/`` is not changed.

Tolerance: the node part of each output (an integer) exactly; the
accumulator to rtol 1e-5, plus the spacing of the output that carries it.
XLA's CPU backend contracts the Woop test's multiply-adds into FMAs
(ROADMAP.md Queue 3), where the port rounds each product.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.scene import Scene, procedural
from tpu_rt.trace.packet2 import pack_tables2

from tpu_rt_torch.probes import ablate2

K, U, NITER, TILE = 2, 3, 3, 128
S = TILE // 128


@pytest.fixture(scope="module")
def tool():
    argv = sys.argv
    sys.argv = ["ablate2.py"]
    try:
        mod = importlib.import_module("tools.ablate2")
    finally:
        sys.argv = argv
    mod.K, mod.U, mod.NITER, mod.S = K, U, NITER, S
    return mod


@pytest.fixture(scope="module")
def tables():
    scene = Scene(procedural.make_blob(700, seed=80))
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    nodes3, woop3 = pack_tables2(flat)
    nodes = np.ascontiguousarray(nodes3.transpose(0, 2, 1).reshape(-1, 16))
    rows = np.ascontiguousarray(woop3.transpose(0, 2, 1).reshape(-1, 16))
    rays = ablate2.probe_rays(rows, scene, K * TILE, 7, K, TILE, aim_iters=NITER, device="cpu")
    return nodes3, woop3, nodes, rows, rays


def _tool_out(tool, level, nodes3, woop3, rays):
    """The tool's kernel at ``level`` in interpret mode, its scratch zeroed
    first; rays [K * 128, 8] as its (1, K, 8, S, 128) block."""
    inner = tool.make_kernel(level)

    def kernel(nodes_ref, woop_ref, rays_ref, out_ref, stack_ref, queue_ref, ctx_ref):
        stack_ref[...] = jnp.zeros(stack_ref.shape, jnp.int32)
        queue_ref[...] = jnp.zeros(queue_ref.shape, jnp.int32)
        ctx_ref[...] = jnp.zeros(ctx_ref.shape, jnp.float32)
        inner(nodes_ref, woop_ref, rays_ref, out_ref, stack_ref, queue_ref, ctx_ref)

    block = rays.reshape(K, S * 128, 8).transpose(0, 2, 1).reshape(1, K, 8, S, 128)
    f = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2
        + [pl.BlockSpec((1, K, 8, S, 128), lambda i: (i, 0, 0, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, K, S, 128), lambda i: (i, 0, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, K, S, 128), jnp.float32),
        scratch_shapes=[pltpu.SMEM((K, tool.STACK_DEPTH), jnp.int32),
                        pltpu.SMEM((K, tool.QUEUE_DEPTH), jnp.int32),
                        pltpu.VMEM((K, 6, S, 128), jnp.float32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(nodes3), jnp.asarray(woop3), jnp.asarray(block))).reshape(-1)


@pytest.mark.parametrize("level", ablate2.LEVELS)
def test_plain_matches_the_tool(tool, tables, level):
    nodes3, woop3, nodes, rows, rays = tables
    want = _tool_out(tool, level, nodes3, woop3, rays.numpy())
    got, node = ablate2.ablate_plain(level, torch.tensor(nodes), torch.tensor(rows), rays, NITER,
                                     K, U, TILE)
    assert got.shape == (K * TILE,) and node.shape == (K,) and torch.isfinite(got).all()
    # Every level walks the same cursors: packet k ends at k + NITER.
    np.testing.assert_array_equal(node.numpy(), np.arange(K) + NITER)
    node_r = np.repeat(node.numpy(), TILE).astype(np.float64)
    acc = got.numpy().astype(np.float64) - node_r
    np.testing.assert_array_equal(np.rint(want - acc), node_r)
    np.testing.assert_allclose(want - node_r, acc, rtol=1e-5,
                               atol=float(np.spacing(np.abs(want).max())))
    if level < 7:
        # Below the Woop tests acc is the ray's own start, exactly.
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(acc, 1.0)
    else:
        # The aimed rays hit: some accumulators took a t.
        assert (acc != 1.0).sum() > TILE // 4


def test_levels_agree_on_the_card_layout(tables):
    """At the card's layout (packets of 32, K = 4) the levels the tool
    cannot tell apart agree: 0-2 and 3-6 leave acc alone, 7-9 take the
    same hits (the while loop of 9 runs the counted loop's trips)."""
    _, _, nodes, rows, _ = tables
    scene = Scene(procedural.make_blob(700, seed=80))
    rays = ablate2.probe_rays(rows, scene, ablate2.GROUP, 3, device="cpu")
    n, r = torch.tensor(nodes), torch.tensor(rows)
    outs = [ablate2.ablate(level, n, r, rays, 40) for level in ablate2.LEVELS]
    for level, (out, node) in enumerate(outs):
        assert out.shape == (ablate2.GROUP,) and node.shape == (ablate2.GROUP // 32,)
        np.testing.assert_array_equal(node.numpy(), np.tile(np.arange(ablate2.K), 4) + 40)
    for a, b in ((0, 6), (7, 8), (8, 9)):
        assert torch.equal(outs[a][0], outs[b][0]), (a, b)
    assert not torch.equal(outs[6][0], outs[7][0])


def test_walk_rows_wrap_inside_their_group():
    rows = ablate2.walk_rows(300, 2, 40)
    assert rows.shape == (2, 40, ablate2.U)
    ti = (np.arange(2)[:, None] + np.arange(40)) * 7 % 300
    np.testing.assert_array_equal(rows[..., 0], ti)
    group = ti - ti % 128
    width = np.minimum(128, 300 - group)
    assert ((rows >= group[..., None]) & (rows < (group + width)[..., None])).all()
    # Row 299 is the last of a 44-row group: its next rows wrap to 256, 257.
    np.testing.assert_array_equal(ablate2.walk_rows(300, 1, 1)[0, 0], [0, 1, 2])
    node = np.flatnonzero(np.arange(300) * 7 % 300 == 299)[0]
    np.testing.assert_array_equal(ablate2.walk_rows(300, node + 1, 1)[node, 0], [299, 256, 257])


def _good():
    return torch.zeros((8, 16)), torch.zeros((300, 16)), torch.zeros((ablate2.GROUP, 8))


@pytest.mark.parametrize("bad", ["level", "niter_big", "rows_dtype", "rays", "nodes", "rows",
                                 "dtype", "strided", "niter", "misaligned"])
def test_wrapper_refuses_bad_arguments(bad):
    nodes, rows, rays = _good()
    level, niter = 8, 4
    if bad == "level":
        level = 10
    elif bad == "niter_big":
        niter = 2**31 // 7
    elif bad == "rows_dtype":
        rows = rows.int()
    elif bad == "rays":
        rays = rays[:100]
    elif bad == "nodes":
        nodes = torch.zeros((8, 12))
    elif bad == "rows":
        rows = torch.zeros((0, 16))
    elif bad == "dtype":
        rays = rays.double()
    elif bad == "strided":
        rays = torch.zeros((ablate2.GROUP, 16))[:, ::2]
    elif bad == "misaligned":
        # Contiguous, but 4 bytes past a 16-byte boundary: the kernel reads
        # float4s.
        nodes = torch.zeros(8 * 16 + 1)[1:].view(8, 16)
    else:
        niter = -1
    with pytest.raises(ValueError, match="ablate2"):
        ablate2.KERNEL(level, nodes, rows, rays, niter)


def test_wrapper_refuses_cpu_tensors():
    launches = ablate2.KERNEL.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ablate2.KERNEL(8, *_good(), 4)
    assert ablate2.KERNEL.launches == launches
    # ablate() takes the plain version for CPU rays.
    out, node = ablate2.ablate(0, *_good(), 2)
    assert out.shape == (ablate2.GROUP,) and node.shape == (ablate2.GROUP // 32,)
