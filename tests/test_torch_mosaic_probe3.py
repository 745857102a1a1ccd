"""The row-cursor primitives probe (``tpu_rt_torch.probes.mosaic_probe3``) in
its plain version, against ``tools/mosaic_probe3.py``'s Pallas kernel in
interpret mode, one case per mode, on a random table and x from a numpy
seed at 3 iterations; ``gather_rates`` at a small size; and what the CUDA
wrapper refuses.

The tool's ``onehot_stack`` and ``rowstep`` read their stack scratch
without initialising it (:80-82, :133-135), so its kernel runs inside a
test-side kernel that zeroes both scratch refs and then calls it: the
port's versions start them at zero.  ``tools/`` is not changed.

Tolerance: the output to rtol 1e-5 (``mul8``'s inf as inf), the node part
of row 0's cursor (an integer) exactly where the output can carry it
(|acc| < 2^20; ``onehot_stack``'s acc is near -3e26).  XLA's CPU backend
contracts multiply-adds into FMAs (ROADMAP.md Queue 3), where the port
rounds each product.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_rt_torch.probes import mosaic_probe3 as mp

ITERS = 3
P = 2


@pytest.fixture(scope="module")
def tool():
    return importlib.import_module("tools.mosaic_probe3")


@pytest.fixture(scope="module")
def inputs():
    return mp.probe_inputs(P, 11, device="cpu")


def _tool_out(tool, mode, tab, x):
    """The tool's kernel for ``mode`` in interpret mode over the packets of
    x (its grid is one packet; here one step per packet), scratch zeroed
    first; tab [8192, 16] as its (64, 16, 128) table."""
    inner = tool.make_kernel(mode, ITERS)

    def kernel(tab_ref, x_ref, o_ref, stack_ref, sp_ref):
        stack_ref[...] = jnp.zeros(stack_ref.shape, jnp.float32)
        sp_ref[...] = jnp.zeros(sp_ref.shape, jnp.int32)
        inner(tab_ref, x_ref, o_ref, stack_ref, sp_ref)

    tab3 = tab.reshape(tool.NB, 128, 16).transpose(0, 2, 1)
    f = pl.pallas_call(
        kernel, grid=(x.shape[0],),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, tool.R, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, tool.R, 128), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        scratch_shapes=[pltpu.VMEM((2, tool.R, 64), jnp.float32), pltpu.SMEM((tool.R,), jnp.int32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(tab3), jnp.asarray(x)))


@pytest.mark.parametrize("mode", mp.MODES)
def test_plain_matches_the_tool(tool, inputs, mode):
    tab, x = inputs
    want = _tool_out(tool, mode, tab.numpy(), x.numpy())
    got, nodes = mp.probe(mode, tab, x, ITERS)
    assert got.shape == (P, mp.R, mp.COLS) and nodes.shape == (P, mp.R)
    got = got.numpy()
    if mode == "mul8":
        # 8 chained products of numbers above 1 overflow.
        assert np.isinf(got).any() and np.isinf(want).any()
    else:
        assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    node0 = nodes[:, 0].numpy().astype(np.float64)[:, None, None]
    acc = got.astype(np.float64) - node0
    carried = np.isfinite(acc) & (np.abs(acc) < 2**20)
    assert carried.any() or mode in ("onehot_stack", "mul8")
    np.testing.assert_array_equal(np.rint(want[carried] - acc[carried]),
                                  np.broadcast_to(node0, acc.shape)[carried])
    if mode != "rowstep":
        # The cursors of every other mode do not depend on the data.
        step = 1 + ITERS
        np.testing.assert_array_equal(nodes[:, 0].numpy(), step)


def test_rowstep_walks_the_table(inputs):
    """rowstep's cursors follow the links it reads: on this table they
    leave the +1 walk of the other modes, and stay in it."""
    tab, x = inputs
    _, nodes = mp.probe("rowstep", tab, x, 20)
    assert ((nodes >= 0) & (nodes < mp.TABLE_ROWS)).all()
    start = torch.arange(mp.R) * 7 + 1
    assert (nodes != start + 20).any()


def test_f2i_saturates_as_xla():
    x = torch.tensor([-3e38, 3e38, float("nan"), -2.5, 2.5, 2.0**31, -2.0**31, 1e9])
    want = np.asarray(jax.lax.convert_element_type(jnp.asarray(x.numpy()), jnp.int32))
    np.testing.assert_array_equal(mp.f2i(x).numpy(), want)


def test_gather_rates_small():
    cases = mp.gather_rates("cpu", rows=(64,), tables=((100, 16), (100, 8)), scatter=(64, 50, 3),
                            quiet=True)
    assert [c["op"] for c in cases] == ["gather", "gather", "scatter-add"]
    for c in cases:
        assert c["ms"] > 0 and c["ns_per_row"] == pytest.approx(c["ms"] / c["R"] * 1e6)


@pytest.mark.parametrize("bad", ["mode", "x", "tab", "dtype", "iters", "misaligned"])
def test_wrapper_refuses_bad_arguments(inputs, bad):
    tab, x = inputs
    mode, iters = "rowstep", 4
    if bad == "mode":
        mode = "div9"
    elif bad == "x":
        x = x[:, :, :64]
    elif bad == "tab":
        tab = tab[:4096]
    elif bad == "dtype":
        x = x.double()
    elif bad == "misaligned":
        # Contiguous, but 4 bytes past a 16-byte boundary: the kernel reads
        # float4s.
        x = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    else:
        iters = -1
    with pytest.raises(ValueError, match="mosaic_probe3"):
        mp.KERNEL(mode, tab, x, iters)


def test_wrapper_refuses_cpu_tensors(inputs):
    launches = mp.KERNEL.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mp.KERNEL("empty", *inputs, 4)
    assert mp.KERNEL.launches == launches
