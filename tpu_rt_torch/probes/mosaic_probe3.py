"""The primitives of a row-cursor (packet) traversal schedule.

Counterpart of ``tools/mosaic_probe3.py``, which timed on a TPU v5e the
pieces of a design where one (16, 128) packet holds 16 traversals, one per
row of 128 rays.  The kernel is ``tpu_rt_torch/csrc/mosaic_probe3.cu``: a
packet is one block of 4 warps, each warp holds 4 rows of 8 lanes, row r
has its own node cursor, and lane s of a row holds its columns
32 v + 4 s .. + 3 (v = 0..3), so a warp's scalar row work serves 4 rows.
Modes (see the source): ``empty``, ``x16`` (16 cross-row reads),
``fetch16`` (a record per row), ``fetch16T`` (and its spread to the row's
lanes), ``onehot_stack`` (a per-row shared-memory stack), ``rowstep`` (the
full row step), ``div8`` / ``mul8`` / ``divmul`` (f32 division against
multiplication).

The functions take the tool's (64, 16, 128) table as a row-major [8192, 16]
table and x [P, 16, 128] f32, one block per packet (the tool's grid is
P = 1), and return its output ``acc + float(node of row 0)`` [P, 16, 128]
f32 and the rows' final nodes [P, 16] i32.  The stack and its pointer start
at zero.  The time per iteration is (t(5 iters) - t(iters)) / 4 iters from
CUDA events (median of 3), and per row step a sixteenth of it, as
``tools/mosaic_probe3.py:215-217`` takes them.  ``probe_plain`` computes
what the kernel computes in PyTorch ops (on the card its step replayed as
a CUDA graph), so ``run`` holds the output of every mode's timed launch
at ``iters`` against it, on every packet, and reports each mode's
registers and resident packets per SM as the card reports them
(``ProbeKernel.occupancy``).

``gather_rates`` times the row gather ``tab[idx]`` and the scatter-add
``index_add`` at the tool's sizes (:227-263): PyTorch calls, not kernels of
this repository.

Run on a card:  python -m tpu_rt_torch.probes.mosaic_probe3 [mode ...]
[--iters N] [--packets P (0: a full card)] [--gather] (prints one line per
mode and a JSON line; ``chip_smoke.py`` runs the same ``run`` and
``gather_rates``).  On the CPU, ``probe`` takes the plain version.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import numpy as np
import torch

from tpu_rt_torch.probes import ProbeKernel, call_ms, iterate, same_bits, time_ms

MODES = ("empty", "x16", "fetch16", "fetch16T", "onehot_stack", "rowstep", "div8", "mul8",
         "divmul")
FULL_MODE = "rowstep"
R = 16                  # rows (cursors) of a packet
COLS = 128
NB = 64                 # table blocks
TABLE_ROWS = NB * 128   # node n's record is row n
SLOTS = 64              # the stack's slots per row
ITERS = 20000           # tools/mosaic_probe3.py ITERS; timed at ITERS and 5 ITERS
# The fixed size row 9's times compare at: 4 packets of 16 warps (an SM's
# 2,048 threads) on each of an H100 SXM's 132 SMs, the first layout's
# full card.  ``full_card`` is the present layout's.
COMPARE_PACKETS = 528
REPEATS = 3
NO_SLOT = -3e38         # the tool's fill of the one-hot max
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
# f32 operations of one packet's row step: per row, idir (1), two spans of
# 24 (6 multiplies, 6 subtracts, 12 min / max) and the pop's max (1); per
# element, near and far of both children times acc (4), two compares and
# acc + f0 1e-12 + f1 1e-12 (4).
STEP_OPS = R * (1 + 2 * 24 + 1) + R * COLS * (4 + 2 + 4)
RECORD_BYTES = 64


class MosaicProbe3Kernel(ProbeKernel):
    """Wrapper of ``mosaic_probe3.cu``: checks the arguments and launches a
    mode (``ProbeKernel``: built at first use, launches counted per
    mode)."""

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__("mosaic_probe3", MODES, [vp, vp, ci, ci, vp, vp])

    def __call__(self, mode: str, tab: torch.Tensor, x: torch.Tensor, iters: int):
        if mode not in MODES:
            raise ValueError(f"{self.name}: unknown mode {mode!r}; one of {MODES}")
        if x.ndim != 3 or tuple(x.shape[1:]) != (R, COLS) or x.shape[0] < 1 or iters < 0:
            raise ValueError(f"{self.name}: need x [P >= 1, {R}, {COLS}] and iters >= 0; got "
                             f"{tuple(x.shape)}, {iters}")
        for what, t, shape in (("tab", tab, (TABLE_ROWS, 16)), ("x", x, tuple(x.shape))):
            if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"{self.name}: {what} must be contiguous f32 {shape}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        if tab.data_ptr() % 16 or x.data_ptr() % 16:
            raise ValueError(f"{self.name}: tab and x must start on 16 bytes")
        dev = x.device
        if dev.type != "cuda" or tab.device != dev:
            raise ValueError(f"{self.name} needs CUDA tensors on one device, got {tab.device}, "
                             f"{dev}")
        p = x.shape[0]
        out = torch.empty_like(x)
        nodes = torch.empty((p, R), dtype=torch.int32, device=dev)
        self.launch(mode, dev, tab.data_ptr(), x.data_ptr(), p, iters, out.data_ptr(),
                    nodes.data_ptr())
        return out, nodes


KERNEL = MosaicProbe3Kernel()


def probe(mode: str, tab: torch.Tensor, x: torch.Tensor, iters: int):
    """The output [P, 16, 128] f32 and the rows' final nodes [P, 16] i32 of
    ``iters`` iterations of ``mode``: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if x.device.type == "cpu":
        return probe_plain(mode, tab, x, iters)
    return KERNEL(mode, tab, x, iters)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def f2i(x: torch.Tensor) -> torch.Tensor:
    """f32 to int32 as XLA and the card convert: toward zero, saturating,
    NaN to 0."""
    big, small = x >= 2.0**31, x < -2.0**31
    y = torch.where(torch.isnan(x) | big | small, torch.zeros_like(x), x).to(torch.int32)
    return torch.where(big, INT32_MAX, torch.where(small, INT32_MIN, y)).to(torch.int32)


def _pop(st: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The tool's one-hot pop: max over the slots of where(iota == j, st,
    -3e38), [..., 1]."""
    iota = torch.arange(SLOTS, device=st.device)
    fill = torch.full_like(st, NO_SLOT)
    return torch.where(iota == j, st, fill).amax(-1, keepdim=True)


def _row_span(b, lo, idir, ood):
    """near, far [P, R, 1] of one child of each row (the tool's rowstep
    ``span`` :108-121, before its product with acc)."""
    def c(j):
        return b[..., j:j + 1]

    z = 8 + lo // 2
    t0, t1 = c(lo) * idir - ood, c(lo + 1) * idir - ood
    u0, u1 = c(lo + 2) * idir - ood, c(lo + 3) * idir - ood
    v0, v1 = c(z) * idir - ood, c(z + 1) * idir - ood
    near = torch.maximum(torch.maximum(torch.minimum(t0, t1), torch.minimum(u0, u1)),
                         torch.minimum(v0, v1))
    far = torch.minimum(torch.minimum(torch.maximum(t0, t1), torch.maximum(u0, u1)),
                        torch.maximum(v0, v1))
    return near, far


def probe_plain(mode: str, tab: torch.Tensor, x: torch.Tensor, iters: int):
    """What ``mosaic_probe3.cu`` computes (and ``tools/mosaic_probe3.py``'s
    ``make_kernel(mode, iters)`` per packet), in PyTorch ops on the device
    of ``x``; returns ``probe``'s (out [P, 16, 128], nodes [P, 16])."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    dev = x.device
    tab = tab.to(dev)
    tab_i = tab.view(torch.int32)
    p = x.shape[0]
    nodes = (torch.arange(R, device=dev) * 7 + 1).expand(p, R).clone()   # int64
    st = torch.zeros((p, R, SLOTS), dtype=torch.float32, device=dev)     # stack_ref[0]
    spv = torch.zeros((p, R, 1), dtype=torch.float32, device=dev)        # stack_ref[1][:, :, 0]
    iota = torch.arange(SLOTS, device=dev)

    def step(state):
        acc, nodes, st, spv = state
        if mode == "empty":
            acc, nodes = acc + 1.0, nodes + 1
        elif mode == "x16":
            s = f2i(acc[:, :, 0]).long().sum(1, keepdim=True)
            acc, nodes = acc + 1e-9, (nodes + s - s + 1) % TABLE_ROWS
        elif mode in ("fetch16", "fetch16T"):
            m = tab[nodes].transpose(1, 2)                      # [P, 16 slots, R]
            if mode == "fetch16T":
                m = m.transpose(1, 2)                           # T [P, R, 16 slots]
            acc, nodes = acc + m[:, 0:1, 0:1] * 1e-9, (nodes + 1) % TABLE_ROWS
        elif mode == "onehot_stack":
            spi = f2i(spv)
            st = torch.where(iota == spi, acc[:, :, 0:1], st)
            popped = _pop(st, spi - 1)
            spv = torch.fmod(spv + 1.0, 60.0)
            acc, nodes = acc + popped * 1e-12, nodes + 1
        elif mode == "rowstep":
            b, bi = tab[nodes], tab_i[nodes]                    # T [P, R, 16]
            idir, ood = acc[:, :, 0:1] + 1.0, acc[:, :, 1:2]
            near0, far0 = _row_span(b, 0, idir, ood)
            near1, far1 = _row_span(b, 4, idir, ood)
            n0, f0, n1, f1 = near0 * acc, far0 * acc, near1 * acc, far1 * acc
            hit0 = (f0 >= n0).any(-1, keepdim=True)
            hit1 = (f1 >= n1).any(-1, keepdim=True)
            link0, link1 = bi[..., 12:13], bi[..., 13:14]
            first = torch.where(hit0, link0, link1)
            push = hit0 & hit1
            spi = f2i(spv)
            st = torch.where((iota == spi) & push, link1.to(torch.float32), st)
            spi2 = spi + push.to(torch.int32)
            popped = _pop(st, spi2 - 1)
            nxt = torch.where(~(hit0 | hit1), f2i(popped), first)
            spv = (spi2 % 60).to(torch.float32)
            acc = acc + f0 * 1e-12 + f1 * 1e-12
            nodes = nxt[..., 0].long().abs() % TABLE_ROWS
        else:
            v = acc
            for q in range(8):
                if mode == "div8" or (mode == "divmul" and q % 2 == 0):
                    v = v / (v + 1.5)
                else:
                    v = v * (v + 1.5)
            acc, nodes = v * 1e-6 + acc * 0.5, nodes + 1
        return acc, nodes, st, spv

    acc, nodes, _, _ = iterate(step, (x.clone(), nodes, st, spv), iters)
    out = acc + nodes[:, 0].to(torch.float32)[:, None, None]
    return out, nodes.to(torch.int32)


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------

def probe_inputs(packets: int, seed: int, device="cuda"):
    """The tool's inputs (:181-182) from a numpy seed: the table, uniform in
    [0, 1e-3), as [8192, 16] rows, and x [packets, 16, 128] uniform in
    [0, 1)."""
    rng = np.random.default_rng(seed)
    tab3 = (rng.random((NB, 16, 128)) * 1e-3).astype(np.float32)
    tab = np.ascontiguousarray(tab3.transpose(0, 2, 1).reshape(TABLE_ROWS, 16))
    x = rng.random((packets, R, COLS)).astype(np.float32)
    return torch.tensor(tab, device=device), torch.tensor(x, device=device)


def full_card(device="cuda") -> int:
    """Packets that fill the card: the blocks of ``rowstep`` resident on an
    SM (``KERNEL.occupancy``) times the SMs."""
    occ = KERNEL.occupancy(FULL_MODE, torch.device(device))
    return occ["blocks_per_sm"] * occ["sms"]


def run(device="cuda", packets: int = 1, iters: int | None = None, modes=MODES) -> dict:
    """Time each mode at ``iters`` and 5 ``iters`` iterations (default
    ITERS) on ``packets`` packets; then hold the output of each mode's
    timed launch at ``iters`` against its plain version on the same
    packets, timing the plain version too.  Returns per mode the ns per
    iteration (and per row step) of both, the times, the check and the
    mode's ``occupancy``; ``launches`` are those of the timed runs."""
    iters = ITERS if iters is None else iters
    dev = torch.device(device)
    tab, x = probe_inputs(packets, 0, dev)
    KERNEL.reset_counts()
    res, outs = {}, {}
    for mode in modes:
        lo = []
        t_lo = time_ms(lambda: lo.append(probe(mode, tab, x, iters)), REPEATS)
        t_hi = time_ms(lambda: probe(mode, tab, x, 5 * iters), REPEATS)
        outs[mode] = lo[-1]
        ns = (t_hi - t_lo) / (4 * iters) * 1e6
        res[mode] = {"ns_per_iter": ns, "ns_per_row_step": ns / R, "ms_lo": t_lo, "ms_hi": t_hi}
        res[mode]["occupancy"] = KERNEL.occupancy(mode, dev)
    launches = dict(KERNEL.launches_by_form)
    for mode in modes:
        got, got_nodes = outs.pop(mode)
        (want, want_nodes), plain_ms = call_ms(lambda: probe_plain(mode, tab, x, iters))
        res[mode].update({
            "plain_ns_per_iter": plain_ms / iters * 1e6,
            "check_packets": packets, "check_iters": iters,
            "bits_differ": int((~same_bits(got, want)).sum()),
            "max_abs_err": float(torch.nan_to_num(got - want, posinf=0.0, neginf=0.0)
                                 .abs().max()),
            "nodes_differ": int((got_nodes != want_nodes).sum()),
        })
    return {"modes": res, "launches": launches, "packets": packets, "iters": iters}


def check(res: dict) -> list[str]:
    """The modes whose output differs from the plain version's: every bit
    (NaN as NaN, inf as inf) and every row's node."""
    return [m for m, r in res["modes"].items() if r["bits_differ"] or r["nodes_differ"]]


GATHER_ROWS = (307200, 786432)
GATHER_TABLES = ((500_000, 16), (500_000, 8), (4_000_000, 16))
SCATTER = (307200, 150_000, 3)


def gather_rates(device="cuda", rows=GATHER_ROWS, tables=GATHER_TABLES, scatter=SCATTER,
                 seed: int = 0, quiet: bool = False) -> list[dict]:
    """Times of a row gather ``tab[idx]`` (R indices into an [N, W] f32
    table) and of a scatter-add ``t.index_add(0, idx, val)`` at the tool's
    sizes (:250-263), each call with the sum of its result, as the tool's
    ``timeit`` takes them: the best of 3 runs of 8 calls, per call, after
    one warm-up.  On a CUDA device the runs are timed with CUDA events, on
    the CPU (only when asked for) with the host clock.  Inputs from a numpy
    seed.  Returns one dict per case (and prints a line each unless
    ``quiet``)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)

    def timeit(f):
        float(f().sum())
        best = float("inf")
        for _ in range(3):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                t0 = time.perf_counter()
            acc = torch.zeros((), device=dev)
            for _ in range(8):
                acc = acc + f().sum()
            if cuda:
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                float(acc)
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms / 8)
        return best

    out = []
    for r in rows:
        for n, w in tables:
            tab = torch.tensor(rng.normal(size=(n, w)).astype(np.float32), device=dev)
            idx = torch.tensor(rng.integers(0, n, r), dtype=torch.int64, device=dev)
            ms = timeit(lambda: tab[idx])
            out.append({"op": "gather", "R": r, "N": n, "W": w, "ms": ms,
                        "ns_per_row": ms / r * 1e6})
    r, n, w = scatter
    tab = torch.zeros((n, w), dtype=torch.float32, device=dev)
    idx = torch.tensor(rng.integers(0, n, r), dtype=torch.int64, device=dev)
    val = torch.tensor(rng.normal(size=(r, w)).astype(np.float32), device=dev)
    ms = timeit(lambda: tab.index_add(0, idx, val))
    out.append({"op": "scatter-add", "R": r, "N": n, "W": w, "ms": ms,
                "ns_per_row": ms / r * 1e6})
    if not quiet:
        for c in out:
            print(f"{c['op']} R={c['R']} N={c['N']} W={c['W']}: {c['ms']:7.3f} ms "
                  f"{c['ns_per_row']:6.2f} ns/row ({dev.type})", flush=True)
    return out


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=list(MODES), help=f"modes, of {MODES}")
    ap.add_argument("--iters", type=int, default=ITERS, help="the smaller trip count")
    ap.add_argument("--packets", type=int, default=1, help="packets (blocks); 0: a full card")
    ap.add_argument("--gather", action="store_true", help="also time gather_rates")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mosaic_probe3: no CUDA device (torch.cuda.is_available() is False)")
    bad_modes = [m for m in args.modes if m not in MODES]
    if bad_modes:
        raise SystemExit(f"mosaic_probe3: unknown modes {bad_modes}; of {MODES}")
    packets = args.packets or full_card()
    res = run(packets=packets, iters=args.iters, modes=tuple(args.modes))
    print(f"mosaic_probe3 on {torch.cuda.get_device_name(0)}: {packets} packets, "
          f"iters {res['iters']} and {5 * res['iters']}")
    for mode, r in res["modes"].items():
        occ = r["occupancy"]
        print(f"{mode:14s} {r['ns_per_iter']:8.1f} ns/iter ({r['ns_per_row_step']:6.2f} "
              f"ns/row-step); {occ['registers']} registers, {occ['blocks_per_sm']} packets per "
              f"SM; plain {r['plain_ns_per_iter']:.1f} ns/iter; vs plain on "
              f"{r['check_packets']} packets x {r['check_iters']}: bits differ "
              f"{r['bits_differ']}, nodes differ {r['nodes_differ']}", flush=True)
    if args.gather:
        res["gather"] = gather_rates()
    print(json.dumps(res))
    bad = check(res)
    if bad:
        sys.exit(f"mosaic_probe3: modes differ from their plain versions: {bad}")


if __name__ == "__main__":
    main()
