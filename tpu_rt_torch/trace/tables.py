"""Table formats and placement policy of the traversal kernels.

Counterpart of ``tpu_rt/trace/packet2.py``'s bf16 node packing
(``_bf16_round_dir`` :106-123, ``pack_tables2`` :238-255) and table
policy (``tables2_fit_vmem`` :333-336, ``choose_node_format`` :339-358,
``tables2_residency`` :361-373, ``_residency_flags`` :376-381, the packet4
rule of ``trace_packet4`` :1168-1175), and of ``tpu_rt/trace/__init__.py``
``quad_policy`` (:79-108), with a tune file of the port's own.

Residencies keep ``tpu_rt``'s names; on the card they are cache policies:

- ``"vmem"``:  both tables read with the default caching (they fit the L2
  together);
- ``"mixed"``: the node table held in a persisting L2 access-policy window,
  triangle rows streamed (evict first);
- ``"hbm"``:   both tables streamed, no window.

Every policy function takes its budget as ``budget_bytes``.  The uploads
and the routing default to ``TABLE_BUDGET`` on every device, so the CPU
makes the card's decisions; ``tpu_rt``'s decisions are those at its
``VMEM_TABLE_BUDGET``.  Host code, numpy only.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings

import numpy as np

from tpu_rt_torch.bvh.collapse import MAX_LEAF4

# tpu_rt's budget for tables resident in a TPU v5e's VMEM (packet2.py:103).
VMEM_TABLE_BUDGET = 12 * 1024 * 1024
# The default budget on every device: none, so every scene gets vmem f32
# tables and 16-wide leaves.  On an H100 the plain loads of the vmem forms
# were never slower than the mixed and hbm forms on dragon, whose tables
# are 1.6x the L2, and faster on its AO rays (PERF.md); a budget that
# routes to the streamed forms waits for a measured gain.
TABLE_BUDGET = float("inf")
RESIDENCIES = ("vmem", "mixed", "hbm")
# Bytes per row: f32 binary node, bf16 binary node, quad node, Woop row.
FLAT_NODE_BYTES, BF16_NODE_BYTES, QUAD_NODE_BYTES, WOOP_ROW_BYTES = 64, 32, 128, 64
# The widest leaf a quad leaf link ~(first | count << 24) can encode.
MAX_LEAF_LINK = 127


def _bf16_round_dir(x: np.ndarray, up: bool) -> np.ndarray:
    """Directed f32 -> bf16 rounding as uint16 bit patterns: up=False
    rounds toward -inf, up=True toward +inf, so bf16 node bounds are
    outward-rounded (lo <= true lo, hi >= true hi) and every slab test
    against them is conservative.  ``tpu_rt``'s bit for bit, except that a
    NaN stays NaN: truncating a NaN whose payload lies only in the low 16
    bits (0x7F800001) would give an infinity, and a NaN bound must keep its
    box a miss (trace_common.cuh ``min_nan`` / ``max_nan``); such a NaN gets
    the quiet bit set, sign kept."""
    x = np.ascontiguousarray(x, np.float32)
    b = x.view(np.uint32)
    tr = (b >> 16).astype(np.uint16)          # truncate-toward-zero bf16
    trf = (tr.astype(np.uint32) << 16).view(np.float32)
    sign = (tr & np.uint16(0x8000)) != 0
    if up:
        need = trf < x
        adj = np.where(sign, tr - np.uint16(1), tr + np.uint16(1))
    else:
        need = trf > x
        adj = np.where(sign, tr + np.uint16(1), tr - np.uint16(1))
    out = np.where(need, adj, tr).astype(np.uint16)
    return np.where(np.isnan(x), out | np.uint16(0x0040), out)


def pack_bf16_nodes(nodes: np.ndarray) -> np.ndarray:
    """The bf16 node record of a FlatBVH node table [N, 16] f32: [N, 8]
    int32, 32 bytes per node.  Word j (0..5) holds column 2j (a lower
    bound, rounded toward -inf) in its low half and column 2j + 1 (an upper
    bound, rounded toward +inf) in its high half, in the f32 record's column
    order; words 6, 7 are the two child links verbatim.

    Unlike ``pack_tables2``'s bf16 branch there is no split-axis hint in
    the links: the port's binary kernel orders children by entry distance,
    as ``trace_flat_scalar`` does, so links keep all 32 bits and the 24-bit
    node-index limit of packet2.py:239-240 does not apply.  The 128-lane
    transposition is not copied either."""
    nodes = np.ascontiguousarray(nodes, np.float32)
    if nodes.ndim != 2 or nodes.shape[1] != 16:
        raise ValueError(f"flat nodes must be [N, 16], got {nodes.shape}")
    lo = _bf16_round_dir(nodes[:, 0:12:2], up=False).astype(np.uint32)
    hi = _bf16_round_dir(nodes[:, 1:12:2], up=True).astype(np.uint32)
    out = np.zeros((nodes.shape[0], 8), np.int32)
    out[:, 0:6] = (lo | (hi << 16)).view(np.int32)
    out[:, 6:8] = nodes[:, 12:14].view(np.int32)
    return out


# ---------------------------------------------------------------------------
# Placement policy
# ---------------------------------------------------------------------------

def _rows(x) -> int:
    return int(np.asarray(x).shape[0])


def tables2_fit_vmem(flat, budget_bytes: int) -> bool:
    """Both f32 binary tables within the budget."""
    return (_rows(flat.nodes) * FLAT_NODE_BYTES + _rows(flat.tri_woop) * WOOP_ROW_BYTES
            <= budget_bytes)


def choose_node_format(flat, budget_bytes: int) -> tuple[str, bool]:
    """(residency, bf16_nodes) of the binary tables: residency upgrades
    first, f32 nodes second: vmem-f32 > vmem-bf16 > mixed-f32 > mixed-bf16
    > hbm-f32 (fully streamed stays f32, as ``tpu_rt`` measured)."""
    n_nodes = _rows(flat.nodes)
    woop_b = _rows(flat.tri_woop) * WOOP_ROW_BYTES
    if n_nodes * FLAT_NODE_BYTES + woop_b <= budget_bytes:
        return "vmem", False
    if n_nodes * BF16_NODE_BYTES + woop_b <= budget_bytes:
        return "vmem", True
    if n_nodes * FLAT_NODE_BYTES <= budget_bytes:
        return "mixed", False
    if n_nodes * BF16_NODE_BYTES <= budget_bytes:
        return "mixed", True
    return "hbm", False


def tables2_residency(flat, bf16_nodes: bool, budget_bytes: int) -> str:
    """Residency of the binary tables in a given node format."""
    nodes_b = _rows(flat.nodes) * (BF16_NODE_BYTES if bf16_nodes else FLAT_NODE_BYTES)
    return quad_residency(nodes_b, _rows(flat.tri_woop) * WOOP_ROW_BYTES, budget_bytes)


def quad_residency(nodes_bytes: int, woop_bytes: int, budget_bytes: int) -> str:
    """The residency rule of both kernels' tables (``trace_packet4``
    :1168-1175, ``tables2_residency``): both within the budget "vmem", the
    node table alone "mixed", else "hbm"."""
    if nodes_bytes + woop_bytes <= budget_bytes:
        return "vmem"
    if nodes_bytes <= budget_bytes:
        return "mixed"
    return "hbm"


def _residency_flags(hbm) -> tuple[bool, bool]:
    """(nodes streamed, triangles streamed) of a residency (str, or a bool:
    True "hbm", False "vmem")."""
    if isinstance(hbm, str):
        return {"vmem": (False, False), "mixed": (False, True), "hbm": (True, True)}[hbm]
    return (bool(hbm), bool(hbm))


def check_residency(residency: str) -> str:
    """``residency`` if it is one of RESIDENCIES, else ValueError."""
    if residency not in RESIDENCIES:
        raise ValueError(f"unknown residency {residency!r}; one of {RESIDENCIES}")
    return residency


def _tune_path(flat, cache_dir: str | None) -> str | None:
    """Per-scene leaf-width tune file of the port, ``c<hash>.json``: content
    keyed like the quad cache and beside it, under a salt and a name that
    ``tpu_rt`` never writes (its ``_tune_path`` is ``t<hash>.json``, salt
    ``quad-tune``), so a width tuned on a TPU does not route the card's
    kernel.  ``tpu_rt_torch.bench.tune_quad`` writes it."""
    if cache_dir is None:
        return None
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(flat.nodes).tobytes())
    h.update(b"quad-tune-cuda")
    return os.path.join(cache_dir, f"c{h.hexdigest()[:8]}.json")


def quad_policy(flat, cache_dir: str | None, budget_bytes: int) -> int:
    """leaf_max of the 4-wide collapse: a width recorded in the port's tune
    file (``_tune_path``) wins; else 32 when the binary f32 node table
    exceeds the budget, 16 (MAX_LEAF4) otherwise.  A missing file, one that
    is not JSON or one without ``leaf_max`` gives the static rule silently,
    as in ``tpu_rt``; a ``leaf_max`` that is not an int in [1, MAX_LEAF_LINK]
    (a leaf link holds the count in 7 bits, ``quad_trace.cuh``) warns and
    gives the static rule."""
    p = _tune_path(flat, cache_dir)
    if p is not None and os.path.exists(p):
        try:
            with open(p) as f:
                leaf_max = json.load(f)["leaf_max"]
        except (OSError, KeyError, TypeError, ValueError):
            pass
        else:
            if type(leaf_max) is int and 1 <= leaf_max <= MAX_LEAF_LINK:
                return leaf_max
            warnings.warn(f"tpu_rt_torch: tune file {p}: leaf_max {leaf_max!r} is not an int "
                          f"in [1, {MAX_LEAF_LINK}]; using the static rule", RuntimeWarning,
                          stacklevel=2)
    return 32 if _rows(flat.nodes) * FLAT_NODE_BYTES > budget_bytes else MAX_LEAF4
