"""Inverse-rendering optimization loop with checkpoint/resume.

Counterpart of ``tpu_rt.diff.train``: fit vertex positions and materials to
a target image by gradient descent (Adam on the L2 image loss through
``render_image_diff``), and persist the OPTIMIZER state so a preempted run
resumes exactly (step counter, Adam moments, params).

Determinism contract (tested, on the CPU and on the card): resume-from-
step-k followed by (n-k) steps produces bit-identical params to an
uninterrupted n-step run — ``train_step`` is a pure function of (state,
batch): it reads the state, never writes into it, and runs its backward
with ``torch.use_deterministic_algorithms(True)`` (restored after it), so
the scatter-adds behind the gathers' gradients sum in a fixed order.

Differences from ``tpu_rt``, by necessity:

- The optimizer is ``torch.optim.Adam(lr)`` (optax.adam's defaults: b1 0.9,
  b2 0.999, eps 1e-8).  Its bias corrections are computed in Python
  doubles, optax's in f32, so updates agree to rounding, not bit for bit.
- Checkpoints are ``torch.save`` files (``step_<n>.pt``, written to a
  temporary file, then ``os.replace``), the newest ``MAX_TO_KEEP`` kept, as
  orbax's ``max_to_keep=3``; orbax checkpoints are not read.
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import NamedTuple

import numpy as np
import torch

from tpu_rt_torch.core.types import FlatBVH, Hits, Rays
from tpu_rt_torch.diff.shading import render_image_diff
from tpu_rt_torch.trace.wavefront import device_bvh

MAX_TO_KEEP = 3
_CKPT = re.compile(r"step_(\d+)\.pt")


class TrainState(NamedTuple):
    step: int
    vtx_pos: torch.Tensor       # [V,3] f32 (optimized)
    tri_material: torch.Tensor  # [T,4] f32 (optimized)
    opt_state: dict             # Adam's per-parameter state ("state" of its state_dict)


def make_optimizer(params, lr: float = 1e-2) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_state(vtx_pos, tri_material, lr: float = 1e-2, device="cuda") -> TrainState:
    """Step 0 from numpy arrays or tensors, on ``device``."""
    vp, mat = _f32(vtx_pos, device), _f32(tri_material, device)
    return TrainState(step=0, vtx_pos=vp, tri_material=mat,
                      opt_state=make_optimizer([vp, mat], lr).state_dict()["state"])


def _copy_state(opt_state: dict) -> dict:
    return {k: {n: v.clone() if isinstance(v, torch.Tensor) else v for n, v in s.items()}
            for k, s in opt_state.items()}


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms for the block, then the setting the
    caller had."""
    was, warn_only = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def train_step(state: TrainState, flat, rays: Rays, tri_vtx_index, target,
               lr: float = 1e-2, raw: Hits | None = None) -> tuple:
    """One pure optimization step: render -> L2 image loss -> Adam.
    Returns (new_state, loss).  Traversal routing is discrete (see
    diff/tracer.py) so gradients flow through the hit recompute only;
    ``raw`` is the routing, as in ``render_image_diff``."""
    vp = state.vtx_pos.detach().clone().requires_grad_(True)
    mat = state.tri_material.detach().clone().requires_grad_(True)
    opt = make_optimizer([vp, mat], lr)
    if state.opt_state:
        opt.load_state_dict({"state": _copy_state(state.opt_state),
                             "param_groups": opt.state_dict()["param_groups"]})
    rgb = render_image_diff(flat, rays, vp, tri_vtx_index, mat, raw)
    loss = torch.mean((rgb - target) ** 2)
    with _deterministic():
        loss.backward()
    opt.step()
    return TrainState(step=state.step + 1, vtx_pos=vp.detach(), tri_material=mat.detach(),
                      opt_state=opt.state_dict()["state"]), loss.detach()


def _checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    found = ((_CKPT.fullmatch(f), f) for f in os.listdir(ckpt_dir))
    return sorted((int(m.group(1)), os.path.join(ckpt_dir, f)) for m, f in found if m)


def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    """Write ``step_<n>.pt`` atomically and keep the newest MAX_TO_KEEP."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"step": state.step, "vtx_pos": state.vtx_pos,
                "tri_material": state.tri_material, "opt_state": state.opt_state}, tmp)
    os.replace(tmp, path)
    for _, old in _checkpoints(ckpt_dir)[:-MAX_TO_KEEP]:
        os.remove(old)


def restore_checkpoint(ckpt_dir: str, template: TrainState):
    """Latest checkpoint as a TrainState on the template's device, or None
    if none exists.  Adam's step counters stay on the CPU, where Adam
    keeps them."""
    found = _checkpoints(ckpt_dir)
    if not found:
        return None
    ck = torch.load(found[-1][1], map_location="cpu", weights_only=True)
    dev = template.vtx_pos.device
    opt_state = {k: {n: v if n == "step" or not isinstance(v, torch.Tensor) else v.to(dev)
                     for n, v in s.items()} for k, s in ck["opt_state"].items()}
    return TrainState(step=int(ck["step"]), vtx_pos=ck["vtx_pos"].to(dev),
                      tri_material=ck["tri_material"].to(dev), opt_state=opt_state)


def _device_flat(flat, device):
    if flat is None:
        return None
    if isinstance(flat.nodes, np.ndarray):
        return device_bvh(flat, device)
    return FlatBVH(*(x.to(device) for x in flat))


def fit(flat, rays: Rays, tri_vtx_index, target, vtx_pos, tri_material,
        steps: int, lr: float = 1e-2, ckpt_dir: str | None = None,
        save_every: int = 0, raw: Hits | None = None, device="cuda") -> tuple:
    """Run (or resume) the optimization for ``steps`` TOTAL steps on
    ``device``; arrays may be numpy or tensors, ``flat`` a host FlatBVH or
    one from ``device_bvh`` (unused when ``raw`` routes).

    With ckpt_dir set, restores the latest checkpoint first and saves
    every ``save_every`` steps (and at the end), so a killed run resumes
    where it stopped.  Returns (state, losses list for the steps run
    in this call)."""
    dev = torch.device(device)
    flat = _device_flat(flat, dev)
    rays = Rays(*(_f32(x, dev) for x in rays))
    tvi = torch.as_tensor(tri_vtx_index, dtype=torch.int32, device=dev)
    target = _f32(target, dev)
    if raw is not None:
        raw = Hits(*(x.to(dev) for x in raw))
    state = init_state(vtx_pos, tri_material, lr, dev)
    if ckpt_dir is not None:
        restored = restore_checkpoint(ckpt_dir, state)
        if restored is not None:
            state = restored
    losses = []
    while state.step < steps:
        state, loss = train_step(state, flat, rays, tvi, target, lr=lr, raw=raw)
        losses.append(float(loss))
        if ckpt_dir is not None and save_every and state.step % save_every == 0:
            save_checkpoint(ckpt_dir, state)
    if ckpt_dir is not None and (not save_every or state.step % save_every):
        save_checkpoint(ckpt_dir, state)
    return state, losses
