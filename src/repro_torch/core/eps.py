"""Eager Param-Server (EPS) placement: device HBM <- pinned host memory.

The reference's two in-jit tiers are XLA memory spaces that the CPU
backend drops (``repro/core/eps.py:54-66``).  On an H100 the port makes
them physical: with ``weight_stream`` the stacked layer groups rest in
PINNED host memory and every relay stop copies one slot of them into HBM
through the relay-copy kernel (``core.relay``), so the device holds only
the G·(1 + k) slots in flight plus the embedding and head.

A ``Placement`` bundles two moves for one stream:

* ``host(tree)`` — where the stacked stream rests between uses: pinned
  host memory when streaming, else the compute device;
* ``dev(tree)``  — onto the compute device.

On the CPU both are the identity, as the reference's are there.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_map


class Placement(NamedTuple):
    host: Callable                           # tree -> tree (resting place)
    dev: Callable                            # tree -> tree (compute device)
    enabled: bool = True


def noop_placement() -> Placement:
    ident = lambda t: t
    return Placement(ident, ident, enabled=False)


def _pin(a):
    if a.device.type == "cpu" and a.is_pinned():
        return a
    out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    return out.copy_(a)


def single_device_placement(device, stream: bool) -> Placement:
    """One CUDA device; ``stream`` puts the resting copy in pinned host
    memory (the EPS), otherwise on the device itself."""
    device = torch.device(device)
    dev = lambda t: tree_map(lambda a: a.to(device), t)
    host = (lambda t: tree_map(_pin, t)) if stream else dev
    return Placement(host, dev, enabled=stream)


class EPSPlacements(NamedTuple):
    """Per-use-site placements: ``weights[g]`` for layer group g's stream
    (``opts`` and ``stash`` are training's and come with it)."""
    weights: tuple


def make_placements(exec_cfg, n_groups: int, device="cpu") -> EPSPlacements:
    """Single-device placements (no mesh yet).  On the CPU every move is
    the identity; on CUDA the groups rest in pinned host memory when
    ``exec_cfg.weight_stream``, else on the device."""
    device = torch.device(device)
    if device.type != "cuda":
        return EPSPlacements((noop_placement(),) * n_groups)
    p = single_device_placement(device, exec_cfg.weight_stream)
    return EPSPlacements((p,) * n_groups)
