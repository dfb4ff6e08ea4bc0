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

Training adds two use sites: ``opts[g]``, where group g's optimizer slots
rest (beside its weights: pinned host memory when ``weight_stream``, and
always with ``host_optimizer``, whose update runs on the host), and
``stash``, where the boundary activations rest between the forward and
the backward (pinned host memory when ``offload_stash``, the paper's
eq. (4) constant device memory; ``eps.py:174-181`` of the reference).

``disk`` extends the chain one tier further down (``tiers=3``): the
static ``TierChainSpec`` of the verified segment store, from which the
Engine builds its ``core.tierstore.TierChain``; None for two tiers.
With the disk tier the groups' pinned rows are ``owned``: blocks of
their own (``kernels.host_alloc``) that go back to the system when the
last view of them dies, where PyTorch's host allocator would keep them
pinned for reuse, and with them the host memory the tier frees between
calls.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.tree import (tree_flatten_up_to, tree_leaves,
                                   tree_map, tree_unflatten_like)
from repro_torch.distributed.sharding import P, is_pspec
from repro_torch.kernels import host_alloc, relay_copy


class Placement(NamedTuple):
    host: Callable                           # tree -> tree (resting place)
    dev: Callable                            # tree -> tree (compute device)
    enabled: bool = True
    owned: bool = False                      # pinned blocks of their own
    pspec: object = None                     # on a mesh: the slot's pspecs


def noop_placement() -> Placement:
    ident = lambda t: t
    return Placement(ident, ident, enabled=False)


def pinned_empty(shape, dtype, owned: bool = False) -> torch.Tensor:
    """Uninitialized pinned host memory: from PyTorch's caching host
    allocator, or with ``owned`` a block of its own (``cudaHostAlloc``)
    freed when its last view dies."""
    if owned:
        return host_alloc.empty(shape, dtype, kind="mapped")
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _pin(a, owned: bool = False):
    if a.device.type == "cpu" and a.is_pinned():
        return a
    # the host allocator may hand out a block that a kernel still reads or
    # writes (the relay's kernels address pinned memory directly, so the
    # allocator records no use of it): wait for the card before the host
    # writes into a fresh block
    torch.cuda.synchronize()
    out = pinned_empty(a.shape, a.dtype, owned)
    if a.device.type != "cuda" or not a.numel():
        return out.copy_(a)
    # a device tensor goes out through K4's write-back (current stream)
    relay_copy.writeback_rows(a.contiguous().reshape(-1), out.view(1, -1), 0)
    return out


def single_device_placement(device, stream: bool,
                            owned: bool = False) -> Placement:
    """One CUDA device; ``stream`` puts the resting copy in pinned host
    memory (the EPS; blocks of its own when ``owned``), otherwise on the
    device itself."""
    device = torch.device(device)
    dev = lambda t: tree_map(lambda a: a.to(device), t)
    host = (lambda t: tree_map(lambda a: _pin(a, owned), t)) if stream \
        else dev
    return Placement(host, dev, enabled=stream, owned=stream and owned)


class TierChainSpec(NamedTuple):
    """Static config of the third (disk) tier, HBM <- pinned host <- this:
    built from an ExecutionConfig by ``tier_spec``; the Engine turns it
    into a live ``core.tierstore.SegmentStore`` and ``TierChain``.  Host
    file I/O around each call, so it works on every device."""
    host_budget: int         # resident stacked-state bytes (0: demote all)
    directory: str           # segment-store root ("": a fresh temp dir)
    retries: int             # transient-read retry budget
    backoff_s: float         # first exponential-backoff delay


def tier_spec(exec_cfg) -> Optional[TierChainSpec]:
    """The disk-tier spec of an ExecutionConfig, or None for the two-tier
    placement (``tiers=2``)."""
    if exec_cfg.tiers < 3:
        return None
    return TierChainSpec(host_budget=int(exec_cfg.host_budget_bytes),
                         directory=str(exec_cfg.tier_dir),
                         retries=int(exec_cfg.tier_retries),
                         backoff_s=float(exec_cfg.tier_backoff_s))


class EPSPlacements(NamedTuple):
    """Per-use-site placements: ``weights[g]`` / ``opts[g]`` for layer
    group g's weights and optimizer slots, ``stash`` for the boundary
    activations, ``disk`` the third tier's spec (None: two tiers)."""
    weights: tuple
    opts: tuple
    stash: Placement
    disk: Optional[TierChainSpec] = None


def pspecs_like(pspec_tree, target_tree):
    """Broadcast a param-shaped pspec tree onto a state tree whose leaves
    replace each param leaf with a subtree of same-shaped arrays (Adam's
    m / v): every array of a param's subtree takes the param's pspec."""
    flat_p = tree_leaves(pspec_tree, is_leaf=is_pspec)
    flat_t = tree_flatten_up_to(pspec_tree, target_tree, is_pspec)
    out = [tree_map(lambda _, _p=p: _p, t) for p, t in zip(flat_p, flat_t)]
    return tree_unflatten_like(pspec_tree, out, is_leaf=is_pspec)


def make_placements(exec_cfg, n_groups: int, device="cpu", mesh=None,
                    weight_pspecs=None, opt_pspecs=None,
                    stash_pspec=None) -> EPSPlacements:
    """Per-device placements.  On the CPU every move is the identity; on
    CUDA the groups rest in pinned host memory when
    ``exec_cfg.weight_stream``, their optimizer slots then and whenever
    ``exec_cfg.host_optimizer``, the stash when ``exec_cfg.offload_stash``,
    else on the device.  ``disk`` is ``tier_spec(exec_cfg)`` on every
    device; with it the groups' pinned rows are owned.

    On a mesh each placement also carries the pspecs of what it moves:
    ``weight_pspecs[g]`` / ``opt_pspecs[g]`` for one relay slot of group g,
    ``stash_pspec`` for the stash (P() when None).  Each rank moves its
    own part (its rows of a batch-sharded stash, its blocks of the leaves
    a pspec splits over "model"; a replicated slot whole), so the moves
    are the device's own."""
    device = torch.device(device)
    disk = tier_spec(exec_cfg)
    if device.type != "cuda":
        noop = noop_placement()
        ws, os_, st = (noop,) * n_groups, (noop,) * n_groups, noop
    else:
        owned = disk is not None
        w = single_device_placement(device, exec_cfg.weight_stream, owned)
        o = single_device_placement(device, exec_cfg.weight_stream
                                    or exec_cfg.host_optimizer, owned)
        st = single_device_placement(device, exec_cfg.offload_stash)
        ws, os_ = (w,) * n_groups, (o,) * n_groups
    if mesh is not None:
        ws = tuple(p._replace(pspec=weight_pspecs[g])
                   for g, p in enumerate(ws))
        os_ = tuple(p._replace(pspec=opt_pspecs[g])
                    for g, p in enumerate(os_))
        st = st._replace(pspec=stash_pspec if stash_pspec is not None
                         else P())
    return EPSPlacements(ws, os_, st, disk)
