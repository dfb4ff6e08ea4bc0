"""EPS placement construction for engines (the port of
``repro/engine/placement.py``).

With no mesh the placements come straight from
``repro_torch.core.eps.make_placements``; on a mesh this derives the
per-layer-slice pspecs from the model's param specs and hands them to the
same ``make_placements``.
"""
from __future__ import annotations

import torch

from repro_torch.core.eps import EPSPlacements, make_placements, pspecs_like
from repro_torch.core.tree import tree_map
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import is_spec
from repro_torch.optim import adam


def placements_for(model, exec_cfg, mesh=None, rules=None, optimizer=None,
                   device="cpu") -> EPSPlacements:
    """The per-group weight / optimizer / stash placements of one engine.

    With no mesh: the single-device placements.  On a mesh the per-slice
    pspecs come from the model's param specs and the sharding ``rules``
    (the production train rules of the config when None).  The same
    per-slice placements serve every relay schedule (the prefetch ring,
    G-layer stops): only how many slices are in HBM at once changes.

    With ``exec_cfg.pack_params`` the relayed trees are ``packing.Packed``
    flat rows, which cannot take the per-leaf tensor-parallel specs: the
    packed rows are replicated (P()), and the stash is split over the
    batch axes (P(None, batch)) as it is unpacked.  Unpacked, each model
    rank's rows are its blocks of the leaves these pspecs split (its
    pinned EPS holds 1/M of their bytes, the other leaves whole), and K4
    fetches and writes back those rows.
    """
    n = len(model.groups)
    if mesh is None:
        return make_placements(exec_cfg, n, device)
    if rules is None:
        rules = shd.make_rules(model.cfg, mesh, kind="train")
    stash = shd.P(None, rules.get("batch"))
    if exec_cfg.pack_params:
        return make_placements(exec_cfg, n, device, mesh=mesh,
                               weight_pspecs=(shd.P(),) * n,
                               opt_pspecs=(shd.P(),) * n, stash_pspec=stash)
    optimizer = optimizer or adam()
    slice_pspecs = shd.layer_slice_pspecs(model, mesh, rules)
    opt_slice_pspecs = []
    for gi, g in enumerate(model.groups):
        # the optimizer's slots of one layer, as shapes only
        layer = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                         g.spec, is_leaf=is_spec)
        opt_slice_pspecs.append(pspecs_like(slice_pspecs[gi],
                                            optimizer.init(layer)))
    return make_placements(exec_cfg, n, device, mesh=mesh,
                           weight_pspecs=slice_pspecs,
                           opt_pspecs=tuple(opt_slice_pspecs),
                           stash_pspec=stash)
