"""L2L (layer-to-layer) execution — the port of ``repro/core/l2l.py``, so
far its inference forward: the layer-major relay with the microbatch loop
INSIDE each relay stop (the paper's loop inversion), no stash and no
backward.  Training (Alg 3/4) comes with the next slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.eps import EPSPlacements, make_placements
from repro_torch.core.relay import Stream, relay_scan
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_map


def _reshape_ub(tree, ub: int):
    def one(a):
        assert a.shape[0] % ub == 0, \
            f"batch {a.shape[0]} not divisible by n_microbatches {ub}"
        return a.reshape(ub, a.shape[0] // ub, *a.shape[1:])
    return tree_map(one, tree)


def make_prefill_fn(model, exec_cfg: ExecutionConfig,
                    placements: Optional[EPSPlacements] = None,
                    device="cpu", copy_stream=None) -> Callable:
    """Returns prefill(params, batch) -> last-token logits (B, vocab): the
    full prompt forward under the L2L weight relay."""
    assert not exec_cfg.dynamic_depth, "dynamic depth is not ported yet"
    if placements is None:
        placements = make_placements(exec_cfg, len(model.groups), device)
    UB = exec_cfg.n_microbatches

    def prefill(params, batch):
        static = {"embed": params["embed"], "head": params["head"]}
        batch_ub = _reshape_ub(batch, UB)
        ub_batches = [tree_map(lambda a, _u=u: a[_u], batch_ub)
                      for u in range(UB)]
        x_ub = torch.stack([model.prepare(static, b)[0] for b in ub_batches])
        for gi, group in enumerate(model.groups):
            assert gi == 0 and not group.has_mem, \
                "group transitions come with the encoder-decoder family"
            ctx = model.train_ctx(ub_batches[0], group)

            def fwd_body(x_c, slots, _x, _g=group, _ctx=ctx):
                (w,) = slots
                if exec_cfg.pack_params:
                    w = packing.unpack(w)
                return torch.stack([_g.apply(w, x_c[u], None, _ctx)[0]
                                    for u in range(UB)]), None

            x_ub, _ = relay_scan(
                fwd_body, x_ub, (Stream(placements.weights[gi],
                                        params["groups"][gi]),),
                group=exec_cfg.layers_per_relay,
                prefetch=exec_cfg.prefetch_depth,
                transport=exec_cfg.transport, device=device,
                copy_stream=copy_stream)
        logits = [model.decode_logits(static, x_ub[u][:, -1:, :])[:, 0]
                  for u in range(UB)]
        return torch.cat(logits)

    return prefill
