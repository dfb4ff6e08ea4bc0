"""Serving: one-token decode steps against per-layer KV caches (the port
of ``repro/core/decode.py``).

With ``weight_stream`` the model rests in pinned host memory and every
decode step relays the layer stack through HBM one slot at a time — the
paper's constant device footprint, applied to inference.  Caches are
updated IN PLACE: a step writes each layer's new k/v/pos into the stacked
cache tensors it was given (the reference returns new caches).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.eps import EPSPlacements, make_placements
from repro_torch.core.relay import Stream, relay_scan
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.models.common import is_spec


def make_serve_step(model, exec_cfg: ExecutionConfig,
                    placements: Optional[EPSPlacements] = None,
                    device="cpu", copy_stream=None) -> Callable:
    """Returns serve_step(params, caches, token, cur_pos) -> (logits,
    caches).  ``caches``: tuple over decode groups of stacked per-layer
    cache trees (updated in place and returned); ``token``: (B, T) int
    tensor on the device; ``cur_pos``: a Python int (T = 1) or per-row
    (B,)/(B,T) positions (negative = padding rows, no cache write)."""
    assert not exec_cfg.dynamic_depth, "dynamic depth is not ported yet"
    if placements is None:
        placements = make_placements(exec_cfg, len(model.groups), device)
    dgroups = model.decode_groups()
    gidx = [i for i, g in enumerate(model.groups) if not g.is_encoder]

    def serve_step(params, caches, token, cur_pos):
        static = {"embed": params["embed"], "head": params["head"]}
        x = model.decode_embed(static, token, cur_pos)
        ctx = model.decode_ctx(cur_pos, window=exec_cfg.decode_window)
        for di, group in enumerate(dgroups):
            def body(x_c, slots, cache_l, _g=group):
                (w,) = slots
                if exec_cfg.pack_params:
                    w = packing.unpack(w)
                x2, _ = _g.decode(w, x_c, cache_l, None, ctx)
                return x2, None

            x, _ = relay_scan(
                body, x, (Stream(placements.weights[gidx[di]],
                                 params["groups"][gidx[di]]),),
                xs=caches[di], group=exec_cfg.layers_per_relay,
                prefetch=exec_cfg.prefetch_depth,
                transport=exec_cfg.transport, device=device,
                copy_stream=copy_stream)
        return model.decode_logits(static, x), caches

    return serve_step


def init_caches(model, batch: int, live_seq: int, device="cpu", dtype=None):
    """The stacked decode caches: k/v zeros in the compute dtype, position
    slots int32 starting at -1 (invalid)."""
    dtype = dtype or model.dtype()

    def build(t, name=None):
        if is_spec(t):
            if name == "pos":
                return torch.full(t.shape, -1, dtype=torch.int32,
                                  device=device)
            return torch.zeros(t.shape, dtype=dtype, device=device)
        return {k: build(v, k) for k, v in t.items()}

    return tuple(build(spec) for spec in model.cache_specs(batch, live_seq))


def prefill(model, params, tokens, live_seq: int,
            exec_cfg: Optional[ExecutionConfig] = None, placements=None,
            device="cpu", copy_stream=None):
    """Build caches by feeding the prompt one token at a time through
    ``serve_step``.  Returns (caches, last_logits (B, V))."""
    exec_cfg = exec_cfg or ExecutionConfig()
    B, S = tokens.shape
    caches = init_caches(model, B, live_seq, device)
    serve = make_serve_step(model, exec_cfg, placements, device, copy_stream)
    logits = None
    for i in range(S):
        logits, caches = serve(params, caches, tokens[:, i:i + 1], i)
    return caches, logits[:, 0]
