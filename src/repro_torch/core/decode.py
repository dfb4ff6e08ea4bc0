"""Serving: one-token decode steps against per-layer KV caches (the port
of ``repro/core/decode.py``).

With ``weight_stream`` the model rests in pinned host memory and every
decode step relays the layer stack through HBM one slot at a time — the
paper's constant device footprint, applied to inference.  Caches are
updated IN PLACE: a step writes each layer's new k/v/pos, and the
recurrent families' state (mamba's ``h`` and conv window, rwkv's ``wkv``
and token shifts, rounded to the cache dtype), into the stacked cache
tensors it was given (the reference returns new caches).

With ``dynamic_depth`` a step runs the first ``n_active`` layers: the
others leave the hidden state and their cache rows untouched, and their
weights are not fetched.

Whisper (the audio family) decodes its decoder group only: before the
first step ``encode_cross_kv`` runs the encoder once over the frames and
writes each decoder layer's projected cross-attention K/V into its cache,
both passes through the same relay (K4 from pinned host memory).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.eps import EPSPlacements, make_placements
from repro_torch.core.relay import Stream, depth_window, relay_scan
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.models.attention import cross_kv
from repro_torch.models.common import apply_norm, is_spec


def make_serve_step(model, exec_cfg: ExecutionConfig,
                    placements: Optional[EPSPlacements] = None,
                    device="cpu", copy_stream=None) -> Callable:
    """Returns serve_step(params, caches, token, cur_pos[, n_active]) ->
    (logits, caches).  ``caches``: tuple over decode groups of stacked
    per-layer cache trees (updated in place and returned); ``token``:
    (B, T) int tensor on the device; ``cur_pos``: a Python int (T = 1) or
    per-row (B,)/(B,T) positions (negative = padding rows, no cache
    write); ``n_active``: the run depth, with ``dynamic_depth``."""
    if placements is None:
        placements = make_placements(exec_cfg, len(model.groups), device)
    DYN = exec_cfg.dynamic_depth
    if DYN:
        assert len(model.groups) == 1, \
            "dynamic_depth supports single-group models"
    dgroups = model.decode_groups()
    gidx = [i for i, g in enumerate(model.groups) if not g.is_encoder]

    def serve_step(params, caches, token, cur_pos, n_active=None):
        win = depth_window(DYN, n_active, model.groups[0].n_layers)
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
                copy_stream=copy_stream, active=win)
        return model.decode_logits(static, x), caches

    return serve_step


def init_caches(model, batch: int, live_seq: int, device="cpu", dtype=None):
    """The stacked decode caches: k/v and recurrent state zeros in the
    compute dtype (the reference's ``cfg.dtype``: bf16 state is rounded
    after every step), position slots int32 starting at -1 (invalid)."""
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
            device="cpu", copy_stream=None, frames=None, n_layers=None):
    """Build caches by feeding the prompt one token at a time through
    ``serve_step``.  Returns (caches, last_logits (B, V)).  For whisper
    pass ``frames`` (B, n_frames, d): the encoder runs once and its
    projected cross-attention K/V fill the decoder caches first.  With
    ``exec_cfg.dynamic_depth``, ``n_layers`` (default: the capacity) is
    the run depth of every step."""
    exec_cfg = exec_cfg or ExecutionConfig()
    B, S = tokens.shape
    caches = init_caches(model, B, live_seq, device)
    if model.cfg.family == "audio":
        if frames is None:
            raise ValueError("the audio family decodes with frames: pass "
                             "frames (B, n_frames, d_model)")
        encode_cross_kv(model, params, frames, caches, exec_cfg, placements,
                        device, copy_stream)
    serve = make_serve_step(model, exec_cfg, placements, device, copy_stream)
    depth = ()
    if exec_cfg.dynamic_depth:
        cap = sum(g.n_layers for g in model.groups)
        depth = (cap if n_layers is None else n_layers,)
    logits = None
    for i in range(S):
        logits, caches = serve(params, caches, tokens[:, i:i + 1], i, *depth)
    return caches, logits[:, 0]


def encode_cross_kv(model, params, frames, caches,
                    exec_cfg: Optional[ExecutionConfig] = None,
                    placements=None, device="cpu", copy_stream=None):
    """Run whisper's encoder once over ``frames`` and write each decoder
    layer's cross-attention K/V of its output (after ``enc_ln_post``) into
    that layer's ``xk`` / ``xv`` cache rows, in place.  Both passes relay
    their group's rows as every other pass does (K4 from pinned host
    memory; packed rows are unpacked on the device), so the one-shot pass
    fetches each encoder and decoder layer once, plus the prefetch ring's
    clamped re-fetch per group.  On the model axis each rank runs the
    encoder on its heads and writes the kv heads its cache holds.
    Returns ``caches``."""
    exec_cfg = exec_cfg or ExecutionConfig()
    if placements is None:
        placements = make_placements(exec_cfg, len(model.groups), device)
    cfg = model.cfg
    static = {"embed": params["embed"], "head": params["head"]}
    batch = {"frames": frames}
    x, _ = model.prepare(static, batch)
    enc, dec = 0, len(model.groups) - 1
    ctx = model.train_ctx(batch, model.groups[enc])

    def weights(slots):
        (w,) = slots
        return packing.unpack(w) if exec_cfg.pack_params else w

    def relay(body, init, gi, xs=None):
        return relay_scan(body, init, (Stream(placements.weights[gi],
                                              params["groups"][gi]),),
                          xs=xs, group=exec_cfg.layers_per_relay,
                          prefetch=exec_cfg.prefetch_depth,
                          transport=exec_cfg.transport, device=device,
                          copy_stream=copy_stream)

    x, _ = relay(lambda h, slots, _x: (model.groups[enc].apply(
        weights(slots), h, None, ctx)[0], None), x, enc)
    mem = apply_norm(static["embed"]["enc_ln_post"], x, cfg.norm_eps)

    def kv_body(_, slots, cache_l):
        k, v = cross_kv(weights(slots)["xattn"], mem, model.tp)
        cache_l["xk"].copy_(k)
        cache_l["xv"].copy_(v)
        return None, None

    # the decoder is the last group and the only decode group
    relay(kv_body, None, dec, xs=caches[-1])
    return caches
