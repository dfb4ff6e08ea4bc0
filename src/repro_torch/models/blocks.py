"""Per-family layer blocks with a uniform interface (the port of
``repro/models/blocks.py``).

* ``spec(cfg)``                          — ParamSpec tree for ONE layer
* ``apply(w, x, mem, ctx, cfg)``         — full-seq forward -> (x', aux)
* ``decode(w, x, cache, mem, ctx, cfg)`` — one step -> (x', cache), the
  cache updated in place (KV slots and recurrent state alike)
* ``cache_spec(cfg, batch, live)``       — per-layer decode cache specs

``mem`` is the cross-attention memory (whisper's decoder: the encoder's
normed output), None elsewhere; the L2L engine takes each layer's vjp
with respect to (w, x, mem).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamSpec, apply_norm, norm_spec
from repro_torch.models.mlp import mlp_apply, mlp_spec
from repro_torch.models.moe import moe_apply, moe_spec


class Ctx(NamedTuple):
    positions: Optional[Any] = None       # (B,S) int32
    mem_positions: Optional[Any] = None   # (B,Sm) int32 (cross-attention)
    cur_pos: Optional[Any] = None         # scalar or per-row (decode)
    window: int = 0                       # sliding window (0 = full)
    causal: bool = True


def _norm(w, x, cfg):
    return apply_norm(w, x, cfg.norm_eps)


# ===========================================================================
# Dense decoder block (granite / bert / command-r style parallel block)
# ===========================================================================
def dense_spec(cfg) -> dict:
    spec = {"ln1": norm_spec(cfg), "attn": attn.gqa_spec(cfg),
            "mlp": mlp_spec(cfg)}
    if not cfg.parallel_block:
        spec["ln2"] = norm_spec(cfg)
    return spec


def dense_apply(w, x, mem, ctx: Ctx, cfg, tp=None):
    """``tp``: the model axis (``distributed.tensor_parallel``), its
    split heads and ffn columns, or None."""
    if cfg.parallel_block:      # command-r: attn ∥ mlp off one norm
        h = _norm(w["ln1"], x, cfg)
        a = attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=ctx.causal, window=ctx.window, tp=tp)
        m = mlp_apply(w["mlp"], h, cfg, tp)
        return x + a + m, 0.0
    h = _norm(w["ln1"], x, cfg)
    x = x + attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=ctx.causal, window=ctx.window, tp=tp)
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg, tp)
    return x, 0.0


def dense_decode(w, x, cache, mem, ctx: Ctx, cfg, tp=None):
    if cfg.parallel_block:
        h = _norm(w["ln1"], x, cfg)
        a, cache = attn.decode_self_attention(w["attn"], h, cache, cfg,
                                              ctx.cur_pos, window=ctx.window,
                                              tp=tp)
        m = mlp_apply(w["mlp"], h, cfg, tp)
        return x + a + m, cache
    h = _norm(w["ln1"], x, cfg)
    a, cache = attn.decode_self_attention(w["attn"], h, cache, cfg,
                                          ctx.cur_pos, window=ctx.window,
                                          tp=tp)
    x = x + a
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg, tp)
    return x, cache


def dense_cache_spec(cfg, batch, live, tp=None):
    return attn.kv_cache_spec(cfg, batch, live, tp)


# ===========================================================================
# MoE block (grok) and MLA + MoE block (deepseek-v2)
# ===========================================================================
def moe_block_spec(cfg, dense_ffn: bool = False) -> dict:
    a_spec = attn.mla_spec(cfg) if cfg.use_mla else attn.gqa_spec(cfg)
    ffn = (mlp_spec(cfg, cfg.d_ff_dense or cfg.d_ff) if dense_ffn
           else moe_spec(cfg))
    return {"ln1": norm_spec(cfg), "attn": a_spec, "ln2": norm_spec(cfg),
            "ffn": ffn}


def moe_block_apply(w, x, mem, ctx: Ctx, cfg, tp=None, dp=None):
    """``tp``: the model axis (split heads, experts or expert columns,
    ffn columns); ``dp``: the data axes the MoE's router statistics and
    dispatch range over (None: this call's rows are the whole batch)."""
    h = _norm(w["ln1"], x, cfg)
    if cfg.use_mla:
        a = attn.mla_attention(w["attn"], h, cfg, ctx.positions,
                               causal=ctx.causal, window=ctx.window, tp=tp)
    else:
        a = attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=ctx.causal, window=ctx.window, tp=tp)
    x = x + a
    h2 = _norm(w["ln2"], x, cfg)
    if "router" in w["ffn"]:
        y, aux = moe_apply(w["ffn"], h2, cfg, tp, dp)
    else:
        y, aux = mlp_apply(w["ffn"], h2, cfg, tp), 0.0
    return x + y, aux


def moe_block_decode(w, x, cache, mem, ctx: Ctx, cfg, tp=None, dp=None):
    h = _norm(w["ln1"], x, cfg)
    if cfg.use_mla:
        a, cache = attn.decode_mla_attention(w["attn"], h, cache, cfg,
                                             ctx.cur_pos, window=ctx.window,
                                             tp=tp)
    else:
        a, cache = attn.decode_self_attention(w["attn"], h, cache, cfg,
                                              ctx.cur_pos, window=ctx.window,
                                              tp=tp)
    x = x + a
    h2 = _norm(w["ln2"], x, cfg)
    if "router" in w["ffn"]:
        # the aux is dropped: no router statistics over the data axes
        y, _ = moe_apply(w["ffn"], h2, cfg, tp, dp, stats=False)
    else:
        y = mlp_apply(w["ffn"], h2, cfg, tp)
    return x + y, cache


def _write_state(cache, new):
    """Recurrent state into the cache's own tensors, in place (the stacked
    cache's layer view, or the serve tick's slot view): the reference
    returns a new cache; here the step's caller keeps the one it gave."""
    for k, v in new.items():
        cache[k].copy_(v)


# ===========================================================================
# Hybrid block (hymba: parallel attention + mamba heads)
# ===========================================================================
def hybrid_spec(cfg) -> dict:
    return {"ln1": norm_spec(cfg), "attn": attn.gqa_spec(cfg),
            "mamba": ssm_mod.mamba_spec(cfg),
            "beta_a": ParamSpec((cfg.d_model,), ("d_model",), "ones"),
            "beta_s": ParamSpec((cfg.d_model,), ("d_model",), "ones"),
            "ln2": norm_spec(cfg), "mlp": mlp_spec(cfg)}


def hybrid_apply(w, x, mem, ctx: Ctx, cfg, tp=None):
    """``tp``: the model axis.  Attention, mamba and the MLP each take
    their own split (attention whole when its heads do not divide);
    ``copy_in`` sits at each split branch's input, never on the shared
    ``h``, so the whole attention's input gradient is not summed."""
    h = _norm(w["ln1"], x, cfg)
    a = attn.self_attention(w["attn"], h, cfg, ctx.positions,
                            causal=ctx.causal, window=ctx.window, tp=tp)
    s = ssm_mod.mamba_apply(w["mamba"], h, cfg, tp)
    fused = 0.5 * (a * w["beta_a"].to(x.dtype)
                   + s * w["beta_s"].to(x.dtype))
    x = x + fused
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg, tp)
    return x, 0.0


def hybrid_decode(w, x, cache, mem, ctx: Ctx, cfg, tp=None):
    h = _norm(w["ln1"], x, cfg)
    a, _ = attn.decode_self_attention(w["attn"], h, cache["kv"], cfg,
                                      ctx.cur_pos, window=ctx.window, tp=tp)
    s, st = ssm_mod.mamba_decode(w["mamba"], h, cache["ssm"], cfg, tp)
    _write_state(cache["ssm"], st)
    fused = 0.5 * (a * w["beta_a"].to(x.dtype)
                   + s * w["beta_s"].to(x.dtype))
    x = x + fused
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg, tp)
    return x, cache


def hybrid_cache_spec(cfg, batch, live, tp=None):
    return {"kv": attn.kv_cache_spec(cfg, batch, live, tp),
            "ssm": ssm_mod.mamba_state_spec(cfg, batch, tp)}


# ===========================================================================
# RWKV6 block (attention-free)
# ===========================================================================
def rwkv_spec(cfg) -> dict:
    return {"ln1": norm_spec(cfg), **ssm_mod.rwkv6_spec(cfg),
            "ln2": norm_spec(cfg)}


def rwkv_apply(w, x, mem, ctx: Ctx, cfg, tp=None):
    y, _ = ssm_mod.rwkv6_time_mix(w["tm"], _norm(w["ln1"], x, cfg), cfg,
                                  tp=tp)
    x = x + y
    y, _ = ssm_mod.rwkv6_channel_mix(w["cm"], _norm(w["ln2"], x, cfg),
                                     tp=tp)
    return x + y, 0.0


def rwkv_decode(w, x, cache, mem, ctx: Ctx, cfg, tp=None):
    tm_state = {"wkv": cache["wkv"], "shift": cache["tm_shift"]}
    y, tm_new = ssm_mod.rwkv6_time_mix(w["tm"], _norm(w["ln1"], x, cfg),
                                       cfg, state=tm_state, tp=tp)
    x = x + y
    y, cm_new = ssm_mod.rwkv6_channel_mix(
        w["cm"], _norm(w["ln2"], x, cfg), state={"shift": cache["cm_shift"]},
        tp=tp)
    x = x + y
    # copy_ rounds to the cache's dtype, as the reference's astype
    _write_state(cache, {"wkv": tm_new["wkv"], "tm_shift": tm_new["shift"],
                         "cm_shift": cm_new["shift"]})
    return x, cache


def rwkv_cache_spec(cfg, batch, live, tp=None):
    return ssm_mod.rwkv6_state_spec(cfg, batch, tp)


# ===========================================================================
# Whisper encoder / decoder blocks (layernorm, biased projections, gelu)
# ===========================================================================
def whisper_enc_spec(cfg) -> dict:
    return {"ln1": norm_spec(cfg), "attn": attn.gqa_spec(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_spec(cfg)}


def whisper_enc_apply(w, x, mem, ctx: Ctx, cfg, tp=None):
    """``tp``: the model axis, its split heads and ffn columns, or None."""
    h = _norm(w["ln1"], x, cfg)
    x = x + attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=False, rope=False, tp=tp)
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg, tp)
    return x, 0.0


def whisper_dec_spec(cfg) -> dict:
    return {"ln1": norm_spec(cfg), "attn": attn.gqa_spec(cfg),
            "ln_x": norm_spec(cfg), "xattn": attn.gqa_spec(cfg),
            "ln2": norm_spec(cfg), "mlp": mlp_spec(cfg)}


def whisper_dec_apply(w, x, mem, ctx: Ctx, cfg, tp=None):
    """``tp``: as in ``whisper_enc_apply``; the cross-attention takes the
    rank's heads of the whole (replicated) ``mem``."""
    h = _norm(w["ln1"], x, cfg)
    x = x + attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=True, rope=False, tp=tp)
    h = _norm(w["ln_x"], x, cfg)
    x = x + attn.cross_attention(w["xattn"], h, mem, cfg, ctx.positions,
                                 ctx.mem_positions, tp)
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg, tp)
    return x, 0.0


def whisper_dec_decode(w, x, cache, mem, ctx: Ctx, cfg, tp=None):
    """Self-attention against the ring cache (written in place);
    cross-attention against the encoder's K/V, projected once before the
    first step (``core.decode.encode_cross_kv``) into the cache's ``xk`` /
    ``xv``.  ``tp``: the rank's q heads against the kv heads its cache
    holds, summed over the group."""
    dt = x.dtype
    h = _norm(w["ln1"], x, cfg)
    a, _ = attn.decode_self_attention(w["attn"], h, cache["kv"], cfg,
                                      ctx.cur_pos, window=ctx.window,
                                      rope=False, tp=tp)
    x = x + a
    h = _norm(w["ln_x"], x, cfg)
    q = attn._proj(h, w["xattn"]["wq"])
    if "bq" in w["xattn"]:
        q = q + w["xattn"]["bq"].to(dt)
    B, Sm = x.shape[0], cache["xk"].shape[1]
    pos = attn.decode_positions(x, ctx.cur_pos)
    mpos = torch.arange(Sm, dtype=torch.int32, device=x.device).expand(B, Sm)
    g = q.shape[2] // cache["xk"].shape[2]
    o = attn.attend(q, attn.expand_kv(cache["xk"].to(dt), g),
                    attn.expand_kv(cache["xv"].to(dt), g),
                    pos, mpos, causal=False, chunk=0)
    x = x + attn.out_project(w["xattn"], o, tp)
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg, tp)
    return x, cache


def whisper_dec_cache_spec(cfg, batch, live, tp=None):
    """The self-attention ring and the cross-attention K/V, each on the kv
    heads this rank computes with (``tp.local_kv_heads()``)."""
    KV = cfg.n_kv_heads if tp is None else tp.local_kv_heads()
    Dh = cfg.d_head
    return {
        "kv": attn.kv_cache_spec(cfg, batch, live, tp),
        "xk": ParamSpec((batch, cfg.n_frames, KV, Dh),
                        ("batch", "seq", "kv", "head_dim"), "zeros"),
        "xv": ParamSpec((batch, cfg.n_frames, KV, Dh),
                        ("batch", "seq", "kv", "head_dim"), "zeros"),
    }
