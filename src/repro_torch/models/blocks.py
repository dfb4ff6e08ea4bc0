"""Per-family layer blocks with a uniform interface (the port of
``repro/models/blocks.py``: the dense and MoE families so far).

* ``spec(cfg)``                          — ParamSpec tree for ONE layer
* ``apply(w, x, mem, ctx, cfg)``         — full-seq forward -> (x', aux)
* ``decode(w, x, cache, mem, ctx, cfg)`` — one step -> (x', cache), the
  cache updated in place
* ``cache_spec(cfg, batch, live)``       — per-layer decode cache specs
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

from repro_torch.models import attention as attn
from repro_torch.models.common import apply_norm, norm_spec
from repro_torch.models.mlp import mlp_apply, mlp_spec
from repro_torch.models.moe import moe_apply, moe_spec


class Ctx(NamedTuple):
    positions: Optional[Any] = None       # (B,S) int32
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


def dense_apply(w, x, mem, ctx: Ctx, cfg):
    if cfg.parallel_block:      # command-r: attn ∥ mlp off one norm
        h = _norm(w["ln1"], x, cfg)
        a = attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=ctx.causal, window=ctx.window)
        m = mlp_apply(w["mlp"], h, cfg)
        return x + a + m, 0.0
    h = _norm(w["ln1"], x, cfg)
    x = x + attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=ctx.causal, window=ctx.window)
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg)
    return x, 0.0


def dense_decode(w, x, cache, mem, ctx: Ctx, cfg):
    if cfg.parallel_block:
        h = _norm(w["ln1"], x, cfg)
        a, cache = attn.decode_self_attention(w["attn"], h, cache, cfg,
                                              ctx.cur_pos, window=ctx.window)
        m = mlp_apply(w["mlp"], h, cfg)
        return x + a + m, cache
    h = _norm(w["ln1"], x, cfg)
    a, cache = attn.decode_self_attention(w["attn"], h, cache, cfg,
                                          ctx.cur_pos, window=ctx.window)
    x = x + a
    x = x + mlp_apply(w["mlp"], _norm(w["ln2"], x, cfg), cfg)
    return x, cache


def dense_cache_spec(cfg, batch, live):
    return attn.kv_cache_spec(cfg, batch, live)


# ===========================================================================
# MoE block (grok) and MLA + MoE block (deepseek-v2)
# ===========================================================================
def moe_block_spec(cfg, dense_ffn: bool = False) -> dict:
    a_spec = attn.mla_spec(cfg) if cfg.use_mla else attn.gqa_spec(cfg)
    ffn = (mlp_spec(cfg, cfg.d_ff_dense or cfg.d_ff) if dense_ffn
           else moe_spec(cfg))
    return {"ln1": norm_spec(cfg), "attn": a_spec, "ln2": norm_spec(cfg),
            "ffn": ffn}


def moe_block_apply(w, x, mem, ctx: Ctx, cfg):
    h = _norm(w["ln1"], x, cfg)
    if cfg.use_mla:
        a = attn.mla_attention(w["attn"], h, cfg, ctx.positions,
                               causal=ctx.causal, window=ctx.window)
    else:
        a = attn.self_attention(w["attn"], h, cfg, ctx.positions,
                                causal=ctx.causal, window=ctx.window)
    x = x + a
    h2 = _norm(w["ln2"], x, cfg)
    if "router" in w["ffn"]:
        y, aux = moe_apply(w["ffn"], h2, cfg)
    else:
        y, aux = mlp_apply(w["ffn"], h2, cfg), 0.0
    return x + y, aux


def moe_block_decode(w, x, cache, mem, ctx: Ctx, cfg):
    h = _norm(w["ln1"], x, cfg)
    if cfg.use_mla:
        a, cache = attn.decode_mla_attention(w["attn"], h, cache, cfg,
                                             ctx.cur_pos, window=ctx.window)
    else:
        a, cache = attn.decode_self_attention(w["attn"], h, cache, cfg,
                                              ctx.cur_pos, window=ctx.window)
    x = x + a
    h2 = _norm(w["ln2"], x, cfg)
    if "router" in w["ffn"]:
        y, _ = moe_apply(w["ffn"], h2, cfg)
    else:
        y = mlp_apply(w["ffn"], h2, cfg)
    return x + y, cache
