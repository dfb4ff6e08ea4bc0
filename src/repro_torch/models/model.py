"""LayeredModel: the layer-granular model API the L2L engine executes (the
port of ``repro/models/model.py``).

A model is ``prepare`` (embeddings, and the modality stubs: internvl2's
projected patches in front of the tokens, whisper's frames) ->
homogeneous layer groups, each run over a stacked ``(N, ...)`` parameter
tree, joined by a ``transition`` -> the head.  A transition is the
identity for a homogeneous stream (deepseek's dense -> MoE); for
whisper it turns the encoder's output into the decoder's cross-attention
memory (``transition_mem``) and builds the decoder's input from the
target tokens (``transition_x``).  Parameters are nested dicts:
``{"embed": {...}, "head": {...}, "groups": (group, ...)}``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import blocks
from repro_torch.models.blocks import Ctx
from repro_torch.models.common import (ParamSpec, apply_norm, embed_tokens,
                                       init_leaf, init_std, is_spec,
                                       logits_fn, materialize, norm_spec,
                                       softmax_xent, stack_specs)


class Group(NamedTuple):
    name: str
    n_layers: int
    spec: dict                       # one layer's ParamSpec tree
    apply: Callable                  # (w, x, mem, ctx) -> (x, aux)
    decode: Callable                 # (w, x, cache, mem, ctx) -> (x, cache)
    cache_spec: Callable             # (batch, live_seq) -> per-layer spec
    has_mem: bool = False
    is_encoder: bool = False         # not run during decode


def sinusoidal(positions, d: int, dtype):
    """positions: (B,S) -> (B,S,d), the classic sin / cos embedding."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if d % 2:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def _arange(n: int, B: int, device):
    return torch.arange(n, dtype=torch.int32, device=device).expand(B, n)


def stack_layers(layers):
    """Per-layer trees -> one stacked (N, ...) tree."""
    return tree_map(lambda *ls: torch.stack(ls), *layers)


class LayeredModel:
    """``tp`` (a ``distributed.tensor_parallel.TensorParallel``): one rank
    of the mesh's model axis, whose blocks of the split leaves this
    model's functions compute with (every family; internvl2's patch
    projection and whisper's ``enc_ln_post`` stay whole); ``dp``
    (a ``distributed.data_parallel.DataParallel`` of more than one rank):
    the data axes the MoE layers' router statistics and dispatch range
    over.  The specs stay the whole model's."""

    def __init__(self, cfg: ModelConfig, tp=None, dp=None):
        self.cfg = cfg
        self.tp = tp
        self.dp = dp
        self.groups: Tuple[Group, ...] = self._build_groups(cfg, tp, dp)

    @staticmethod
    def _build_groups(cfg, tp=None, dp=None) -> Tuple[Group, ...]:
        def G(name, n, spec, apply_fn, decode_fn, cache_fn, axes=None,
              **kw):
            """``axes``: the mesh groups the family's functions take."""
            m = axes or {}
            ap = lambda w, x, mem, ctx: apply_fn(w, x, mem, ctx, cfg, **m)
            de = lambda w, x, c, mem, ctx: decode_fn(w, x, c, mem, ctx, cfg,
                                                     **m)
            cm = {"tp": m["tp"]} if "tp" in m else {}
            cs = lambda b, live: cache_fn(cfg, b, live, **cm)
            return Group(name, n, spec, ap, de, cs, **kw)

        if cfg.family in ("dense", "vlm"):
            return (G("layers", cfg.n_layers, blocks.dense_spec(cfg),
                      blocks.dense_apply, blocks.dense_decode,
                      blocks.dense_cache_spec, {"tp": tp}),)
        if cfg.family == "moe":
            axes = {"tp": tp, "dp": dp}
            gs = []
            if cfg.first_dense_layers:
                # deepseek-v2: layer 0 keeps MLA attention but a dense FFN
                gs.append(G("dense_layers", cfg.first_dense_layers,
                            blocks.moe_block_spec(cfg, dense_ffn=True),
                            blocks.moe_block_apply, blocks.moe_block_decode,
                            blocks.dense_cache_spec, axes))
            gs.append(G("moe_layers", cfg.n_layers - cfg.first_dense_layers,
                        blocks.moe_block_spec(cfg),
                        blocks.moe_block_apply, blocks.moe_block_decode,
                        blocks.dense_cache_spec, axes))
            return tuple(gs)
        if cfg.family == "hybrid":
            return (G("layers", cfg.n_layers, blocks.hybrid_spec(cfg),
                      blocks.hybrid_apply, blocks.hybrid_decode,
                      blocks.hybrid_cache_spec, {"tp": tp}),)
        if cfg.family == "ssm":
            return (G("layers", cfg.n_layers, blocks.rwkv_spec(cfg),
                      blocks.rwkv_apply, blocks.rwkv_decode,
                      blocks.rwkv_cache_spec, {"tp": tp}),)
        if cfg.family == "audio":
            enc = G("encoder", cfg.n_encoder_layers,
                    blocks.whisper_enc_spec(cfg), blocks.whisper_enc_apply,
                    blocks.whisper_dec_decode, blocks.whisper_dec_cache_spec,
                    {"tp": tp}, is_encoder=True)
            dec = G("decoder", cfg.n_layers, blocks.whisper_dec_spec(cfg),
                    blocks.whisper_dec_apply, blocks.whisper_dec_decode,
                    blocks.whisper_dec_cache_spec, {"tp": tp}, has_mem=True)
            return (enc, dec)
        raise ValueError(f"unknown family {cfg.family}")

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        embed = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "d_model"), "embed")}
        if cfg.family == "audio":
            embed["enc_ln_post"] = norm_spec(cfg)
        if cfg.is_vlm:
            embed["proj_w"] = ParamSpec((cfg.vit_dim, cfg.d_model),
                                        ("lora", "d_model"))
            embed["proj_b"] = ParamSpec((cfg.d_model,), ("d_model",), "zeros")
        head: dict = {"ln_f": norm_spec(cfg)}
        if not cfg.tie_embeddings:
            head["out"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                    ("d_model", "vocab"))
        groups = tuple(stack_specs(g.spec, g.n_layers) for g in self.groups)
        return {"embed": embed, "head": head, "groups": groups}

    def param_dtype(self):
        return getattr(torch, self.cfg.param_dtype)

    def init_static(self, generator, device, dtype=None):
        """(embed, head) drawn first — the start of every init's draws."""
        dtype = dtype or self.param_dtype()
        specs = self.param_specs()
        return (materialize(specs["embed"], generator, device, dtype),
                materialize(specs["head"], generator, device, dtype))

    def init_layers(self, gi: int, generator, device, dtype=None):
        """Group ``gi``'s layers, drawn one at a time (a generator), after
        the static params and the earlier groups.  Each leaf has the
        standard deviation the reference gives it when it materializes the
        STACKED spec (fan-in = the stacked shape's leading dim)."""
        dtype = dtype or self.param_dtype()
        g = self.groups[gi]
        stacked = stack_specs(g.spec, g.n_layers)
        for _ in range(g.n_layers):
            yield tree_map(lambda s, st: init_leaf(s, generator, device,
                                                   dtype, init_std(st)),
                           g.spec, stacked, is_leaf=is_spec)

    def init_params(self, generator, device="cpu", dtype=None):
        """All parameters with every stacked group on ``device``.  The
        draw order (static, then each group layer by layer) is the one
        ``Engine.init_params`` follows when it streams layers into the
        EPS, so both give the same values from the same seed."""
        embed, head = self.init_static(generator, device, dtype)
        groups = tuple(stack_layers(list(self.init_layers(gi, generator,
                                                          device, dtype)))
                       for gi in range(len(self.groups)))
        return {"embed": embed, "head": head, "groups": groups}

    # ------------------------------------------------------------------
    # embedding / head / contexts
    # ------------------------------------------------------------------
    def dtype(self):
        return getattr(torch, self.cfg.dtype)

    def prepare(self, static, batch):
        """-> (x0 for group 0, mem for group 0 (None)).  Whisper's encoder
        input is the frames plus sinusoidal positions; internvl2's is the
        projected patches, then the tokens' embeddings."""
        cfg, dt = self.cfg, self.dtype()
        emb = static["embed"]
        if cfg.family == "audio":
            frames = batch["frames"].to(dt)            # (B, nf, d) stub
            B, nf, _ = frames.shape
            pos = _arange(nf, B, frames.device)
            return frames + sinusoidal(pos, cfg.d_model, dt), None
        x = embed_tokens(emb, batch["tokens"], cfg, dt, self.tp)
        if cfg.is_vlm:
            p = batch["patches"].to(dt) @ emb["proj_w"].to(dt) \
                + emb["proj_b"].to(dt)
            x = torch.cat([p, x], dim=1)
        return x, None

    def transition_x(self, g: int, static, x_prev, batch):
        """Input activations of group g from group g-1's output: the
        identity, but for whisper's decoder, whose input is built from the
        target tokens (its gradient path to the encoder goes through
        ``transition_mem``)."""
        cfg = self.cfg
        if cfg.family != "audio":
            return x_prev
        toks = batch["tokens"]
        B, S = toks.shape
        x = embed_tokens(static["embed"], toks, cfg, self.dtype(), self.tp)
        return x + sinusoidal(_arange(S, B, toks.device), cfg.d_model,
                              self.dtype())

    def transition_mem(self, g: int, static, x_prev, batch):
        """Cross-attention memory of group g (None unless ``has_mem``): the
        encoder's output through ``enc_ln_post``."""
        if not self.groups[g].has_mem:
            return None
        return apply_norm(static["embed"]["enc_ln_post"], x_prev,
                          self.cfg.norm_eps)

    def transition(self, g: int, static, x_prev, batch):
        return (self.transition_x(g, static, x_prev, batch),
                self.transition_mem(g, static, x_prev, batch))

    def train_ctx(self, batch, group: Group) -> Ctx:
        cfg = self.cfg
        if group.is_encoder:
            B, nf = batch["frames"].shape[:2]
            return Ctx(positions=_arange(nf, B, batch["frames"].device),
                       causal=False)
        B, S = batch["tokens"].shape
        dev = batch["tokens"].device
        if cfg.family == "audio":
            return Ctx(positions=_arange(S, B, dev),
                       mem_positions=_arange(cfg.n_frames, B, dev),
                       causal=True)
        if cfg.is_vlm:
            S = S + cfg.n_patches
        return Ctx(positions=_arange(S, B, dev), causal=True,
                   window=cfg.sliding_window)

    def decode_ctx(self, cur_pos, window: int = 0) -> Ctx:
        w = window if window else self.cfg.sliding_window
        return Ctx(cur_pos=cur_pos, window=w, causal=True)

    def decode_embed(self, static, token, cur_pos):
        """token: (B,T) -> x (B,T,d), the same lookup as ``prepare``; for
        whisper plus the sinusoidal position (``cur_pos``: a scalar or
        per-row positions, negative entries clamped to 0)."""
        cfg, dt = self.cfg, self.dtype()
        x = embed_tokens(static["embed"], token, cfg, dt, self.tp)
        if cfg.family == "audio":
            from repro_torch.models.attention import decode_positions
            pos = decode_positions(x, cur_pos).clamp_min(0)
            x = x + sinusoidal(pos, cfg.d_model, dt)
        return x

    def local_logits(self, static, x):
        """The head's logits of x: on a vocab-parallel head this rank's
        block of the vocabulary."""
        cfg = self.cfg
        x = apply_norm(static["head"]["ln_f"], x, cfg.norm_eps)
        return logits_fn(static["head"], static["embed"], x, cfg, self.tp)

    def decode_logits(self, static, x):
        """The whole logits of x (gathered over the model axis when the
        head is vocab-parallel)."""
        logits = self.local_logits(static, x)
        if self.tp is not None and self.tp.vocab:
            logits = self.tp.gather_last(logits)
        return logits

    def head_loss(self, static, x, batch):
        """-> (loss_sum, weight_sum); the caller normalizes.  BERT's head
        is untied: ``ln_f`` (layernorm), then ``out``.  internvl2's x
        covers patches and tokens: the loss reads the token positions only
        (sliced before the head: per position the same logits)."""
        if self.cfg.is_vlm:
            x = x[:, self.cfg.n_patches:]
        return softmax_xent(self.local_logits(static, x), batch["targets"],
                            batch["mask"], self.tp)

    def full_loss(self, params, batch, remat: bool = False):
        """The whole model at once (the baseline engines):
        -> (loss, (loss_sum, weight_sum, aux)).  ``remat`` recomputes each
        layer in the backward (``torch.utils.checkpoint``)."""
        static = {"embed": params["embed"], "head": params["head"]}
        x, mem = self.prepare(static, batch)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, group in enumerate(self.groups):
            if gi > 0:
                x, mem = self.transition(gi, static, x, batch)
            ctx = self.train_ctx(batch, group)
            stacked = params["groups"][gi]
            for li in range(group.n_layers):
                w = tree_map(lambda a, _l=li: a[_l], stacked)
                if remat:
                    x, aux = torch.utils.checkpoint.checkpoint(
                        lambda ww, h, m, _g=group, _c=ctx:
                        _g.apply(ww, h, m, _c), w, x, mem,
                        use_reentrant=False)
                else:
                    x, aux = group.apply(w, x, mem, ctx)
                aux_total = aux_total + aux
        loss_sum, wsum = self.head_loss(static, x, batch)
        loss = loss_sum / wsum.clamp_min(1.0) + aux_total
        return loss, (loss_sum, wsum, aux_total)

    def decode_groups(self):
        return tuple(g for g in self.groups if not g.is_encoder)

    def cache_specs(self, batch: int, live_seq: int):
        return tuple(stack_specs(g.cache_spec(batch, live_seq), g.n_layers)
                     for g in self.decode_groups())


# ---------------------------------------------------------------------------
# Batch specs (the sharding rules' view of an input batch)
# ---------------------------------------------------------------------------
def batch_spec(cfg: ModelConfig, shape) -> dict:
    """ParamSpecs of the input batch dict at an ``InputShape``: its leaves'
    shapes and logical axes, as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    S_tok = S if not cfg.is_vlm else S - cfg.n_patches
    if shape.kind == "decode":
        return {"token": ParamSpec((B, 1), ("batch", None), "zeros")}
    frames = ParamSpec((B, cfg.n_frames, cfg.d_model),
                       ("batch", "seq", "d_model"), "zeros")
    patches = ParamSpec((B, cfg.n_patches, cfg.vit_dim),
                        ("batch", "seq", "d_model"), "zeros")
    if shape.kind == "prefill":
        spec = {"tokens": ParamSpec((B, S_tok), ("batch", "seq"), "zeros")}
        if cfg.family == "audio":
            spec["frames"] = frames
        if cfg.is_vlm:
            spec["patches"] = patches
        return spec
    if cfg.family == "audio":
        return {"frames": frames,
                "tokens": ParamSpec((B, S), ("batch", "seq"), "zeros"),
                "targets": ParamSpec((B, S), ("batch", "seq"), "zeros"),
                "mask": ParamSpec((B, S), ("batch", "seq"), "ones")}
    spec = {"tokens": ParamSpec((B, S_tok), ("batch", "seq"), "zeros"),
            "targets": ParamSpec((B, S_tok), ("batch", "seq"), "zeros"),
            "mask": ParamSpec((B, S_tok), ("batch", "seq"), "ones")}
    if cfg.is_vlm:
        spec["patches"] = patches
    return spec
