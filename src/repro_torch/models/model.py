"""LayeredModel: the layer-granular model API the L2L engine executes (the
port of ``repro/models/model.py``: the dense, MoE, hybrid and SSM
families).

A model is ``prepare`` (embeddings) -> homogeneous layer groups, each run
over a stacked ``(N, ...)`` parameter tree, joined by a ``transition``
(the identity for a homogeneous stream: deepseek's dense -> MoE) -> the
head.  Parameters are nested dicts: ``{"embed": {...}, "head": {...},
"groups": (group, ...)}``.  Cross-attention memory (``has_mem``, the
encoder-decoder family) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
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
    is_encoder: bool = False


def stack_layers(layers):
    """Per-layer trees -> one stacked (N, ...) tree."""
    return tree_map(lambda *ls: torch.stack(ls), *layers)


class LayeredModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups: Tuple[Group, ...] = self._build_groups(cfg)

    @staticmethod
    def _build_groups(cfg) -> Tuple[Group, ...]:
        def G(name, n, spec, apply_fn, decode_fn, cache_fn):
            ap = lambda w, x, mem, ctx: apply_fn(w, x, mem, ctx, cfg)
            de = lambda w, x, c, mem, ctx: decode_fn(w, x, c, mem, ctx, cfg)
            cs = lambda b, live: cache_fn(cfg, b, live)
            return Group(name, n, spec, ap, de, cs)

        if cfg.family == "dense":
            return (G("layers", cfg.n_layers, blocks.dense_spec(cfg),
                      blocks.dense_apply, blocks.dense_decode,
                      blocks.dense_cache_spec),)
        if cfg.family == "moe":
            gs = []
            if cfg.first_dense_layers:
                # deepseek-v2: layer 0 keeps MLA attention but a dense FFN
                gs.append(G("dense_layers", cfg.first_dense_layers,
                            blocks.moe_block_spec(cfg, dense_ffn=True),
                            blocks.moe_block_apply, blocks.moe_block_decode,
                            blocks.dense_cache_spec))
            gs.append(G("moe_layers", cfg.n_layers - cfg.first_dense_layers,
                        blocks.moe_block_spec(cfg),
                        blocks.moe_block_apply, blocks.moe_block_decode,
                        blocks.dense_cache_spec))
            return tuple(gs)
        if cfg.family == "hybrid":
            return (G("layers", cfg.n_layers, blocks.hybrid_spec(cfg),
                      blocks.hybrid_apply, blocks.hybrid_decode,
                      blocks.hybrid_cache_spec),)
        if cfg.family == "ssm":
            return (G("layers", cfg.n_layers, blocks.rwkv_spec(cfg),
                      blocks.rwkv_apply, blocks.rwkv_decode,
                      blocks.rwkv_cache_spec),)
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs the dense, MoE, hybrid "
            "and SSM families so far")

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        embed = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "d_model"), "embed")}
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
        """-> (x0 for group 0, mem for group 0 (None))."""
        return embed_tokens(static["embed"], batch["tokens"], self.cfg,
                            self.dtype()), None

    def transition_x(self, g: int, static, x_prev, batch):
        """Input activations of group g from group g-1's output: the
        identity for every family ported so far (the audio family builds
        its decoder input from the target tokens)."""
        return x_prev

    def transition_mem(self, g: int, static, x_prev, batch):
        """Cross-attention memory of group g (None unless ``has_mem``)."""
        assert not self.groups[g].has_mem, \
            "cross-attention memory comes with the encoder-decoder family"
        return None

    def transition(self, g: int, static, x_prev, batch):
        return (self.transition_x(g, static, x_prev, batch),
                self.transition_mem(g, static, x_prev, batch))

    def train_ctx(self, batch, group: Group) -> Ctx:
        B, S = batch["tokens"].shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=batch["tokens"].device).expand(B, S)
        return Ctx(positions=pos, causal=True, window=self.cfg.sliding_window)

    def decode_ctx(self, cur_pos, window: int = 0) -> Ctx:
        w = window if window else self.cfg.sliding_window
        return Ctx(cur_pos=cur_pos, window=w, causal=True)

    def decode_embed(self, static, token, cur_pos):
        """token: (B,T) -> x (B,T,d), the same lookup as ``prepare``."""
        return embed_tokens(static["embed"], token, self.cfg, self.dtype())

    def decode_logits(self, static, x):
        cfg = self.cfg
        x = apply_norm(static["head"]["ln_f"], x, cfg.norm_eps)
        return logits_fn(static["head"], static["embed"], x, cfg)

    def head_loss(self, static, x, batch):
        """-> (loss_sum, weight_sum); the caller normalizes.  BERT's head
        is untied: ``ln_f`` (layernorm), then ``out``."""
        return softmax_xent(self.decode_logits(static, x), batch["targets"],
                            batch["mask"])

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
                        lambda ww, h, _g=group, _c=ctx, _m=mem:
                        _g.apply(ww, h, _m, _c), w, x, use_reentrant=False)
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
