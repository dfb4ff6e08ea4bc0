"""The Engine facade — the public way to run a schedule (the port of
``repro/engine/engine.py``, serving half)::

    from repro_torch import engine as engines

    eng = engines.create("l2l", get_config("granite-3-8b"), ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1))
    params = eng.init_params(torch.Generator("cuda").manual_seed(0))
    caches, logits = eng.decode_init(params, prompt, live_seq=32)
    logits, caches = eng.decode_step(params, caches, token, cur_pos=16)

An Engine runs on ``cuda`` unless it is built with ``device="cpu"``; on a
machine without a card it raises instead of moving to the CPU.  Training
methods come with the next slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import decode as _decode, l2l as _l2l, packing
from repro_torch.core.eps import make_placements
from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_map
from repro_torch.engine.registry import register
from repro_torch.models.model import LayeredModel


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises (no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the CPU")
    return device


class Engine:
    """Lifecycle facade over a schedule's relay functions."""
    name = "base"

    def __init__(self, model, exec_cfg: Optional[ExecutionConfig] = None, *,
                 device="cuda", placements=None):
        if isinstance(model, ModelConfig):
            model = LayeredModel(model)
        self.model = model
        self.device = resolve_device(device)
        self.exec_cfg = self._normalize_cfg(exec_cfg or ExecutionConfig())
        self.placements = placements or make_placements(
            self.exec_cfg, len(model.groups), self.device)
        # one copy stream for every relay pass of this engine, so freed
        # slots are reused instead of allocated anew on a fresh stream
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._fns: dict = {}

    def _normalize_cfg(self, exec_cfg: ExecutionConfig) -> ExecutionConfig:
        return exec_cfg

    # -- parameters ---------------------------------------------------------
    def init_params(self, generator: torch.Generator):
        """Random parameters from ``generator`` (on this engine's device
        type), already in the relay layout: embedding and head on the
        device; each layer group drawn ONE LAYER AT A TIME on the device
        and written into its resting place — pinned host memory when
        ``weight_stream`` on CUDA, packed rows when ``pack_params`` — so a
        model larger than the card initializes without ever being whole on
        it.  The values equal ``model.init_params`` from the same seed."""
        m, dev = self.model, self.device
        embed, head = m.init_static(generator, dev)
        groups = []
        for gi, g in enumerate(m.groups):
            pinned = self.placements.weights[gi].enabled
            dest = None
            for li, layer in enumerate(m.init_layers(gi, generator, dev)):
                row = packing.pack(layer, stacked=False) \
                    if self.exec_cfg.pack_params else layer
                if dest is None:
                    dest = tree_map(
                        lambda a: torch.empty(
                            (g.n_layers,) + tuple(a.shape), dtype=a.dtype,
                            device="cpu" if pinned else dev,
                            pin_memory=pinned), row)
                tree_map(lambda d, r, _l=li: d[_l].copy_(r), dest, row)
            groups.append(dest)
        return {"embed": embed, "head": head, "groups": tuple(groups)}

    def _relay_params(self, params):
        """Params in the layout and place the relay expects: with
        ``pack_params`` the stacked groups as per-dtype flat rows; the
        groups in their resting place (pinned host when streaming), the
        embedding and head on the device.  Idempotent, and cached by
        object identity: a serving loop that passes the same params every
        token converts them once."""
        cached = self._fns.get("_relay_cache")
        if cached is not None and cached[0] is params:
            return cached[1]
        p = packing.pack_params(params) if self.exec_cfg.pack_params \
            else params
        to_dev = lambda t: tree_map(lambda a: a.to(self.device), t)
        placed = {"embed": to_dev(p["embed"]), "head": to_dev(p["head"]),
                  "groups": tuple(self.placements.weights[gi].host(g)
                                  for gi, g in enumerate(p["groups"]))}
        self._fns["_relay_cache"] = (params, placed)
        return placed

    # -- inference ----------------------------------------------------------
    def prefill(self, params, batch):
        """Last-token logits (B, vocab) of a prompt batch
        (``{"tokens": (B, S)}``) under the layer-major relay."""
        if "prefill" not in self._fns:
            self._fns["prefill"] = _l2l.make_prefill_fn(
                self.model, self.exec_cfg, self.placements, self.device,
                self.copy_stream)
        with torch.inference_mode():
            batch = tree_map(lambda a: a.to(self.device), batch)
            return self._fns["prefill"](self._relay_params(params), batch)

    def decode_init(self, params, tokens, live_seq: int):
        """Fill the decode caches from a prompt, one token per serve step.
        Returns (caches, last_logits)."""
        with torch.inference_mode():
            return _decode.prefill(
                self.model, self._relay_params(params),
                tokens.to(self.device), live_seq, exec_cfg=self.exec_cfg,
                placements=self.placements, device=self.device,
                copy_stream=self.copy_stream)

    def decode_step(self, params, caches, token, cur_pos):
        """One decode step: (logits (B, T, V), caches updated in place)."""
        if "decode_step" not in self._fns:
            self._fns["decode_step"] = _decode.make_serve_step(
                self.model, self.exec_cfg, self.placements, self.device,
                self.copy_stream)
        with torch.inference_mode():
            return self._fns["decode_step"](
                self._relay_params(params), caches, token.to(self.device),
                cur_pos)


@register("l2l")
class L2LEngine(Engine):
    """Algorithm 3 (trailing optimizer); serves exactly as ``l2l-p``."""
    name = "l2l"

    def _normalize_cfg(self, exec_cfg):
        return dataclasses.replace(exec_cfg, eager_optimizer=False)


@register("l2l-p")
class L2LPEngine(Engine):
    """Algorithm 4 (eager per-layer optimizer); serves exactly as ``l2l``."""
    name = "l2l-p"

    def _normalize_cfg(self, exec_cfg):
        return dataclasses.replace(exec_cfg, eager_optimizer=True)
