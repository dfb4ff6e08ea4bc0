"""TrainState — the one training state every Engine consumes and produces
(the port of ``repro/engine/state.py``).

``params`` ({"embed", "head", "groups"}), ``opt_state`` (optimizer slots
mirroring params, without the step counter), ``step`` (an int) and
``loss_scale`` ({"scale", "good_steps"} with AMP, else None).  With
``pack_params`` the ``groups`` hold ``packing.Packed`` rows (and
``{slot: Packed}`` for the optimizer); with ``weight_stream`` on CUDA they
rest in pinned host memory.  ``legacy_opt`` / ``from_legacy`` convert to
and from the flat dict the ``core`` functions speak.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    loss_scale: Any = None

    _OPT_KEYS = ("embed", "head", "groups")

    def legacy_opt(self) -> dict:
        """The flat opt-state dict of ``repro_torch.core``."""
        out = {"step": self.step, **{k: self.opt_state[k]
                                     for k in self._OPT_KEYS}}
        if self.loss_scale is not None:
            out["loss_scale"] = self.loss_scale
        return out

    @classmethod
    def from_legacy(cls, params, opt: dict) -> "TrainState":
        return cls(params=params,
                   opt_state={k: opt[k] for k in cls._OPT_KEYS},
                   step=int(opt["step"]), loss_scale=opt.get("loss_scale"))

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)
