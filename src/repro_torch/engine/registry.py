"""Open registry of execution engines (the port of
``repro/engine/registry.py``).

The schedules register themselves on import of ``repro_torch.engine``
("baseline" = Alg 1/2, "l2l" = Alg 3, "l2l-p" = Alg 4; the two L2L
serving paths are the same); new schedules plug in with the same
decorator::

    @register("my-schedule")
    class MyEngine(Engine):
        ...

    eng = engines.create("my-schedule", model_cfg, exec_cfg, device="cuda")
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}


def register(name: str) -> Callable:
    """Class/factory decorator: ``create(name, ...)`` will call it as
    ``factory(model, exec_cfg, **kwargs)``."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available() -> list:
    return sorted(_REGISTRY)


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; available engines: "
            f"{', '.join(available()) or '(none registered)'}") from None


def create(name: str, model, exec_cfg=None, *,
           exec_overrides: Optional[dict] = None, **kwargs):
    """Build a registered Engine.

    ``model`` is a ModelConfig or a built LayeredModel.  ``exec_overrides``
    patches fields onto ``exec_cfg`` (or the default config), e.g.
    ``{"prefetch_depth": 2}``.  Keyword args go to the engine constructor
    (``optimizer=``, ``device=``, ``mesh=``, ``rules=``, ``placements=``);
    the device defaults to ``"cuda"``, the optimizer to ``adam()``.
    """
    if exec_overrides:
        from repro_torch.core.schedule import ExecutionConfig
        exec_cfg = dataclasses.replace(exec_cfg or ExecutionConfig(),
                                       **exec_overrides)
    return get(name)(model, exec_cfg, **kwargs)
