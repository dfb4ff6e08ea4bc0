"""Public execution-engine facade of the port::

    from repro_torch import engine as engines

    eng = engines.create("l2l", model_cfg, exec_cfg)          # on cuda
    eng = engines.create("l2l", model_cfg, exec_cfg, device="cpu")
"""
from repro_torch.engine.engine import (Engine, L2LEngine, L2LPEngine,
                                       resolve_device)
from repro_torch.engine.registry import available, create, get, register

__all__ = ["Engine", "L2LEngine", "L2LPEngine", "available", "create", "get",
           "register", "resolve_device"]
