"""Public execution-engine facade of the port::

    from repro_torch import engine as engines

    eng = engines.create("l2l", model_cfg, exec_cfg)          # on cuda
    eng = engines.create("l2l", model_cfg, exec_cfg, device="cpu")
    eng = engines.create("l2l-p", model_cfg, exec_cfg, optimizer=adam())
"""
from repro_torch.engine.engine import (BaselineEngine, Engine, L2LEngine,
                                       L2LPEngine, resolve_device)
from repro_torch.engine.state import TrainState
from repro_torch.engine.registry import available, create, get, register

__all__ = ["BaselineEngine", "Engine", "TrainState", "L2LEngine", "L2LPEngine", "available", "create", "get",
           "register", "resolve_device"]
