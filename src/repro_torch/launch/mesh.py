"""Mesh construction (the port of ``repro/launch/mesh.py``).

Functions only: importing this module touches no process group.  Each
builds a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group the caller has initialized (``torch.distributed.init_process_group``
with its address, world size and rank), with the reference's axis names
and shapes; the mesh's size must equal the world's.

The roofline constants are the port's card's, an NVIDIA H100 80GB HBM3
(SXM) at its 700 W power limit (dense bf16 tensor-core peak, HBM3 rate,
NVLink 4 per direction); a card set below 700 W runs slower than these.
"""
from __future__ import annotations

import math


def make_mesh(shape: dict, device_type: str = "cuda"):
    """A DeviceMesh of ``{axis name: size}`` (in that order) over the
    initialized world, whose size must be the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape.values())
    world = dist.get_world_size() if dist.is_initialized() else 0
    assert world == n, \
        (f"mesh {dict(shape)} needs {n} ranks; the initialized world has "
         f"{world} (init_process_group with world_size={n} first)")
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return make_mesh(shape, device_type)


def make_debug_mesh(data: int = 2, model: int = 4,
                    device_type: str = "cuda"):
    """Small mesh for tests."""
    return make_mesh({"data": data, "model": model}, device_type)


# Hardware constants for the roofline (NVIDIA H100 80GB HBM3, SXM, 700 W)
PEAK_FLOPS_BF16 = 989e12          # per card, dense
HBM_BW = 3.35e12                  # bytes/s per card
NVLINK_BW = 450e9                 # bytes/s per card, each way
