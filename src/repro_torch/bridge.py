"""Carry parameter trees between the JAX reference and the port.

The reference hands its parameters over as numpy arrays (a caller runs
``jax.tree.map(np.asarray, params)``); the port holds nested dicts and
tuples of tensors with the same keys and the same order.  bfloat16 leaves
travel as raw ``uint16`` bits, the way ``repro/checkpoint/io.py`` stores
ml_dtypes leaves: ``torch.from_numpy`` does not take ml_dtypes' bfloat16.
The round trip is bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    """Nested dicts / tuples / lists of numpy arrays -> the same structure
    of tensors on ``device``.  An array whose dtype is named ``bfloat16``
    (ml_dtypes) becomes a ``torch.bfloat16`` tensor with the same bits."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    arr = np.array(tree, copy=True, order="C")   # writable, owned
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(arr).to(device)


def params_to_numpy(tree):
    """Inverse of ``params_from_numpy``: tensors -> numpy arrays on the
    host.  bfloat16 tensors come back as their raw ``uint16`` bits."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
