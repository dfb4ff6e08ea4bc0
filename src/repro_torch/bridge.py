"""Carry parameter trees between the JAX reference and the port.

The reference hands its parameters over as numpy arrays (a caller runs
``jax.tree.map(np.asarray, params)``); the port holds nested dicts and
tuples of tensors with the same keys and the same order.  bfloat16 leaves
travel as raw ``uint16`` bits, the way ``repro/checkpoint/io.py`` stores
ml_dtypes leaves: ``torch.from_numpy`` does not take ml_dtypes' bfloat16.
The round trip is bit-exact.

Training states travel the same way: the reference's ``TrainState``
(params, optimizer slots ``{"embed", "head", "groups"}`` whose leaves are
``{"m", "v"}`` dicts, step, loss scale) as numpy trees, into the port's
``TrainState`` — unpacked, or packed into the port's flat rows (which are
byte-identical to the reference's) — and back, always in the unpacked
layout.
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


def train_state_from_numpy(params, opt_state, step, loss_scale=None, *,
                           pack: bool = False, device="cpu"):
    """numpy trees of a reference TrainState (unpacked) -> the port's
    ``TrainState`` on ``device``; ``pack`` packs the layer groups and
    their optimizer slots (slot-major, weight-aligned)."""
    from repro_torch.core import packing
    from repro_torch.engine.state import TrainState
    p = params_from_numpy(params, device)
    o = params_from_numpy(opt_state, device)
    if pack:
        p = packing.pack_params(p)
        o = packing.pack_opt_state(o, p)
    return TrainState(params=p, opt_state=o, step=int(step),
                      loss_scale=None if loss_scale is None
                      else params_from_numpy(loss_scale, device))


def train_state_to_numpy(state):
    """The port's ``TrainState`` (packed or not, on any device) ->
    (params, opt_state, step, loss_scale) numpy trees in the unpacked
    layout of the reference.  Waits for the card first: pinned rows are
    written by kernels the host allocator does not track."""
    from repro_torch.core import packing
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    opt = packing.unpack_opt_state(dict(state.opt_state), state.params)
    params = packing.unpack_params(state.params)
    return (params_to_numpy(params), params_to_numpy(opt), int(state.step),
            None if state.loss_scale is None
            else params_to_numpy(state.loss_scale))


def params_to_rank(tree, tp, device="cpu"):
    """The reference's whole numpy parameters -> this model rank's blocks
    (``distributed.tensor_parallel.TensorParallel.shard``) as tensors on
    ``device``."""
    return tp.shard(params_from_numpy(tree, device))


def train_state_to_rank(params, opt_state, step, tp, loss_scale=None, *,
                        device="cpu"):
    """numpy trees of a whole reference TrainState (unpacked) -> this
    model rank's ``TrainState``: the blocks of every split leaf and of its
    optimizer slots, the other leaves whole."""
    from repro_torch.engine.state import TrainState
    return TrainState(
        params=params_to_rank(params, tp, device),
        opt_state=tp.shard(params_from_numpy(opt_state, device)),
        step=int(step), loss_scale=None if loss_scale is None
        else params_from_numpy(loss_scale, device))


def gather_params(tree, tp):
    """This model rank's blocks -> the whole parameters (or gradients) as
    numpy trees, gathered over the model group (every rank calls it)."""
    from repro_torch.core import packing
    return params_to_numpy(tp.gather(packing.unpack_params(tree)))


def gather_train_state(state, tp):
    """``train_state_to_numpy`` of the whole state a model rank's blocks
    belong to (every rank calls it: one gather per split leaf)."""
    from repro_torch.core import packing
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    opt = packing.unpack_opt_state(dict(state.opt_state), state.params)
    params = packing.unpack_params(state.params)
    return (params_to_numpy(tp.gather(params)),
            params_to_numpy(tp.gather(opt)), int(state.step),
            None if state.loss_scale is None
            else params_to_numpy(state.loss_scale))
