"""Helpers for checks of the port against its plain versions and the
reference."""
from __future__ import annotations

import dataclasses
import math


SCALES = ("scale", "kv_norm", "beta_a", "beta_s", "d_skip", "ln_scale")
# biases whose names do not start with "b" (internvl2's patch projection)
BIASES = ("proj_b",)


def fan_in_params(tree, randn):
    """Parameters at the usual scales, shaped like ``tree`` (ParamSpecs,
    tensors or arrays; the stacked layer groups inside tuples): weights
    N(0, 1/fan_in), biases (``b*``, ``BIASES``) and the embedding
    N(0, 0.02^2), norm scales
    and the other per-channel scales 1 + N(0, 0.01) (``SCALES``: MLA's
    ``kv_norm``, hymba's branch scales ``beta_a`` / ``beta_s`` and its
    skip ``d_skip``, rwkv's groupnorm ``ln_scale``; drawn as biases or
    weights they would shrink a branch to a few percent, where a wrong
    one hides inside any tolerance).  An expert's matrices (under
    ``experts``, ``(E, fan_in, fan_out)`` per layer) take the fan-in after
    the expert axis.  ``randn(shape)`` draws a standard normal tensor or
    array; the leaves are drawn in flatten order (dict keys sorted).

    The model's own init gives every stacked matrix std 1/sqrt(n_layers),
    where the backward amplifies rounding; at these scales two versions of
    a kernel are compared, not that amplification."""
    def draw(node, name="", stacked=False, expert=False):
        if isinstance(node, dict):
            return {k: draw(node[k], k, stacked, expert or k == "experts")
                    for k in sorted(node)}
        if isinstance(node, tuple) and not hasattr(node, "shape"):
            return tuple(draw(v, name, True) for v in node)   # the groups
        shape = tuple(node.shape)
        fan = shape[int(stacked) + int(expert):]
        x = randn(shape)
        if name in SCALES:
            return 1.0 + 0.1 * x
        if name.startswith("b") or name in BIASES or name == "tok":
            return 0.02 * x
        return x / math.sqrt(fan[0] * (fan[1] if name == "wo" else 1))
    return draw(tree)


def init_numpy(cfg, seed: int, dtype=None):
    """Parameters of a model config (the port's ``ModelConfig`` or one
    with the same fields, the reference's) at the model's own init — the
    reference's distribution, every stacked matrix at std 1/sqrt(n_layers)
    — drawn by the port's init on the CPU from a seeded torch generator,
    as numpy arrays (bf16 as ``ml_dtypes.bfloat16``).  A reference test
    takes these where it needs the init's scales, not its values: no JAX
    compile per leaf shape."""
    import torch
    from repro_torch import bridge
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import LayeredModel
    port_cfg = ModelConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(ModelConfig)})
    if dtype is not None:
        dtype = getattr(torch, str(dtype))
    params = bridge.params_to_numpy(LayeredModel(port_cfg).init_params(
        torch.Generator().manual_seed(seed), "cpu", dtype))

    def bits(a):
        if a.dtype.name == "uint16":
            import ml_dtypes
            return a.view(ml_dtypes.bfloat16)
        return a
    from repro_torch.core.tree import tree_map
    return tree_map(bits, params)
