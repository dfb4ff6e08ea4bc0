"""Functional per-layer optimizers (the port of ``repro/optim/optimizers.py``).

The L2L Eager Param-Server applies the optimizer ONE LAYER AT A TIME inside
the reverse relay (Algorithm 4), so the API is per-subtree::

    state = opt.init(params_subtree)
    new_params, new_state = opt.update(grads, state, params_subtree, step)

States mirror the param subtree leaf for leaf (each leaf maps to a dict of
slots), so a stacked layer group's optimizer state is stacked too and is
relayed like the weights.  ``step`` is the update counter (an int).

The per-leaf ``update`` is plain torch, as the reference's is plain jnp,
with the same association term by term: adam ``p - a*m/(√v+eps)``, adamw
``p - a*(m/(√v+eps) + wd*p)`` even at wd = 0; √ is correctly rounded on
either device (``kernels.ref.sqrt_rn``), so the same update on the CPU
(the host optimizer) and on the card agree bit for bit.  Only ``flat_update`` (the
packed relay's one-segment-per-dtype update) goes through the fused Adam
kernel (K1, ``kernels.ops.fused_adam``): the Triton kernel on a CUDA
tensor, its plain version — the same chain — on a CPU one.  The step size
``a`` is one f32 scalar computed the same way for both, so a packed update
equals the per-leaf one bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.tree import (tree_flatten_up_to, tree_leaves,
                                   tree_map, tree_unflatten_like)
from repro_torch.kernels.ref import sqrt_rn


class Optimizer(NamedTuple):
    name: str
    init: Callable        # params_subtree -> state_subtree
    update: Callable      # (grads, state, params, step) -> (params', state')
    # fused update over FLAT 1-D segments (the packed relay):
    # (p, g, m, v, step) -> (p', m', v'), g/m/v f32, p any float type;
    # None = no fused form (the packed path unpacks and runs ``update``)
    flat_update: Optional[Callable] = None


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


def make_schedule(base_lr: float, warmup: int = 0, total: int = 0,
                  kind: str = "constant") -> Callable:
    """step -> learning rate, an f32 scalar tensor (the reference's f32
    arithmetic, term by term)."""
    def sched(step):
        s = _f32(step)
        lr = _f32(base_lr)
        if warmup > 0:
            lr = lr * torch.clamp((s + 1.0) / warmup, max=1.0)
        if kind in ("cosine", "linear") and total > 0:
            frac = torch.clamp((s - warmup) / max(total - warmup, 1),
                               0.0, 1.0)
            if kind == "cosine":
                lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
            else:
                lr = lr * (1.0 - frac)
        return lr
    return sched


def tree_global_norm(tree, tp=None, pspecs=None) -> torch.Tensor:
    """The L2 norm of every leaf.  On the mesh's model axis (``tp``, the
    tree laid out as ``pspecs``): the squares of the split leaves summed
    over the model group, each whole leaf counted once."""
    if tp is not None:
        return torch.sqrt(tp.norm_sq(tree, pspecs))
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_norm(tree, max_norm: float, tp=None, pspecs=None):
    """Clip a gradient subtree by its own global norm (the L2L-p per-layer
    clip: a global clip would serialize the eager updates); ``tp`` and
    ``pspecs`` as in ``tree_global_norm``."""
    norm = tree_global_norm(tree, tp, pspecs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def _per_leaf(leaf_fn, grads, state, params):
    """Apply ``leaf_fn(g, slots, p) -> (p', slots')`` leaf by leaf."""
    gs = tree_leaves(grads)
    ss = tree_flatten_up_to(grads, state)
    ps = tree_leaves(params)
    out = [leaf_fn(g, s, p) for g, s, p in zip(gs, ss, ps)]
    return (tree_unflatten_like(grads, [o[0] for o in out]),
            tree_unflatten_like(grads, [o[1] for o in out]))


def adam_step_size(sched, step, b1, b2) -> torch.Tensor:
    """lr · √(1 − b2^t) / (1 − b1^t), t = step + 1, as one f32 scalar."""
    t = _f32(step) + 1.0
    return sched(step) * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)


def _moment_init(params):
    return tree_map(lambda p: {"m": torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device),
                               "v": torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device)}, params)


def _fused_flat_update(sched, b1, b2, eps, wd, wd_form) -> Callable:
    def flat_update(p, g, m, v, step):
        from repro_torch.kernels import ops as kops
        a = adam_step_size(sched, step, b1, b2)
        return kops.fused_adam(p, g, m, v, a, 1.0, b1=b1, b2=b2, eps=eps,
                               wd=wd, wd_form=wd_form)
    return flat_update


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
         schedule: Callable | None = None) -> Optimizer:
    sched = schedule or (lambda s: lr)

    def update(grads, state, params, step):
        a = adam_step_size(sched, step, b1, b2)

        def leaf(g, s, p):
            gf = g.float()
            m = b1 * s["m"] + (1 - b1) * gf
            v = b2 * s["v"] + (1 - b2) * gf * gf
            newp = p.float() - a * m / (sqrt_rn(v) + eps)
            return newp.to(p.dtype), {"m": m, "v": v}

        return _per_leaf(leaf, grads, state, params)

    return Optimizer("adam", _moment_init, update,
                     flat_update=_fused_flat_update(sched, b1, b2, eps, 0.0,
                                                    wd_form=False))


def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          schedule: Callable | None = None) -> Optimizer:
    sched = schedule or (lambda s: lr)

    def update(grads, state, params, step):
        a = adam_step_size(sched, step, b1, b2)

        def leaf(g, s, p):
            gf = g.float()
            m = b1 * s["m"] + (1 - b1) * gf
            v = b2 * s["v"] + (1 - b2) * gf * gf
            upd = m / (sqrt_rn(v) + eps) + weight_decay * p.float()
            return (p.float() - a * upd).to(p.dtype), {"m": m, "v": v}

        return _per_leaf(leaf, grads, state, params)

    return Optimizer("adamw", _moment_init, update,
                     flat_update=_fused_flat_update(sched, b1, b2, eps,
                                                    weight_decay,
                                                    wd_form=True))


def lamb(lr=1e-3, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
         schedule: Callable | None = None) -> Optimizer:
    """LAMB [You et al. 2019], the paper's pointer for 32K-batch L2L-p."""
    sched = schedule or (lambda s: lr)

    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        a = sched(step)

        def leaf(g, s, p):
            gf = g.float()
            m = b1 * s["m"] + (1 - b1) * gf
            v = b2 * s["v"] + (1 - b2) * gf * gf
            mhat = m / (1.0 - b1 ** t)
            vhat = v / (1.0 - b2 ** t)
            u = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            w_norm = torch.linalg.vector_norm(p.float().reshape(-1))
            u_norm = torch.linalg.vector_norm(u.reshape(-1))
            one = torch.ones((), dtype=torch.float32, device=p.device)
            trust = torch.where(w_norm > 0,
                                torch.where(u_norm > 0, w_norm / u_norm, one),
                                one)
            return (p.float() - a * trust * u).to(p.dtype), {"m": m, "v": v}

        return _per_leaf(leaf, grads, state, params)

    return Optimizer("lamb", _moment_init, update)


def sgd(lr=1e-2, momentum=0.0, schedule: Callable | None = None) -> Optimizer:
    sched = schedule or (lambda s: lr)

    def init(params):
        if momentum == 0.0:
            return tree_map(lambda p: {}, params)
        return tree_map(lambda p: {"mu": torch.zeros(
            p.shape, dtype=torch.float32, device=p.device)}, params)

    def update(grads, state, params, step):
        a = sched(step)

        def leaf(g, s, p):
            gf = g.float()
            if momentum == 0.0:
                return (p.float() - a * gf).to(p.dtype), s
            mu = momentum * s["mu"] + gf
            return (p.float() - a * mu).to(p.dtype), {"mu": mu}

        return _per_leaf(leaf, grads, state, params)

    return Optimizer("sgd", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adam": adam, "adamw": adamw, "lamb": lamb, "sgd": sgd}[name](**kw)
