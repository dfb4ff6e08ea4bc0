"""Baseline execution — Algorithms 1 and 2 of the paper (the port of
``repro/core/baseline.py``).

Algorithm 1: whole minibatch, whole model resident, grad + update.
Algorithm 2: microbatch loop with gradient accumulation, then update.
Both optionally rematerialize per layer (``exec_cfg.remat``, through
``torch.utils.checkpoint``).  The gradient-identity anchor of the L2L
engines inside the port.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.schedule import ExecutionConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten_like
from repro_torch.optim import Optimizer, clip_by_norm, tree_global_norm


def make_grads_fn(model, exec_cfg: ExecutionConfig, dp=None) -> Callable:
    """(params, batch) -> (loss, grads).  Algorithm 2 when
    n_microbatches > 1 (normalized like the L2L engine: the per-ub
    loss_sums over the total weight, plus the mean aux).  With ``dp`` (a
    ``distributed.data_parallel.DataParallel``) the batch is this rank's
    rows: the loss weight is summed over the data axes first, and the
    gradients (one flat row) and the loss once, after the backward; the
    aux (a MoE's is already the global batch's) is added after that sum,
    as the L2L engine adds it."""
    fn = _grads_and_weight(model, exec_cfg, dp)
    return lambda params, batch: fn(params, batch)[:2]


def _grads_and_weight(model, exec_cfg: ExecutionConfig, dp) -> Callable:
    """(params, batch) -> (loss, grads, the global mask sum)."""
    UB = exec_cfg.n_microbatches

    def fn(params, batch):
        wsum = batch["mask"].sum()
        if dp is not None:
            wsum = dp.all_reduce_(wsum)
        W_total = wsum.clamp_min(1.0)

        def ub_grads(b):
            leaves = [a.detach().requires_grad_()
                      for a in tree_leaves(params)]
            with torch.enable_grad():
                _, (loss_sum, _, aux) = model.full_loss(
                    tree_unflatten_like(params, leaves), b,
                    remat=exec_cfg.remat)
                loss = loss_sum / W_total + aux / UB
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return (loss_sum / W_total).detach(), aux.detach(), \
                tree_unflatten_like(params, [
                    torch.zeros_like(a) if g is None else g
                    for a, g in zip(leaves, grads)])

        if UB == 1:
            loss, aux_sum, acc = ub_grads(batch)
        else:
            batch_ub = tree_map(
                lambda a: a.reshape(UB, a.shape[0] // UB, *a.shape[1:]),
                batch)
            loss = torch.zeros((), dtype=torch.float32,
                               device=W_total.device)
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            aux_sum = torch.zeros_like(loss)
            for u in range(UB):
                l, a_u, g = ub_grads(tree_map(lambda a, _u=u: a[_u],
                                              batch_ub))
                acc = tree_map(lambda a, x: a + x.float(), acc, g)
                loss = loss + l
                aux_sum = aux_sum + a_u
        if dp is not None:
            acc = dp.reduce_tree(acc)
            loss = dp.all_reduce_(loss)
        # the aux is the global batch's on every data rank (a MoE sums its
        # router statistics over the group): added once, after the sum
        loss = loss + aux_sum / UB
        return loss, acc, wsum

    return fn


def make_train_step(model, optimizer: Optimizer, exec_cfg: ExecutionConfig,
                    dp=None, tp=None) -> Callable:
    """Algorithm 1 (UB=1) / Algorithm 2 (UB>1): one update at the end of
    the minibatch (of the global batch's gradient with ``dp``).  With
    ``tp`` (the model axis) the params are this rank's blocks; the model's
    autograd reduces over the model group, the grad norm and the clips
    sum the split leaves' squares over it and the finite flag is agreed
    over it."""
    grads_fn = _grads_and_weight(model, exec_cfg, dp)
    ps = None if tp is None else tp.param_pspecs

    def step(params, opt_state, batch):
        loss, grads, wsum = grads_fn(params, batch)
        gnorm = tree_global_norm(grads, tp, ps)
        finite = torch.stack([torch.isfinite(g).all()
                              for g in tree_leaves(grads)]).all()
        if tp is not None:
            finite = tp.all_true(finite)
        if exec_cfg.clip_mode == "per_layer":
            # the reference clips each stacked group tree as a whole
            grads = {**grads, "groups": tuple(
                clip_by_norm(g, exec_cfg.clip_norm, tp,
                             None if tp is None else ps["groups"][gi])[0]
                for gi, g in enumerate(grads["groups"]))}
        new_params, new_inner = optimizer.update(
            grads, {k: opt_state[k] for k in ("embed", "head", "groups")},
            params, opt_state["step"])
        new_opt = {"step": opt_state["step"] + 1, **new_inner}
        metrics = {"loss": loss, "grad_norm": gnorm, "weight_sum": wsum}
        if exec_cfg.skip_nonfinite:
            bad = not bool(finite)
            if bad:
                new_params = params
                new_opt = {k: opt_state[k]
                           for k in ("step", "embed", "head", "groups")}
            metrics["skipped_steps"] = int(bad)
        return new_params, new_opt, metrics

    return step


def init_opt_state(optimizer: Optimizer, params) -> dict:
    return {"step": 0,
            "embed": optimizer.init(params["embed"]),
            "head": optimizer.init(params["head"]),
            "groups": tuple(optimizer.init(g) for g in params["groups"])}
