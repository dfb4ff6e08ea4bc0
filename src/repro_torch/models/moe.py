"""Mixture-of-Experts: token-choice top-k routing (the port of
``repro/models/moe.py``).

Two dispatch paths, chosen by the token count T of one call:

* **dense path** (T <= 2E, decode): every expert runs on every token and
  the top-k weights combine them.  Exact (no drops); each row's output
  depends on that row alone.
* **capacity path** (training / prefill): Switch-style slot assignment
  (a cumulative count per expert), a scatter into per-expert buffers
  ``(E, C + 1, d)`` (overflow goes to slot C, whose output is zero),
  batched expert matmuls and a weighted combine.  The capacity
  ``C = max(1, ceil(T·k/E·capacity_factor))``, capped at T, comes from
  the T of the call: the microbatch in training, every row of a tick in
  continuous serving (padding rows included), as in the reference.

No float atomics, so a step is bitwise repeatable on the card: the
reference's scatter-adds become sums in a fixed order.  The combine's
``.at[tok_idx].add`` is a reshape ``(T, k, d).sum(1)`` (``tok_idx`` is
``arange(T·k) // k``), the dispatch input is an ``expand`` of the tokens
whose backward is that same sum, the dispatch writes each kept
``(expert, slot)`` once (``index_put`` without accumulation; its backward
is a gather), and the router's counts are integers (a one-hot sum).

On a mesh the layer computes the reference's function, which GSPMD
partitions with no MoE-specific code: the unsharded layer over the
global batch.

* The model axis (``tp``, ``distributed.tensor_parallel``): with the
  experts split (``tp.experts``, expert parallelism) each rank holds the
  experts of ``tp.expert_block()`` and the router's matching columns; its
  local logits are gathered whole (``gather_last``), so softmax, top-k and
  the renormalization give the same bits on every rank; it runs its own
  experts only (its rows of the capacity buffer, or every token through
  them on the dense path), combines the ``(token, choice)`` pairs whose
  expert is local and the partial ``(T, d)`` is summed over the group.
  With ``expert_ffn`` split instead (tensor parallelism inside the
  experts) every rank runs every expert on its columns, the router whole.
  ``x`` passes ``copy_in`` where a split computation reads it (the router
  and the experts under expert parallelism, the experts alone under
  ``expert_ffn``), and so do the combine weights ``top_w``: without it a
  rank's cotangent of ``top_w`` would cover its own experts only, and the
  softmax, which couples every column, would pass a part of the router's
  gradient to ``gather_last``'s sliced backward.
* The data axes (``dp``, ``distributed.data_parallel``): a rank holds the
  r-th contiguous block of the global rows of each call
  (``Engine.local_rows``).  The router's counts and probability sums
  are summed over the group (``dp.sum_stats``: one collective of 2E
  floats, identity backward), so the load-balance loss is the global one
  on every rank and each rank's vjp carries its own tokens' share.  The
  dense-path threshold and the capacity C come from the global token
  count; the global dispatch adds the counts of the ranks before this one
  (``dp.gather_counts``: E integers a rank) to the local slot cumsum, so a
  pair is kept iff its global slot is below C.  An expert's output for a
  kept row does not depend on the slot, so no token leaves its rank.
  With ``cfg.moe_ep_constraint`` (and T divisible by the data ranks)
  each rank's rows are one dispatch group of their own, with C from
  T / D, as the reference's grouped dispatch (``_dispatch_groups``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, act_fn
from repro_torch.models.mlp import mlp_apply, mlp_spec


def moe_spec(cfg) -> dict:
    E, d, fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    experts = {
        "w_gate": ParamSpec((E, d, fe), ("experts", "d_model", "expert_ffn")),
        "w_in": ParamSpec((E, d, fe), ("experts", "d_model", "expert_ffn")),
        "w_out": ParamSpec((E, fe, d), ("experts", "expert_ffn", "d_model")),
    }
    if not cfg.gated_mlp:
        experts = {
            "w_in": ParamSpec((E, d, fe), ("experts", "d_model", "expert_ffn")),
            "w_out": ParamSpec((E, fe, d), ("experts", "expert_ffn", "d_model")),
        }
    spec = {
        "router": ParamSpec((d, E), ("d_model", "experts"), "scaled", 0.1),
        "experts": experts,
    }
    if cfg.n_shared_experts:
        spec["shared"] = mlp_spec(cfg, cfg.n_shared_experts * fe)
    return spec


def _expert_ffn(w, x, cfg):
    """x: (E, C, d) -> (E, C, d), one batched product per expert."""
    dt = x.dtype
    act = act_fn(cfg.act)
    if "w_gate" in w:
        h = act(torch.bmm(x, w["w_gate"].to(dt)))
        h = h * torch.bmm(x, w["w_in"].to(dt))
    else:
        h = act(torch.bmm(x, w["w_in"].to(dt)))
    return torch.bmm(h, w["w_out"].to(dt))


def _route(w, xf, cfg, tp=None, dp=None, stats: bool = True):
    """xf: (T, d) -> top-k (weights (T, k) f32, ids (T, k) int64, aux).
    The top k by a stable descending sort: the lower index first on a
    tie, as ``jax.lax.top_k`` gives it (``torch.topk`` does not).  With
    the experts split over ``tp`` the router holds this rank's columns and
    the logits are gathered; with ``dp`` the statistics are the data
    group's (unless ``stats`` is False, where the caller drops the
    aux)."""
    logits = xf.float() @ w["router"].float()
    if tp is not None and tp.experts:
        logits = tp.gather_last(logits)
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    k = cfg.experts_per_token
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux (Switch): E * sum_e f_e * p_e, f from integer counts
    E = cfg.n_experts
    counts = F.one_hot(top_i.reshape(-1), E).sum(0)
    if dp is None or not stats:
        f = counts.float() / max(top_i.numel(), 1)
        p = probs.mean(0)
    else:
        T = xf.shape[0] * dp.world
        both = dp.sum_stats(torch.cat([counts.float(), probs.sum(0)]))
        f = both[:E] / max(T * k, 1)
        p = both[E:] / T
    aux = E * torch.sum(f * p) * cfg.router_aux_coef
    return top_w, top_i, aux


def _moe_dense(w, xf, top_w, top_i, cfg, lo: int, hi: int):
    """All of this rank's experts ``[lo, hi)`` on every token (small T)."""
    E = cfg.n_experts
    y_all = _expert_ffn(w["experts"], xf[None].expand((hi - lo,) + xf.shape),
                        cfg)                                  # (El, T, d)
    onehot = F.one_hot(top_i, E).float()                      # (T, k, E)
    comb = (onehot * top_w[..., None]).sum(1)[:, lo:hi]       # (T, El)
    return torch.einsum("te,etd->td", comb.to(xf.dtype), y_all)


def _dispatch(xf, top_i, C: int, E: int, k: int, *, lo: int = 0,
              hi: int = None, offset=None):
    """Token-choice slot assignment.  xf: (T, d) -> (buf (El, Cb+1, d),
    slot_c (T·k,), keep (T·k,), e_loc (T·k,)) for this rank's experts
    ``[lo, hi)``.  ``offset`` (E,): the pairs of each expert ahead of this
    rank's rows in the global dispatch; a pair is kept iff its global
    slot is below C.  Its local slot is no larger, so the buffer holds
    ``Cb = min(C, T)`` slots; the dropped pairs and those of other ranks'
    experts go to slot Cb, whose output is zero."""
    T, d = xf.shape
    hi = E if hi is None else hi
    flat_e = top_i.reshape(T * k)
    onehot = F.one_hot(flat_e, E)                             # (Tk, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = slot < C if offset is None else slot + offset[flat_e] < C
    if lo != 0 or hi != E:
        keep = keep & (flat_e >= lo) & (flat_e < hi)
    Cb = min(C, T)
    slot_c = torch.where(keep, slot, torch.full_like(slot, Cb))
    e_loc = (flat_e - lo).clamp(0, hi - lo - 1)
    # xf[tok_idx] with tok_idx = arange(T·k) // k: an expand, whose
    # backward sums each token's k rows in order (no atomics)
    x_rep = xf[:, None].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((hi - lo, Cb + 1, d), dtype=xf.dtype,
                      device=xf.device)
    # every kept (expert, slot) is written once; the other rows all land
    # in slot Cb, whose output is zeroed below
    buf = buf.index_put((e_loc, slot_c), x_rep)
    return buf, slot_c, keep, e_loc


def _combine(y_pad, top_w, slot_c, keep, e_loc, T: int, k: int):
    """y_pad: (El, Cb+1, d) expert outputs -> (T, d)."""
    d = y_pad.shape[-1]
    gathered = y_pad[e_loc, slot_c]                           # (Tk, d)
    gathered = gathered * (top_w.reshape(-1) * keep).to(y_pad.dtype)[:, None]
    return gathered.reshape(T, k, d).sum(1)


def _moe_capacity(w, xf, top_w, top_i, cfg, lo: int, hi: int,
                  T_glob: int, offset=None):
    """The capacity path over a dispatch of ``T_glob`` tokens, of which
    ``xf`` holds this rank's (after ``offset`` pairs of each expert)."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = max(1, int(math.ceil(T_glob * k / E * cfg.capacity_factor)))
    C = min(C, T_glob)
    buf, slot_c, keep, e_loc = _dispatch(xf, top_i, C, E, k, lo=lo, hi=hi,
                                         offset=offset)
    Cb = buf.shape[1] - 1
    y = _expert_ffn(w["experts"], buf[:, :Cb], cfg)           # (El, Cb, d)
    y = F.pad(y, (0, 0, 0, 1))                                # slot Cb == 0
    return _combine(y, top_w, slot_c, keep, e_loc, T, k)


def moe_apply(w, x, cfg, tp=None, dp=None, *,
              stats: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux loss).  ``tp``: the model axis (its expert
    block or its expert columns), ``dp``: the data axes (``dp.world`` > 1:
    this rank's rows of a global call); ``stats`` False skips the router
    statistics' collective where the caller drops the aux (decode)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    ep = tp is not None and tp.experts
    split = ep or (tp is not None and tp.expert_ffn)
    lo, hi = tp.expert_block() if ep else (0, cfg.n_experts)
    # the split computations' input: its cotangent summed over the group
    # (the router too when its columns are split)
    xs = tp.copy_in(xf) if split else xf
    top_w, top_i, aux = _route(w, xs if ep else xf, cfg, tp, dp, stats)
    if split:
        top_w = tp.copy_in(top_w)
    D = 1 if dp is None else dp.world
    T_glob = B * S * D
    if T_glob <= 2 * cfg.n_experts:
        y = _moe_dense(w, xs, top_w, top_i, cfg, lo, hi)
    elif D > 1 and cfg.moe_ep_constraint and T_glob % D == 0:
        # the grouped dispatch: this rank's rows are one group
        y = _moe_capacity(w, xs, top_w, top_i, cfg, lo, hi, B * S)
    elif D > 1:
        counts = F.one_hot(top_i.reshape(-1), cfg.n_experts).sum(0)
        every = dp.gather_counts(counts)                      # (D, E)
        offset = every[:dp.rank].sum(0)
        y = _moe_capacity(w, xs, top_w, top_i, cfg, lo, hi, T_glob, offset)
    else:
        y = _moe_capacity(w, xs, top_w, top_i, cfg, lo, hi, T_glob)
    if split:
        y = tp.reduce(y)
    if "shared" in w:
        y = y + mlp_apply(w["shared"], xf, cfg, tp)
    return y.reshape(B, S, d), aux
