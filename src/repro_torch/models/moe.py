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

Not ported: the reference's sharding helpers (``_ep_constraint``,
``_ep_constraint_grouped``, ``_dispatch_groups``), which do nothing
without a device mesh; the port runs one device.
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


def _route(w, xf, cfg):
    """xf: (T, d) -> top-k (weights (T, k) f32, ids (T, k) int64, aux).
    The top k by a stable descending sort: the lower index first on a
    tie, as ``jax.lax.top_k`` gives it (``torch.topk`` does not)."""
    logits = xf.float() @ w["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    k = cfg.experts_per_token
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux (Switch): E * sum_e f_e * p_e, f from integer counts
    E = cfg.n_experts
    f = F.one_hot(top_i.reshape(-1), E).sum(0).float()
    f = f / max(top_i.numel(), 1)
    p = probs.mean(0)
    aux = E * torch.sum(f * p) * cfg.router_aux_coef
    return top_w, top_i, aux


def _moe_dense(w, xf, top_w, top_i, cfg):
    """All experts on every token (small T)."""
    E = cfg.n_experts
    y_all = _expert_ffn(w["experts"], xf[None].expand((E,) + xf.shape),
                        cfg)                                  # (E, T, d)
    onehot = F.one_hot(top_i, E).float()                      # (T, k, E)
    comb = (onehot * top_w[..., None]).sum(1)                 # (T, E)
    return torch.einsum("te,etd->td", comb.to(xf.dtype), y_all)


def _dispatch(xf, top_i, C: int, E: int, k: int):
    """Token-choice slot assignment.  xf: (T, d) -> (buf (E, C+1, d),
    slot_c (T·k,), keep (T·k,), flat_e (T·k,))."""
    T, d = xf.shape
    flat_e = top_i.reshape(T * k)
    onehot = F.one_hot(flat_e, E)                             # (Tk, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = slot < C
    slot_c = torch.where(keep, slot, torch.full_like(slot, C))
    # xf[tok_idx] with tok_idx = arange(T·k) // k: an expand, whose
    # backward sums each token's k rows in order (no atomics)
    x_rep = xf[:, None].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((E, C + 1, d), dtype=xf.dtype, device=xf.device)
    # every kept (expert, slot) is written once; the dropped rows all land
    # in slot C, whose output is zeroed below
    buf = buf.index_put((flat_e, slot_c), x_rep)
    return buf, slot_c, keep, flat_e


def _combine(y_pad, top_w, slot_c, keep, flat_e, T: int, k: int):
    """y_pad: (E, C+1, d) expert outputs -> (T, d)."""
    d = y_pad.shape[-1]
    gathered = y_pad[flat_e, slot_c]                          # (Tk, d)
    gathered = gathered * (top_w.reshape(-1) * keep).to(y_pad.dtype)[:, None]
    return gathered.reshape(T, k, d).sum(1)


def _moe_capacity(w, xf, top_w, top_i, cfg):
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = max(1, int(math.ceil(T * k / E * cfg.capacity_factor)))
    C = min(C, T)
    buf, slot_c, keep, flat_e = _dispatch(xf, top_i, C, E, k)
    y = _expert_ffn(w["experts"], buf[:, :C], cfg)            # (E, C, d)
    y = F.pad(y, (0, 0, 0, 1))                                # slot C == 0
    return _combine(y, top_w, slot_c, keep, flat_e, T, k)


def moe_apply(w, x, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux loss)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    top_w, top_i, aux = _route(w, xf, cfg)
    if B * S <= 2 * cfg.n_experts:
        y = _moe_dense(w, xf, top_w, top_i, cfg)
    else:
        y = _moe_capacity(w, xf, top_w, top_i, cfg)
    if "shared" in w:
        y = y + mlp_apply(w["shared"], xf, cfg)
    return y.reshape(B, S, d), aux
