"""Shared model building blocks (the port of ``repro/models/common.py``).

Parameters are declared as ``ParamSpec`` trees, the single source of
shape and initializer; ``materialize`` draws real tensors from a
``torch.Generator`` on an explicit device.  The draws cannot equal JAX's:
parity tests carry the reference's parameters over with ``bridge``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_leaves, tree_map


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed | scaled
    scale: float = 1.0


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_std(spec: ParamSpec) -> float:
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[0], 1)
    if spec.init == "embed":
        return 0.02
    if spec.init == "scaled":
        return spec.scale / math.sqrt(fan_in)
    return 1.0 / math.sqrt(fan_in)


def init_leaf(spec: ParamSpec, generator, device, dtype, std=None):
    """One leaf; ``std`` overrides the spec's own (see ``model.init_layers``)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * (init_std(spec) if std is None else std)).to(dtype)


def materialize(spec_tree, generator, device, dtype=torch.float32):
    """Draw every leaf of a spec tree, in flatten order, from ``generator``
    (which must live on ``device``'s type)."""
    return tree_map(lambda s: init_leaf(s, generator, device, dtype),
                    spec_tree, is_leaf=is_spec)


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim of size ``n`` to every spec in the tree."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                            s.scale),
        spec_tree, is_leaf=is_spec)


def param_bytes(spec_tree, bytes_per_el: int = 4) -> int:
    """Bytes of every leaf of a ParamSpec tree at ``bytes_per_el``."""
    return sum(math.prod(s.shape) * bytes_per_el
               for s in tree_leaves(spec_tree, is_leaf=is_spec))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_spec(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("d_model",), "ones")}


def layernorm_spec(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("d_model",), "ones"),
            "bias": ParamSpec((d,), ("d_model",), "zeros")}


def norm_spec(cfg) -> dict:
    return (layernorm_spec(cfg.d_model) if cfg.norm_type == "layernorm"
            else rmsnorm_spec(cfg.d_model))


def apply_norm(w, x, eps: float = 1e-6):
    """LayerNorm (``bias`` present) or RMSNorm, in f32, cast back to x's
    dtype.  RMSNorm runs K5 (the CUDA kernel for a CUDA tensor, its plain
    version for a CPU one): through ``kernels.ops.rmsnorm_diff`` while
    grad is enabled, so the vjp reaches x and the scale; through the
    forward-only ``kernels.ops.rmsnorm`` otherwise (serving's short launch
    path).  LayerNorm is plain torch: the reference has no kernel for
    it."""
    if "bias" not in w:
        from repro_torch.kernels import ops as kops
        if torch.is_grad_enabled():
            return kops.rmsnorm_diff(x, w["scale"], eps=eps)
        return kops.rmsnorm(x, w["scale"], eps=eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * w["scale"].float() + w["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations (jax.nn.gelu's default is the tanh approximation)
# ---------------------------------------------------------------------------
def act_fn(name: str) -> Callable:
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE — interleaved pairs (0::2, 1::2), not halves
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    rd = int(d * fraction)
    rd -= rd % 2
    if rd == 0:
        return x
    xr, xp = x[..., :rd], x[..., rd:]
    freqs = rope_freqs(rd, theta, x.device)                 # (rd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, rd/2)
    ang = ang[..., None, :]                                 # over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < d else out


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _vocab_split(tp) -> bool:
    return tp is not None and tp.vocab


def embed_tokens(w, tokens, cfg, dtype, tp=None):
    """Plain embedding row lookup — no scaling for either norm type, so
    ``prepare`` (prefill) and ``decode_embed`` (decode) agree.  Through
    ``F.embedding``, whose backward on CUDA sums each row's gradients
    without atomics (an indexing lookup's backward would accumulate with
    them), so a training step is deterministic.  With a vocab-parallel
    table (``tp.vocab``) the rank's rows, summed over the model group."""
    if _vocab_split(tp):
        return tp.embed(w["tok"], tokens, dtype)
    return F.embedding(tokens, w["tok"]).to(dtype)


def logits_fn(head_w, embed_w, x, cfg, tp=None):
    """The logits of x: with a vocab-parallel head (``tp.vocab``) this
    rank's block of the vocabulary (its input's cotangent summed over the
    model group)."""
    if _vocab_split(tp):
        x = tp.copy_in(x)
    if cfg.tie_embeddings:
        w = embed_w["tok"].to(x.dtype).T
    else:
        w = head_w["out"].to(x.dtype)
    logits = x @ w
    if cfg.logit_soft_cap > 0:
        c = cfg.logit_soft_cap
        logits = c * torch.tanh(logits / c)
    return logits


def softmax_xent(logits, targets, mask, tp=None):
    """Cross-entropy, f32 reduction.  mask: (B,S) weights.
    -> (loss_sum, weight_sum).  Over vocab-parallel logits
    (``tp.vocab``): ``tp.xent``."""
    if _vocab_split(tp):
        return tp.xent(logits, targets, mask)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()
