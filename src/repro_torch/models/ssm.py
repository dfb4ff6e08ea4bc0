"""State-space sequence mixers (the port of ``repro/models/ssm.py``).

* ``mamba_*`` — selective SSM branch (Hymba's parallel attn+SSM heads).
  The full sequence runs a log-depth doubling scan over the sequence
  (``selective_scan``: the reference's ``jax.lax.associative_scan``
  associates in another order, so the two agree to rounding, not bit for
  bit); decode is a single recurrent update, O(1) in context length.
* ``rwkv6_*`` — RWKV-6 "Finch" time-mix with data-dependent decay (DDLerp
  low-rank modulation) + channel-mix.  Attention-free; the decode state is
  a constant-size (H, hd, hd) matrix per layer.  The WKV recurrence runs
  step by step (``_wkv_step_scan``, S steps as the reference's
  ``jax.lax.scan``) or chunk-parallel (``_wkv_chunked``, ``rwkv_chunk``).

Plain functions on tensors; the decode functions return the new state
(cast to the state's dtype, as the reference rounds it after every step)
and leave writing it to the caller.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


# ===========================================================================
# Mamba-style selective SSM (Hymba branch)
# ===========================================================================
def mamba_spec(cfg) -> dict:
    d = cfg.d_model
    dI = cfg.d_model            # Hymba: SSM head width matches model dim
    N = cfg.ssm_state
    K = cfg.ssm_conv
    dt_rank = max(1, d // 16)
    return {
        "w_in": ParamSpec((d, 2 * dI), ("d_model", "ffn")),
        "conv": ParamSpec((K, dI), ("conv", "ffn"), "scaled", 1.0),
        "w_bcdt": ParamSpec((dI, 2 * N + dt_rank), ("ffn", "state")),
        "w_dt": ParamSpec((dt_rank, dI), ("state", "ffn")),
        "dt_bias": ParamSpec((dI,), ("ffn",), "zeros"),
        "a_log": ParamSpec((dI, N), ("ffn", "state"), "ones"),
        "d_skip": ParamSpec((dI,), ("ffn",), "ones"),
        "w_out": ParamSpec((dI, d), ("ffn", "d_model")),
    }


def _split(tp, flag: str) -> bool:
    """Whether the model axis ``tp`` splits the dims on ``flag``."""
    return tp is not None and getattr(tp, flag)


def _mamba_inner(w, xz, cfg, conv_state=None, tp=None):
    """Shared projection part.  xz: (B,S,2*dI) -> (x_conv, z, dt, Bm, Cm,
    the conv window's last K-1 inputs).  With mamba's channels split over
    the model axis (``tp.ffn``) xz is this rank's block of ``[x | z]``:
    it is gathered whole and the rank takes its channels of x and of z;
    ``w_bcdt``'s product is summed over the group, and B, C and dt pass
    ``copy_in`` (every rank's channels read them)."""
    dI = cfg.d_model
    N = cfg.ssm_state
    split = _split(tp, "ffn")
    if split:
        xz = tp.gather_split(xz)
        lo, hi = tp.channel_block(dI)
        x, z = xz[..., lo:hi], xz[..., dI + lo:dI + hi]
    else:
        x, z = xz[..., :dI], xz[..., dI:]
    # depthwise causal conv over seq
    K = w["conv"].shape[0]
    S = x.shape[1]
    if conv_state is None:
        pads = F.pad(x, (0, 0, K - 1, 0))
    else:
        pads = torch.cat([conv_state.to(x.dtype), x], dim=1)
    xc = sum(pads[:, i:i + S, :] * w["conv"][i].to(x.dtype)
             for i in range(K))
    xc = F.silu(xc)
    bcdt = xc @ w["w_bcdt"].to(x.dtype)
    if split:
        bcdt = tp.copy_in(tp.reduce(bcdt))
    Bm, Cm, dt_low = bcdt[..., :N], bcdt[..., N:2 * N], bcdt[..., 2 * N:]
    dt = F.softplus(dt_low @ w["w_dt"].to(x.dtype)
                    + w["dt_bias"].to(x.dtype))                  # (B,S,dI)
    new_conv_state = pads[:, -(K - 1):, :] if K > 1 else None
    return xc, z, dt, Bm, Cm, new_conv_state


def _mamba_in(w, x, tp):
    """x @ w_in, x through ``copy_in`` when the channels are split."""
    if _split(tp, "ffn"):
        x = tp.copy_in(x)
    return x @ w["w_in"].to(x.dtype)


def _mamba_out(w, y, tp):
    """y @ w_out, summed over the group when the channels are split."""
    out = y @ w["w_out"].to(y.dtype)
    return tp.reduce(out) if _split(tp, "ffn") else out


def selective_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over dim 1 from h_{-1} = 0, for a, b of
    shape (B, S, ...): ceil(log2 S) doubling passes (Hillis-Steele), each
    combining every position with the one 2^i before it, so the sequence
    costs log2 S launches, not S.  Deterministic: elementwise ops only.
    Differentiable; autograd keeps each pass's (a, b), ~2·log2 S tensors
    of a's size."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:               # the last pass needs no new a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def mamba_apply(w, x, cfg, tp=None):
    """Full-sequence selective scan.  x: (B,S,d) -> (B,S,d).  ``tp``: the
    model axis, its block of the channels (``_mamba_inner``)."""
    dt_ = x.dtype
    xz = _mamba_in(w, x, tp)
    xc, z, dt, Bm, Cm, _ = _mamba_inner(w, xz, cfg, tp=tp)
    A = -torch.exp(w["a_log"].float())                        # (dI,N)
    # discretize: a = exp(dt*A), b = dt * B_t * x_t
    dtf = dt.float()
    a = torch.exp(dtf[..., None] * A)                         # (B,S,dI,N)
    b = (dtf * xc.float())[..., None] * Bm.float()[..., None, :]
    h = selective_scan(a, b)
    y = (h * Cm.float()[..., None, :]).sum(-1)                # (B,S,dI)
    y = y + w["d_skip"].float() * xc.float()
    y = y.to(dt_) * F.silu(z)
    return _mamba_out(w, y, tp)


def mamba_state_spec(cfg, batch: int, tp=None) -> dict:
    """The decode state's specs; on the model axis (``tp.ffn``) this
    rank's channels."""
    dI, N, K = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    if _split(tp, "ffn"):
        dI //= tp.size
    return {
        "h": ParamSpec((batch, dI, N), ("batch", "ffn", "state"), "zeros"),
        "conv": ParamSpec((batch, K - 1, dI), ("batch", "conv", "ffn"),
                          "zeros"),
    }


def mamba_decode(w, x, state, cfg, tp=None):
    """One step.  x: (B,1,d); state: {"h": (B,dI,N), "conv": (B,K-1,dI)}
    (this rank's channels on the model axis).
    -> (out (B,1,d), new state in the state's dtypes)."""
    dt_ = x.dtype
    xz = _mamba_in(w, x, tp)
    xc, z, dt, Bm, Cm, new_conv = _mamba_inner(w, xz, cfg,
                                               conv_state=state["conv"],
                                               tp=tp)
    A = -torch.exp(w["a_log"].float())
    dtf = dt[:, 0].float()                                    # (B,dI)
    a = torch.exp(dtf[..., None] * A)                         # (B,dI,N)
    b = (dtf * xc[:, 0].float())[..., None] * Bm[:, 0].float()[:, None, :]
    h = a * state["h"].float() + b
    y = (h * Cm[:, 0].float()[:, None, :]).sum(-1)
    y = y + w["d_skip"].float() * xc[:, 0].float()
    y = (y.to(dt_) * F.silu(z[:, 0]))[:, None, :]
    out = _mamba_out(w, y, tp)
    new_state = {"h": h.to(state["h"].dtype),
                 "conv": new_conv.to(state["conv"].dtype)}
    return out, new_state


# ===========================================================================
# RWKV-6 "Finch"
# ===========================================================================
def rwkv6_spec(cfg) -> dict:
    d = cfg.d_model
    H = cfg.rwkv_heads
    hd = cfg.rwkv_head_dim
    L = cfg.rwkv_lora
    ff = cfg.d_ff
    return {
        "tm": {  # time mix
            "mu_x": ParamSpec((d,), ("d_model",), "zeros"),
            "mu": ParamSpec((5, d), (None, "d_model"), "zeros"),  # r,k,v,g,w
            "lora_a": ParamSpec((d, 5 * 32), ("d_model", "lora")),
            "lora_b": ParamSpec((5, 32, d), (None, "lora", "d_model"),
                                "scaled", 0.1),
            "w_r": ParamSpec((d, d), ("d_model", "heads_x_dim")),
            "w_k": ParamSpec((d, d), ("d_model", "heads_x_dim")),
            "w_v": ParamSpec((d, d), ("d_model", "heads_x_dim")),
            "w_g": ParamSpec((d, d), ("d_model", "heads_x_dim")),
            "w0": ParamSpec((d,), ("d_model",), "zeros"),
            "decay_a": ParamSpec((d, L), ("d_model", "lora")),
            "decay_b": ParamSpec((L, d), ("lora", "d_model"), "scaled", 0.1),
            "u": ParamSpec((H, hd), ("heads", "head_dim"), "zeros"),
            "ln_scale": ParamSpec((d,), ("d_model",), "ones"),
            "w_o": ParamSpec((d, d), ("heads_x_dim", "d_model")),
        },
        "cm": {  # channel mix
            "mu_k": ParamSpec((d,), ("d_model",), "zeros"),
            "mu_r": ParamSpec((d,), ("d_model",), "zeros"),
            "w_k": ParamSpec((d, ff), ("d_model", "ffn")),
            "w_v": ParamSpec((ff, d), ("ffn", "d_model")),
            "w_r": ParamSpec((d, d), ("d_model", "d_model")),
        },
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros / carried state at t=0)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x.shape[1] > 1:
        return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)
    return prev[:, None, :]


def _ddlerp(w, x, xx):
    """Data-dependent lerp -> the 5 mixed inputs (r,k,v,g,w)."""
    dt_ = x.dtype
    base = x + (xx - x) * w["mu_x"].to(dt_)
    dd = torch.tanh(base @ w["lora_a"].to(dt_))              # (B,S,5*32)
    B_, S_, _ = dd.shape
    dd = dd.reshape(B_, S_, 5, 32)
    mod = torch.einsum("bsfl,fld->bsfd", dd, w["lora_b"].to(dt_))
    mix = w["mu"].to(dt_)[None, None] + mod                  # (B,S,5,d)
    return x[:, :, None, :] + (xx - x)[:, :, None, :] * mix


def _rwkv_rkvgw(tm, x, xx, cfg, tp=None):
    """-> (r, k, v, g, the decay), on the model axis
    (``tp.heads_x_dim``) this rank's channels of each: the mixed inputs
    of the four column-parallel products pass ``copy_in``; the decay is
    computed whole, and passes ``copy_in`` before the rank takes its
    channels (so its leaves' gradients are whole on every rank)."""
    dt_ = x.dtype
    mixed = _ddlerp(tm, x, xx)
    split = _split(tp, "heads_x_dim")
    if split:
        rkvg = tp.copy_in(mixed[:, :, :4])
        xr, xk, xv, xg = [rkvg[:, :, i] for i in range(4)]
        xw = mixed[:, :, 4]
    else:
        xr, xk, xv, xg, xw = [mixed[:, :, i] for i in range(5)]
    r = xr @ tm["w_r"].to(dt_)
    k = xk @ tm["w_k"].to(dt_)
    v = xv @ tm["w_v"].to(dt_)
    g = F.silu(xg @ tm["w_g"].to(dt_))
    # the decay in f32 matmuls (TF32 must stay off for them)
    dec = tm["w0"].float() + torch.tanh(
        xw.float() @ tm["decay_a"].float()) @ tm["decay_b"].float()
    if split:
        lo, hi = tp.channel_block(cfg.d_model)
        dec = tp.copy_in(dec)[..., lo:hi]
    wdecay = torch.exp(-torch.exp(dec))                      # (B,S,d) in (0,1)
    return r, k, v, g, wdecay


def _heads(x, H, hd):
    B, S, _ = x.shape
    return x.reshape(B, S, H, hd)


def _wkv_step_scan(rh, kh, vh, wh, u, s0):
    """The step-by-step recurrence.  (B,H,S,hd) heads-major inputs.
    -> ((B,H,S,hd), final state (B,H,hd,hd)).

    The reference's step, ``out_t = r_t · (s + u ∘ k_t v_tᵀ)``, ``s = w_t
    ∘ s + k_t v_tᵀ``, regrouped so that a step is three launches: the
    bonus term ``(r_t · (u ∘ k_t)) v_t`` for every t at once before the
    loop, then per step ``r_t · s`` (a bmm), ``w_t ∘ s`` and ``+ k_t v_tᵀ``
    (a baddbmm of a rank-1 product).  The sums run in another order than
    the reference's; the S sequential steps stay."""
    B, H, S, hd = rh.shape
    bonus = (rh * u[:, None, :] * kh).sum(-1, keepdim=True) * vh

    def steps(t, shape):             # (S, B*H, *shape), each step contiguous
        return t.permute(2, 0, 1, 3).reshape((S, B * H) + shape)

    r3, k3 = steps(rh, (1, hd)), steps(kh, (hd, 1))
    v3, w3 = steps(vh, (1, hd)), steps(wh, (hd, 1))
    s = s0.reshape(B * H, hd, hd)
    outs = []
    for t in range(S):
        outs.append(torch.bmm(r3[t], s))
        s = torch.baddbmm(w3[t] * s, k3[t], v3[t])
    y = torch.stack(outs).reshape(S, B, H, hd).permute(1, 2, 0, 3)
    return y + bonus, s.reshape(B, H, hd, hd)


def _wkv_chunked(rh, kh, vh, wh, u, s0, chunk: int):
    """Chunked-parallel WKV6 (beyond-paper prefill optimization).

    Within a chunk of length L the recurrence unrolls into two matmuls
    via cumulative log-decays::

        out_t = â_t @ S_0 + [strict_tril(â k̃ᵀ) + diag(r·u·k)] @ V
        â_t = r_t ∘ exp(cum_{t-1}),  k̃_j = k_j ∘ exp(-cum_j)
        S_L  = exp(cum_L) ∘ S_0 + (k ∘ exp(cum_L - cum_j))ᵀ V

    which turns S sequential steps into S/L iterations of matmuls.
    exp(-cum_j) grows with the in-chunk decay sum, so L is kept small.
    inputs: (B,H,S,hd) heads-major.  Returns ((B,H,S,hd), S_end)."""
    B, H, S, hd = rh.shape
    L = chunk
    assert S % L == 0
    n = S // L

    def resh(t):
        return t.reshape(B, H, n, L, hd).permute(2, 0, 1, 3, 4)

    rc, kc, vc = resh(rh), resh(kh), resh(vh)
    logw = torch.log(torch.clamp_min(resh(wh.float()), 1e-38))
    tri = torch.tril(torch.ones((L, L), dtype=torch.float32,
                                device=rh.device), diagonal=-1)
    s = s0
    outs = []
    for i in range(n):
        r, k, v, lw = rc[i], kc[i], vc[i], logw[i]          # (B,H,L,hd)
        cum = torch.cumsum(lw, dim=2)                       # cum_j, j=1..L
        cum_prev = cum - lw                                 # cum_{t-1}
        a_hat = r * torch.exp(cum_prev)
        k_tilde = k * torch.exp(-cum)
        scores = torch.einsum("bhtk,bhjk->bhtj", a_hat, k_tilde) * tri
        # u is (H, hd): the in-place bonus term, diagonal of the scores
        d_t = torch.einsum("bhtk,hk,bhtk->bht", r, u, k)
        outs.append(torch.einsum("bhtj,bhjv->bhtv", scores, v)
                    + torch.einsum("bhtk,bhkv->bhtv", a_hat, s)
                    + d_t[..., None] * v)
        k_hat = k * torch.exp(cum[:, :, -1:, :] - cum)
        s = torch.exp(cum[:, :, -1, :])[..., None] * s + \
            torch.einsum("bhjk,bhjv->bhkv", k_hat, v)
    y = torch.stack(outs).permute(1, 2, 0, 3, 4).reshape(B, H, S, hd)
    return y, s


def rwkv6_time_mix(tm, x, cfg, state=None, tp=None):
    """Full-sequence WKV6.  x: (B,S,d).  Returns (y, new state: the f32
    wkv matrix and the last input, the next call's shift).  On the model
    axis (``tp.heads_x_dim``) the rank runs its heads (its block of the
    channels, whole heads): the wkv state holds them, ``ln_scale`` (whole)
    passes ``copy_in`` before the rank takes its channels, and ``w_o``'s
    partial output is summed over the group."""
    B, S, _ = x.shape
    prev = None if state is None else state.get("shift")
    xx = _shift(x, prev)
    r, k, v, g, wdecay = _rwkv_rkvgw(tm, x, xx, cfg, tp)
    hd = cfg.rwkv_head_dim
    d = r.shape[-1]                               # this rank's channels
    H = d // hd

    def to_heads(t):                                          # (B,H,S,hd)
        return _heads(t, H, hd).transpose(1, 2)

    rh = to_heads(r).float()
    kh = to_heads(k).float()
    vh = to_heads(v).float()
    wh = to_heads(wdecay)
    u = tm["u"].float()

    s0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
          if state is None else state["wkv"].float())

    chunk = cfg.rwkv_chunk
    if chunk and S % chunk == 0 and S > chunk:
        outs, s_fin = _wkv_chunked(rh, kh, vh, wh, u, s0, chunk)
    else:
        outs, s_fin = _wkv_step_scan(rh, kh, vh, wh, u, s0)
    y = outs.transpose(1, 2).reshape(B, S, d)
    # per-head groupnorm
    yh = y.reshape(B, S, H, hd)
    mu = yh.mean(-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    ln = tm["ln_scale"]
    split = _split(tp, "heads_x_dim")
    if split:
        lo, hi = tp.channel_block(cfg.d_model)
        ln = tp.copy_in(ln)[lo:hi]
    y = yh.reshape(B, S, d) * ln.float()
    y = (y.to(x.dtype) * g) @ tm["w_o"].to(x.dtype)
    if split:
        y = tp.reduce(y)
    return y, {"wkv": s_fin, "shift": x[:, -1, :]}


def rwkv6_channel_mix(cm, x, state=None, tp=None):
    """On the model axis (``tp.ffn``) ``w_k``'s columns and ``w_v``'s rows
    are this rank's, the product summed over the group; ``w_r`` whole."""
    dt_ = x.dtype
    prev = None if state is None else state.get("shift")
    xx = _shift(x, prev)
    xk = x + (xx - x) * cm["mu_k"].to(dt_)
    xr = x + (xx - x) * cm["mu_r"].to(dt_)
    split = _split(tp, "ffn")
    if split:
        xk = tp.copy_in(xk)
    kk = torch.square(F.relu(xk @ cm["w_k"].to(dt_)))
    kv = kk @ cm["w_v"].to(dt_)
    if split:
        kv = tp.reduce(kv)
    out = torch.sigmoid(xr @ cm["w_r"].to(dt_)) * kv
    return out, {"shift": x[:, -1, :]}


def rwkv6_state_spec(cfg, batch: int, tp=None) -> dict:
    """The decode state's specs; on the model axis
    (``tp.heads_x_dim``) this rank's heads of ``wkv``."""
    H, hd, d = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    if _split(tp, "heads_x_dim"):
        H //= tp.size
    return {
        "wkv": ParamSpec((batch, H, hd, hd), ("batch", "heads", "state",
                                              "state"), "zeros"),
        "tm_shift": ParamSpec((batch, d), ("batch", "d_model"), "zeros"),
        "cm_shift": ParamSpec((batch, d), ("batch", "d_model"), "zeros"),
    }
