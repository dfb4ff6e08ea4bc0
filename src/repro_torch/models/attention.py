"""Attention (the port of ``repro/models/attention.py``): GQA / MHA
projections, chunked online-softmax ``attend``, the full-sequence path
through the flash kernel (K2), decode against a ring-buffer KV cache,
plain or with the KV heads kept grouped (``attend_grouped_decode``), and
MLA (DeepSeek-V2): the full-sequence ``mla_attention`` (plain ``attend``,
as the reference's, even with ``use_pallas``) and the absorbed decode
against the compressed cache (``decode_mla_attention``), and whisper's
cross-attention (``cross_attention``, plain ``attend`` as the reference's).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (ParamSpec, apply_norm, apply_rope,
                                       rmsnorm_spec)

NEG_INF = -1.0e30


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
def gqa_spec(cfg) -> dict:
    """Self- or cross-attention projections (whisper's decoder has both):
    one layout, as in the reference."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    spec = {
        "wq": ParamSpec((d, H, Dh), ("d_model", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, Dh), ("d_model", "kv", "head_dim")),
        "wv": ParamSpec((d, KV, Dh), ("d_model", "kv", "head_dim")),
        "wo": ParamSpec((H, Dh, d), ("heads", "head_dim", "d_model")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((H, Dh), ("heads", "head_dim"), "zeros")
        spec["bk"] = ParamSpec((KV, Dh), ("kv", "head_dim"), "zeros")
        spec["bv"] = ParamSpec((KV, Dh), ("kv", "head_dim"), "zeros")
    if cfg.o_bias:
        spec["bo"] = ParamSpec((d,), ("d_model",), "zeros")
    return spec


def mla_spec(cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": ParamSpec((d, H, nd + rd), ("d_model", "heads", "head_dim")),
        "w_dkv": ParamSpec((d, r), ("d_model", "lora")),
        "w_kr": ParamSpec((d, rd), ("d_model", "head_dim")),
        "kv_norm": rmsnorm_spec(r)["scale"]._replace(axes=("lora",)),
        "w_uk": ParamSpec((r, H, nd), ("lora", "heads", "head_dim")),
        "w_uv": ParamSpec((r, H, vd), ("lora", "heads", "head_dim")),
        "wo": ParamSpec((H, vd, d), ("heads", "head_dim", "d_model")),
    }


# ---------------------------------------------------------------------------
# Core softmax attention (chunked online softmax)
# ---------------------------------------------------------------------------
def _mask(q_pos, k_pos, causal: bool, window: int):
    """q_pos: (B,Sq), k_pos: (B,Sk) -> allow (B,1,Sq,Sk).  Slots with
    k_pos < 0 are invalid (ring-buffer holes, padding)."""
    qp = q_pos[:, None, :, None]
    kp = k_pos[:, None, None, :]
    allow = kp >= 0
    if causal:
        allow = allow & (kp <= qp)
    if window > 0:
        allow = allow & (qp - kp < window)
    return allow


def attend(q, k, v, q_pos, k_pos, *, causal: bool, window: int = 0,
           chunk: int = 0, soft_cap: float = 0.0):
    """q: (B,Sq,H,D); k,v: (B,Sk,H,D) (kv heads already expanded).

    Returns (B,Sq,H,D).  ``chunk`` > 0 streams over KV chunks with an
    online softmax so the (Sq,Sk) score matrix is never whole."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf = (q * scale).float()

    def scores_of(k_c, kpos_c):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float())
        if soft_cap > 0:
            s = soft_cap * torch.tanh(s / soft_cap)
        allow = _mask(q_pos, kpos_c, causal, window)
        return torch.where(allow, s, torch.full_like(s, NEG_INF))

    if chunk <= 0 or Sk <= chunk:
        s = scores_of(k, k_pos)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        o = o / l.clamp_min(1e-30).permute(0, 2, 1, 3)
        return o.to(q.dtype)

    pad = (-Sk) % chunk
    if pad:
        # pad KV to a chunk multiple; padded slots get k_pos = -1 (masked)
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        Sk += pad
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, chunk):
        s = scores_of(k[:, c0:c0 + chunk], k_pos[:, c0:c0 + chunk])
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v[:, c0:c0 + chunk].float())
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 2, 1, 3).to(q.dtype)


def attend_grouped_decode(q, k, v, q_pos, k_pos, *, causal: bool,
                          window: int = 0, soft_cap: float = 0.0):
    """Decode attention without expanding the KV heads
    (``cfg.grouped_decode_attn``): q's heads are viewed as (KV, G) groups
    and each einsum contracts against the cache's own KV heads.

    q: (B,Sq,H,D); k,v: (B,S,KV,D) -> (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    q5 = (q * scale).reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", q5, k.float())
    if soft_cap > 0:
        s = soft_cap * torch.tanh(s / soft_cap)
    allow = _mask(q_pos, k_pos, causal, window)          # (B,1,Sq,S)
    s = torch.where(allow[:, :, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def expand_kv(k, n_q_per_kv: int):
    """(B,S,KV,D) -> (B,S,KV*n,D) by repeating each kv head."""
    if n_q_per_kv == 1:
        return k
    B, S, KV, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_q_per_kv, D) \
        .reshape(B, S, KV * n_q_per_kv, D)


# ---------------------------------------------------------------------------
# GQA self attention (prefill: full sequence)
# ---------------------------------------------------------------------------
def _proj(x, w):
    """einsum("bsd,dhe->bshe") as one matmul over the flattened heads."""
    d, Hn, E = w.shape
    return (x @ w.to(x.dtype).reshape(d, Hn * E)).unflatten(-1, (Hn, E))


def _heads_split(tp) -> bool:
    return tp is not None and tp.heads


def _kv_leaves(w, tp):
    """(wk, wv, bk, bv) as this rank computes with them: as given when
    they are split over the model axis (or nothing is), else the whole
    leaves' kv heads of ``tp.kv_block()``, through ``copy_in`` so their
    gradients (each rank's part) are summed over the group."""
    kv = [w["wk"], w["wv"], w.get("bk"), w.get("bv")]
    if not _heads_split(tp) or tp.kv:
        return kv
    lo, hi = tp.kv_block()
    return [None if a is None else tp.copy_in(a)[..., lo:hi, :]
            for a in kv]


def qkv_project(w, x, cfg, positions, *, rope: bool = True, tp=None):
    """q, k, v of x.  With the heads split over the model axis
    (``tp.heads``) this rank's q heads and the kv heads they read; x's
    cotangent is summed over the group."""
    dt = x.dtype
    wk, wv, bk, bv = _kv_leaves(w, tp)
    if _heads_split(tp):
        x = tp.copy_in(x)
    q, k, v = _proj(x, w["wq"]), _proj(x, wk), _proj(x, wv)
    if "bq" in w:
        q = q + w["bq"].to(dt)
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def out_project(w, o, tp=None):
    """einsum("bshe,hed->bsd"); with the heads split over the model axis
    (``tp.heads``) the rank's partial sum, summed over the group, then
    ``bo`` once."""
    H, E, d = w["wo"].shape
    y = o.reshape(*o.shape[:-2], H * E) @ w["wo"].to(o.dtype).reshape(H * E, d)
    if _heads_split(tp):
        y = tp.reduce(y)
    if "bo" in w:
        y = y + w["bo"].to(o.dtype)
    return y


def uses_flash(x, cfg) -> bool:
    """Whether full-sequence self attention runs the flash kernel (K2, K3a
    and K3b under grad): with ``cfg.use_pallas`` (on the CPU the kernels'
    plain versions), and on a CUDA tensor for every family but audio.
    Whisper's 1500 encoder frames do not tile by the kernel's 128-row
    block (the reference's contract), so on the card as on the CPU the
    audio family takes the reference's choice, ``use_pallas``."""
    return cfg.use_pallas or (x.device.type == "cuda"
                              and cfg.family != "audio")


def self_attention(w, x, cfg, positions, *, causal: bool = True,
                   window: int = 0, rope: bool = True, tp=None):
    """Full-sequence self attention (prefill, training): the flash kernel
    (K2, which reads the KV heads unexpanded) where ``uses_flash``, else
    ``attend``; on the heads ``tp`` gives this rank (all without one)."""
    q, k, v = qkv_project(w, x, cfg, positions, rope=rope, tp=tp)
    if uses_flash(x, cfg):
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q, k, v, causal=causal, window=window,
                                 soft_cap=0.0)
    else:
        g = q.shape[2] // k.shape[2]
        o = attend(q, expand_kv(k, g), expand_kv(v, g), positions,
                   positions, causal=causal, window=window,
                   chunk=cfg.attn_chunk)
    return out_project(w, o, tp)


def cross_kv(w, mem, tp=None):
    """The cross-attention K/V of ``mem`` (B,Sm,d) on the kv heads this
    rank computes with (all without a split): the input of the training
    path and of ``core.decode.encode_cross_kv``'s cache rows alike."""
    dt = mem.dtype
    wk, wv, bk, bv = _kv_leaves(w, tp)
    k, v = _proj(mem, wk), _proj(mem, wv)
    if bk is not None:
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    return k, v


def cross_attention(w, x, mem, cfg, positions, mem_positions, tp=None):
    """x (B,S,d) attends to ``mem`` (B,Sm,d), whisper's decoder to the
    encoder's output: the plain ``attend``, unmasked, as the reference's
    (no kernel on either device).  With the heads split over the model
    axis (``tp.heads``) on this rank's q and kv heads, summed over the
    group, then ``bo`` once.  ``x`` and ``mem`` both pass ``copy_in``:
    without the second a rank's memory cotangent would hold only its own
    heads' share, and every encoder gradient after it would be wrong."""
    dt = x.dtype
    if _heads_split(tp):
        x, mem = tp.copy_in(x), tp.copy_in(mem)
    q = _proj(x, w["wq"])
    if "bq" in w:
        q = q + w["bq"].to(dt)
    k, v = cross_kv(w, mem, tp)
    g = q.shape[2] // k.shape[2]
    o = attend(q, expand_kv(k, g), expand_kv(v, g), positions, mem_positions,
               causal=False, chunk=0)
    return out_project(w, o, tp)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): full sequence
# ---------------------------------------------------------------------------
def _mla_latent(w, x, cfg, positions):
    """The compressed KV of x: the normed latent c (B,S,r) — RMSNorm at
    width r, K5 on the card — and the shared rope key kr (B,S,1,rd)."""
    dt = x.dtype
    c = x @ w["w_dkv"].to(dt)
    c = apply_norm({"scale": w["kv_norm"]}, c, cfg.norm_eps)
    kr = (x @ w["w_kr"].to(dt))[:, :, None, :]
    return c, apply_rope(kr, positions, cfg.rope_theta)


def _mla_heads_in(x, c, kr, tp):
    """The inputs of MLA's per-head products as this rank uses them.  With
    the heads split over the model axis, ``x`` (for ``wq``), the normed
    latent ``c`` and the rope key ``kr`` pass ``copy_in``: their
    cotangents from the local heads are summed over the group.  The ``x``
    that feeds ``w_dkv`` / ``w_kr`` does not (that path is whole on every
    rank: a sum would count it M times)."""
    if not _heads_split(tp):
        return x, c, kr
    return tp.copy_in(x), tp.copy_in(c), tp.copy_in(kr)


def mla_attention(w, x, cfg, positions, *, causal: bool = True,
                  window: int = 0, tp=None):
    """MLA over the full sequence; with the heads split over the model
    axis (``tp.heads``) on this rank's heads of ``wq``, ``w_uk``, ``w_uv``
    and ``wo`` (summed over the group), the latent whole on every rank."""
    B, S, _ = x.shape
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    c, k_rope = _mla_latent(w, x, cfg, positions)
    xq, c, k_rope = _mla_heads_in(x, c, k_rope, tp)
    q = _proj(xq, w["wq"])                                   # (B,S,H,nd+rd)
    H = q.shape[2]
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_nope = _proj(c, w["w_uk"])
    v = _proj(c, w["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    # v padded up to the qk width for the shared attend, then sliced back
    # (prefill then equals the absorbed decode, as in the reference)
    vp = torch.nn.functional.pad(v, (0, qq.shape[-1] - v.shape[-1]))
    o = attend(qq, k, vp, positions, positions, causal=causal, window=window,
               chunk=cfg.attn_chunk)[..., :cfg.v_head_dim]
    return out_project(w, o, tp)


# ---------------------------------------------------------------------------
# KV caches and decode
# ---------------------------------------------------------------------------
def kv_cache_spec(cfg, batch: int, seq: int, tp=None) -> dict:
    """Per-layer cache spec (the model prepends the layer stack dim).
    ``seq`` is the live cache length: the full context, or the ring
    window for long-context decode.  MLA caches the compressed latent
    ``c`` and the rope key ``kr``.  On the model axis the cache holds the
    kv heads this rank computes with (``tp.local_kv_heads()``)."""
    if cfg.use_mla:
        r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
        return {
            "c": ParamSpec((batch, seq, r), ("batch", "seq", "lora"), "zeros"),
            "kr": ParamSpec((batch, seq, rd), ("batch", "seq", "head_dim"),
                            "zeros"),
            "pos": ParamSpec((batch, seq), ("batch", "seq"), "zeros"),
        }
    KV = cfg.n_kv_heads if tp is None else tp.local_kv_heads()
    Dh = cfg.d_head
    return {
        "k": ParamSpec((batch, seq, KV, Dh), ("batch", "seq", "kv", "head_dim"),
                       "zeros"),
        "v": ParamSpec((batch, seq, KV, Dh), ("batch", "seq", "kv", "head_dim"),
                       "zeros"),
        "pos": ParamSpec((batch, seq), ("batch", "seq"), "zeros"),
    }


def _is_scalar(cur_pos) -> bool:
    return not torch.is_tensor(cur_pos) or cur_pos.dim() == 0


def decode_positions(x, cur_pos):
    """A decode position argument as a (B, T) int32 tensor: a scalar (one
    shared absolute position) or per-row (B,) / (B, T) positions, where
    negative entries mark padding / inactive rows."""
    B, T = x.shape[0], x.shape[1]
    if _is_scalar(cur_pos):
        return torch.full((B, T), int(cur_pos), dtype=torch.int32,
                          device=x.device)
    pos = cur_pos.to(device=x.device, dtype=torch.int32)
    if pos.dim() == 1:
        pos = pos[:, None]
    return pos.expand(B, T)


def ring_scatter(buf, new, pos):
    """In place: ``new[b, t]`` lands at slot ``pos[b, t] % S`` of row b of
    ``buf`` (B, S, ...); entries with ``pos < 0`` are dropped.  Returns
    ``buf``.

    No device sync (a boolean-mask index would wait for the card): a
    dropped entry is aimed at the first kept entry's slot with that
    entry's value — or, when no entry is kept, at ``buf[0, 0]`` with its
    own value — so every duplicate write carries the same bits."""
    B, S = buf.shape[:2]
    valid = (pos >= 0).reshape(-1)
    bidx = torch.arange(B, device=buf.device)[:, None].expand_as(pos) \
        .reshape(-1)
    sidx = torch.remainder(pos, S).reshape(-1).long()
    vals = new.reshape((-1,) + tuple(new.shape[2:])).to(buf.dtype)
    first = torch.argmax(valid.to(torch.int32))       # 0 when none is kept
    some = valid.any()
    b0 = torch.where(some, bidx[first], 0)
    s0 = torch.where(some, sidx[first], 0)
    v0 = torch.where(some, vals[first], buf[0, 0])
    keep = valid.view((-1,) + (1,) * (vals.dim() - 1))
    buf.index_put_((torch.where(valid, bidx, b0),
                    torch.where(valid, sidx, s0)),
                   torch.where(keep, vals, v0))
    return buf


def decode_self_attention(w, x, cache, cfg, cur_pos, *, window: int = 0,
                          rope: bool = True, tp=None):
    """One decode step.  x: (B,T,d); cache: dict from ``kv_cache_spec``,
    UPDATED IN PLACE (the reference returns a new cache; the port writes
    the new k/v/pos into the cache it was given and returns it, so a step
    allocates no second cache); cur_pos: scalar absolute position (T = 1)
    or per-row (B,)/(B,T) positions (negative = padding, no write).

    The new k/v go to slot ``pos % cache_len`` (a ring buffer; for a
    full-context cache that is just ``pos``).  ``tp``: as in
    ``self_attention``, the cache holding this rank's kv heads."""
    dt = x.dtype
    B = x.shape[0]
    if _is_scalar(cur_pos) and x.shape[1] == 1:
        cur = int(cur_pos)
        pos = torch.full((B, 1), cur, dtype=torch.int32, device=x.device)
        q, k_new, v_new = qkv_project(w, x, cfg, pos, rope=rope, tp=tp)
        slot = cur % cache["pos"].shape[1]
        cache["k"][:, slot:slot + 1].copy_(k_new)
        cache["v"][:, slot:slot + 1].copy_(v_new)
        cache["pos"][:, slot] = cur
    else:
        pos = decode_positions(x, cur_pos)
        # rope at clamped positions: padding rows are masked out anyway
        q, k_new, v_new = qkv_project(w, x, cfg, pos.clamp_min(0), rope=rope,
                                      tp=tp)
        ring_scatter(cache["k"], k_new, pos)
        ring_scatter(cache["v"], v_new, pos)
        ring_scatter(cache["pos"], pos, pos)
    if cfg.grouped_decode_attn:
        o = attend_grouped_decode(q, cache["k"].to(dt), cache["v"].to(dt),
                                  pos, cache["pos"], causal=True,
                                  window=window)
    else:
        g = q.shape[2] // cache["k"].shape[2]
        o = attend(q, expand_kv(cache["k"].to(dt), g),
                   expand_kv(cache["v"].to(dt), g), pos,
                   cache["pos"], causal=True, window=window, chunk=0)
    return out_project(w, o, tp), cache


def decode_mla_attention(w, x, cache, cfg, cur_pos, *, window: int = 0,
                         tp=None):
    """Absorbed-matmul MLA decode: scores against the COMPRESSED cache
    (``c``, ``kr``, ``pos``), updated in place as in
    ``decode_self_attention``.  q_nope is absorbed through w_uk into the
    latent space, so a step costs O(S·(r + rd)·H), not O(S·H·(nd + rd)).
    ``cur_pos``: a scalar (T = 1) or per-row (B,)/(B,T) positions,
    negative = padding (no write, masked).  ``tp``: as in
    ``mla_attention``, on this rank's heads against the whole cache."""
    dt = x.dtype
    B = x.shape[0]
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    scalar = _is_scalar(cur_pos) and x.shape[1] == 1
    if scalar:
        pos = torch.full((B, 1), int(cur_pos), dtype=torch.int32,
                         device=x.device)
        rope_pos = pos
    else:
        pos = decode_positions(x, cur_pos)
        rope_pos = pos.clamp_min(0)
    q = _proj(x, w["wq"])                        # this rank's heads
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, rope_pos, cfg.rope_theta)
    c_new, kr_new = _mla_latent(w, x, cfg, rope_pos)
    kr_new = kr_new[:, :, 0, :]
    if scalar:
        slot = int(cur_pos) % cache["pos"].shape[1]
        cache["c"][:, slot:slot + 1].copy_(c_new)
        cache["kr"][:, slot:slot + 1].copy_(kr_new)
        cache["pos"][:, slot] = int(cur_pos)
    else:
        ring_scatter(cache["c"], c_new, pos)
        ring_scatter(cache["kr"], kr_new, pos)
        ring_scatter(cache["pos"], pos, pos)
    c, kr = cache["c"].to(dt), cache["kr"].to(dt)
    # absorb: q_abs = q_nope @ w_uk -> (B,T,H,r)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, w["w_uk"].to(dt))
    scale = 1.0 / math.sqrt(nd + rd)
    s = (torch.einsum("bshr,btr->bhst", q_abs, c)
         + torch.einsum("bshe,bte->bhst", q_rope, kr)).float()
    s = s * scale
    allow = _mask(pos, cache["pos"], True, window)
    s = torch.where(allow, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bhst,btr->bshr", p.to(dt), c)
    o = torch.einsum("bshr,rhe->bshe", ctx_c, w["w_uv"].to(dt))
    return out_project(w, o, tp), cache
