"""MLA (DeepSeek-V2) in the port (``repro_torch.models.attention``) against
the reference's on the same numpy inputs, f32, deepseek-v2-lite smoke
(kv_lora_rank 32, qk 16 + 8, v 16): the full-sequence ``mla_attention``
(whole and KV-chunked softmax), the absorbed ``decode_mla_attention`` at
a scalar position and at per-row positions with padding rows (which
write nothing), the compressed cache's spec and contents, and the
absorbed decode against the full-sequence path (the reference's
``tests/test_decode_consistency.py`` bar, 2e-3 of the largest logit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import decode as jdecode  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import LayeredModel as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import decode  # noqa: E402
from repro_torch.core.decode import init_caches  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params, init_numpy  # noqa: E402,E501

ARCH = "deepseek-v2-lite-16b"


def _cfgs(**kw):
    return (get_config(ARCH, "smoke").replace(dtype="float32", **kw),
            jget_config(ARCH, "smoke").replace(dtype="float32", **kw))


def _weights(cfg, seed=0):
    rs = np.random.RandomState(seed)
    drawn = fan_in_params(attn.mla_spec(cfg), lambda s: rs.randn(*s))
    return {k: np.asarray(v, np.float32) for k, v in drawn.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_kv_cache_spec_is_the_compressed_cache():
    cfg, jcfg = _cfgs()
    spec = attn.kv_cache_spec(cfg, 3, 12)
    jspec = jattn.kv_cache_spec(jcfg, 3, 12)
    assert sorted(spec) == sorted(jspec) == ["c", "kr", "pos"]
    for k in spec:
        assert tuple(spec[k].shape) == tuple(jspec[k].shape)
        assert tuple(spec[k].axes) == tuple(jspec[k].axes)
    assert spec["c"].shape == (3, 12, cfg.kv_lora_rank)
    assert spec["kr"].shape == (3, 12, cfg.qk_rope_dim)


@pytest.mark.parametrize("chunk", [0, 4])
def test_mla_attention_matches_jax(chunk):
    """Outputs within 1e-5 relative L2 (f32 both sides), whole softmax
    and KV chunks of 4 over 10 positions (a padded last chunk)."""
    cfg, jcfg = _cfgs(attn_chunk=chunk)
    w = _weights(cfg)
    B, S = 2, 10
    x = np.random.RandomState(1).randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jax.jit(jattn.mla_attention, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jcfg,
        jnp.asarray(pos))
    got = attn.mla_attention(bridge.params_from_numpy(w), torch.from_numpy(x),
                             cfg, torch.from_numpy(pos.copy()))
    assert got.shape == (B, S, cfg.d_model)
    assert _rel(got.numpy(), want) <= 1e-5


def _caches(cfg, B, L):
    spec = attn.kv_cache_spec(cfg, B, L)
    c = {k: (np.full(s.shape, -1, np.int32) if k == "pos"
             else np.zeros(s.shape, np.float32)) for k, s in spec.items()}
    return c


def _decode_both(cfg, jcfg, w, x, cache, cur_pos):
    jy, jc = jax.jit(jattn.decode_mla_attention, static_argnums=3)(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, jcfg,
        jnp.asarray(cur_pos, jnp.int32))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc2 = attn.decode_mla_attention(
        bridge.params_from_numpy(w), torch.from_numpy(x), tc, cfg,
        cur_pos if np.ndim(cur_pos) == 0 else torch.from_numpy(cur_pos))
    assert tc2 is tc                         # updated in place
    return (np.asarray(jy), {k: np.asarray(v) for k, v in jc.items()}), \
        (ty.numpy(), {k: v.numpy() for k, v in tc.items()})


def test_decode_mla_scalar_position_matches_jax():
    """Five steps at scalar positions 0..4 into an 8-slot cache: outputs
    within 1e-5, the cache's latent and rope key within 1e-6, positions
    equal."""
    cfg, jcfg = _cfgs()
    w = _weights(cfg)
    B, L = 2, 8
    rs = np.random.RandomState(2)
    cache = _caches(cfg, B, L)
    for t in range(5):
        x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
        (jy, jc), (ty, tc) = _decode_both(cfg, jcfg, w, x, cache, t)
        assert _rel(ty, jy) <= 1e-5
        np.testing.assert_array_equal(tc["pos"], jc["pos"])
        for k in ("c", "kr"):
            assert _rel(tc[k], jc[k]) <= 1e-6
        cache = jc


def test_decode_mla_per_row_positions_with_padding_match_jax():
    """Per-row (B, T) positions, T = 3: row 0 at 2..4, row 1 at 5..6 and
    one padding entry (-1), row 2 all padding: the padding writes nothing
    (its cache row stays as it was) and every real row matches JAX."""
    cfg, jcfg = _cfgs()
    w = _weights(cfg)
    B, L, T = 3, 8, 3
    rs = np.random.RandomState(3)
    cache = _caches(cfg, B, L)
    # a history first: two scalar steps
    for t in range(2):
        x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
        (_, cache), _ = _decode_both(cfg, jcfg, w, x, cache, t)
    pos = np.array([[2, 3, 4], [5, 6, -1], [-1, -1, -1]], np.int32)
    x = rs.randn(B, T, cfg.d_model).astype(np.float32)
    (jy, jc), (ty, tc) = _decode_both(cfg, jcfg, w, x, cache, pos)
    np.testing.assert_array_equal(tc["pos"], jc["pos"])
    for k in ("c", "kr"):
        assert _rel(tc[k], jc[k]) <= 1e-6
        np.testing.assert_array_equal(tc[k][2], cache[k][2])
    live = pos >= 0
    assert _rel(ty[live], jy[live]) <= 1e-5


def test_absorbed_decode_matches_full_sequence():
    """The reference's test_mla_absorbed_decode_matches_naive, in the
    port: deepseek smoke (capacity ample, so the MoE drops nothing), the
    prompt's last logits by token-by-token absorbed decode against the
    full-sequence model, within 2e-3 of the largest logit; and the port's
    decode logits against the JAX decode's (1e-5 relative L2)."""
    cfg, jcfg = _cfgs(capacity_factor=100.0)
    jmodel = JModel(jcfg)
    params = init_numpy(jcfg, 0)
    B, S = 2, 10
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    model = LayeredModel(cfg)
    tp = bridge.params_from_numpy(params)
    with torch.no_grad():
        static = {"embed": tp["embed"], "head": tp["head"]}
        x, _ = model.prepare(static, {"tokens": torch.from_numpy(toks)})
        for gi, g in enumerate(model.groups):
            ctx = model.train_ctx({"tokens": torch.from_numpy(toks)}, g)
            for li in range(g.n_layers):
                x, _ = g.apply(_index(tp["groups"][gi], li), x, None, ctx)
        full = model.decode_logits(static, x)[:, -1].numpy()
        _, last = decode.prefill(model, tp, torch.from_numpy(toks), S)
    err = float(np.abs(full - last.numpy()).max())
    assert err / (float(np.abs(full).max()) + 1e-9) < 2e-3
    _, jlast = jax.jit(lambda p, t: jdecode.prefill(jmodel, p, t,
                                                    live_seq=S))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    assert _rel(last.numpy(), jlast) <= 1e-5
    # the caches: c / kr in the compute dtype, pos -1 where never written
    caches = init_caches(model, B, S + 2)
    assert len(caches) == 2
    for c, g in zip(caches, model.groups):
        assert set(c) == {"c", "kr", "pos"}
        assert c["c"].shape == (g.n_layers, B, S + 2, cfg.kv_lora_rank)
        assert c["c"].dtype == model.dtype()
        assert bool((c["pos"] == -1).all())


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
