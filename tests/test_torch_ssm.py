"""The recurrent mixers of the port (``repro_torch.models.ssm``) and the
hybrid / RWKV blocks (``repro_torch.models.blocks``) against the
reference's (``repro.models.ssm`` / ``repro.models.blocks``) on the same
numpy inputs, f32, at smoke size (hymba-1.5b: d 128, 4 heads over 2 kv,
a 32-token window, state 4; rwkv6-1.6b: d 128, 4 heads of 32):

* ``mamba_apply`` (the doubling scan against ``jax.lax.associative_scan``)
  and its vjp, ``mamba_decode``; ``rwkv6_time_mix`` through the step scan
  and the chunked scan and its vjp, ``rwkv6_channel_mix``;
* ``hybrid_apply`` (at S = 40 > the window, so the window masks) and
  ``rwkv_apply`` and their vjps, and each branch of the hybrid able to
  fail the check (its output projection zeroed);
* S decode steps against the full-sequence forward, the state written into
  the cache the step was given, the decode's bf16 cast points (a bf16
  cache in f32 compute, against the reference's);
* the reference's ``tests/test_rwkv_chunked.py`` in the port, on the
  reference's parameters and batches, and on the port's own draw each
  scan's gradients against the port's f64 run.

Parameters come from ``repro_torch.testing.fan_in_params``: its scales
for ``beta_a``, ``beta_s``, ``d_skip`` and ``ln_scale`` (1 + 0.1 x) keep
every branch in the output at full weight.  Bound: 1e-5 relative L2
(the two scans associate in other orders; f32 rounding is ~1e-7)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_unflatten_like  # noqa: E402,E501
from repro_torch.models import blocks, ssm  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import SCALES, fan_in_params  # noqa: E402

BOUND = 1e-5


def _cfg(arch, **kw):
    return get_config(arch, "smoke").replace(dtype="float32", **kw)


def _jcfg(arch, **kw):
    from repro.configs.base import get_config as jget_config
    return jget_config(arch, "smoke").replace(dtype="float32", **kw)


def _draw(spec, seed=0):
    rs = np.random.RandomState(seed)
    return _map(lambda a: np.asarray(a, np.float32),
                fan_in_params(spec, lambda shape: rs.randn(*shape)))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _vjp_port(fn, w, x, gy):
    """(y, grads of every weight leaf in flatten order, grad of x)."""
    tw = bridge.params_from_numpy(w)
    leaves = [a.requires_grad_() for a in tree_leaves(tw)]
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(tw, xt)
    gs = torch.autograd.grad(y, leaves + [xt], torch.from_numpy(gy),
                             allow_unused=True)
    return y.detach().numpy(), [
        np.zeros(a.shape, np.float32) if g is None else g.numpy()
        for a, g in zip(leaves + [xt], gs)]


def _vjp_jax(fn, w, x, gy):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(ww, xx, g):
        y, vjp = jax.vjp(fn, ww, xx)
        return (y,) + vjp(g)

    y, dw, dx = run(_map(jnp.asarray, w), jnp.asarray(x), jnp.asarray(gy))
    return np.asarray(y), [np.asarray(a) for a in jax.tree.leaves(dw)] + \
        [np.asarray(dx)]


def _assert_vjps(port, jax_, bound=BOUND):
    (y, gs), (jy, jgs) = port, jax_
    assert _rel(y, jy) <= bound, _rel(y, jy)
    assert len(gs) == len(jgs)
    for i, (g, jg) in enumerate(zip(gs, jgs)):
        if np.abs(jg).max() == 0:
            assert np.abs(g).max() == 0, i
        else:
            assert _rel(g, jg) <= bound, (i, _rel(g, jg))


def test_fan_in_params_draws_branch_scales_as_scales():
    """beta_a, beta_s, d_skip and ln_scale near 1 (not biases at 0.02, not
    weights at 1/sqrt(d)), a_log and dt_bias as weights."""
    w = _draw(blocks.hybrid_spec(_cfg("hymba-1.5b")))
    r = _draw(blocks.rwkv_spec(_cfg("rwkv6-1.6b")))
    for leaf in (w["beta_a"], w["beta_s"], w["mamba"]["d_skip"],
                 r["tm"]["ln_scale"]):
        assert abs(float(leaf.mean()) - 1.0) < 0.05 and \
            0.05 < float(leaf.std()) < 0.15
    assert {"beta_a", "beta_s", "d_skip", "ln_scale"} <= set(SCALES)
    assert float(np.abs(w["mamba"]["a_log"]).mean()) < 0.2


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 24, 64])
def test_selective_scan_is_the_recurrence(S):
    """The doubling scan against the sequential loop, f64 (rounding aside
    the same numbers): S = 1, a length no power of two divides, and a
    power of two."""
    rs = np.random.RandomState(S)
    a = torch.from_numpy(rs.uniform(0.5, 1.0, (2, S, 3, 4)))
    b = torch.from_numpy(rs.randn(2, S, 3, 4))
    h, want = torch.zeros(2, 3, 4, dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = ssm.selective_scan(a, b)
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("S", [24, 64])
def test_mamba_apply_and_vjp_match_jax(S):
    from repro.models import ssm as jssm
    cfg, jcfg = _cfg("hymba-1.5b"), _jcfg("hymba-1.5b")
    w = _draw(ssm.mamba_spec(cfg))
    x, gy = _x((2, S, cfg.d_model)), _x((2, S, cfg.d_model), 2)
    _assert_vjps(
        _vjp_port(lambda ww, xx: ssm.mamba_apply(ww, xx, cfg), w, x, gy),
        _vjp_jax(lambda ww, xx: jssm.mamba_apply(ww, xx, jcfg), w, x, gy))


def test_mamba_decode_matches_jax_and_the_full_sequence():
    """One step against the reference's from the same state (out and new
    state), and S steps from zeros against mamba_apply's outputs."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    cfg, jcfg = _cfg("hymba-1.5b"), _jcfg("hymba-1.5b")
    w = _draw(ssm.mamba_spec(cfg))
    tw = bridge.params_from_numpy(w)
    S = 12
    x = _x((2, S, cfg.d_model))
    st = {"h": _x((2, cfg.d_model, cfg.ssm_state), 3),
          "conv": _x((2, cfg.ssm_conv - 1, cfg.d_model), 4)}
    jy, jst = jssm.mamba_decode(_map(jnp.asarray, w), jnp.asarray(x[:, :1]),
                                _map(jnp.asarray, st), jcfg)
    with torch.no_grad():
        y, new = ssm.mamba_decode(tw, torch.from_numpy(x[:, :1]),
                                  bridge.params_from_numpy(st), cfg)
        assert _rel(y.numpy(), jy) <= BOUND
        for k in st:
            assert _rel(new[k].numpy(), jst[k]) <= BOUND, k
        full = ssm.mamba_apply(tw, torch.from_numpy(x), cfg)
        state = {k: torch.zeros(v.shape) for k, v in
                 ssm.mamba_state_spec(cfg, 2).items()}
        steps = []
        for t in range(S):
            y, state = ssm.mamba_decode(tw, torch.from_numpy(x[:, t:t + 1]),
                                        state, cfg)
            steps.append(y)
    assert _rel(torch.cat(steps, 1).numpy(), full.numpy()) <= BOUND


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [0, 8])
def test_rwkv6_time_mix_and_vjp_match_jax(chunk):
    """The step scan (chunk 0) and the chunked scan (8 | 32), outputs and
    vjps, and the final state, against the reference's."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    cfg = _cfg("rwkv6-1.6b", rwkv_chunk=chunk)
    jcfg = _jcfg("rwkv6-1.6b", rwkv_chunk=chunk)
    w = _draw(ssm.rwkv6_spec(cfg))["tm"]
    x, gy = _x((2, 32, cfg.d_model)), _x((2, 32, cfg.d_model), 2)
    _assert_vjps(
        _vjp_port(lambda ww, xx: ssm.rwkv6_time_mix(ww, xx, cfg)[0], w, x,
                  gy),
        _vjp_jax(lambda ww, xx: jssm.rwkv6_time_mix(ww, xx, jcfg)[0], w, x,
                 gy))
    jst = jax.jit(lambda ww, xx: jssm.rwkv6_time_mix(ww, xx, jcfg)[1])(
        _map(jnp.asarray, w), jnp.asarray(x))
    with torch.no_grad():
        _, st = ssm.rwkv6_time_mix(bridge.params_from_numpy(w),
                                   torch.from_numpy(x), cfg)
    assert _rel(st["wkv"].numpy(), jst["wkv"]) <= BOUND
    np.testing.assert_array_equal(st["shift"].numpy(), jst["shift"])


def test_rwkv6_channel_mix_and_vjp_match_jax():
    from repro.models import ssm as jssm
    cfg = _cfg("rwkv6-1.6b")
    w = _draw(ssm.rwkv6_spec(cfg))["cm"]
    x, gy = _x((2, 16, cfg.d_model)), _x((2, 16, cfg.d_model), 2)
    _assert_vjps(
        _vjp_port(lambda ww, xx: ssm.rwkv6_channel_mix(ww, xx)[0], w, x, gy),
        _vjp_jax(lambda ww, xx: jssm.rwkv6_channel_mix(ww, xx)[0], w, x, gy))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
BLOCKS = {"hymba-1.5b": ("hybrid", 40), "rwkv6-1.6b": ("rwkv", 24)}


def _block_fns(arch, zero=None):
    """(port fn, jax fn, numpy weights) of one block's apply at S tokens;
    ``zero`` names a leaf path zeroed on the port's side only."""
    from repro.models import blocks as jblocks
    import jax.numpy as jnp
    name, S = BLOCKS[arch]
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    w = _draw(getattr(blocks, f"{name}_spec")(cfg))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    ctx = blocks.Ctx(positions=torch.from_numpy(pos.copy()), causal=True,
                     window=cfg.sliding_window)
    jctx = jblocks.Ctx(positions=jnp.asarray(pos), causal=True,
                       window=jcfg.sliding_window)
    apply_, japply = (getattr(blocks, f"{name}_apply"),
                      getattr(jblocks, f"{name}_apply"))

    def port(ww, xx):
        if zero is not None:
            leaf = ww
            for k in zero[:-1]:
                leaf = leaf[k]
            leaf[zero[-1]] = leaf[zero[-1]] * 0
        return apply_(ww, xx, None, ctx, cfg)[0]

    return port, lambda ww, xx: japply(ww, xx, None, jctx, jcfg)[0], w, S


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_block_apply_and_vjp_match_jax(arch):
    port, jfn, w, S = _block_fns(arch)
    d = _cfg(arch).d_model
    x, gy = _x((2, S, d)), _x((2, S, d), 2)
    _assert_vjps(_vjp_port(port, w, x, gy), _vjp_jax(jfn, w, x, gy))


@pytest.mark.parametrize("branch", [("mamba", "w_out"), ("attn", "wo")])
def test_each_hybrid_branch_can_fail_the_check(branch):
    """Either branch's output projection zeroed: the hybrid block misses
    the bound by orders of magnitude (each branch enters at full weight)."""
    port, jfn, w, S = _block_fns("hymba-1.5b", zero=branch)
    x = _x((2, S, _cfg("hymba-1.5b").d_model))
    with torch.no_grad():
        y = port(bridge.params_from_numpy(w), torch.from_numpy(x))
    import jax
    import jax.numpy as jnp
    jy = jax.jit(jfn)(_map(jnp.asarray, w), jnp.asarray(x))
    assert _rel(y.numpy(), jy) > 1e3 * BOUND


def _decode_run(arch, w, tokens_x, cache_dtype, S):
    """The port's block decode over S steps from a zero cache of
    ``cache_dtype``: (outputs (B,S,d), the cache tensors after)."""
    name = BLOCKS[arch][0]
    cfg = _cfg(arch)
    tw = bridge.params_from_numpy(w)
    spec = getattr(blocks, f"{name}_cache_spec")(cfg, 2, S)

    def build(t, k=None):
        if isinstance(t, dict):
            return {kk: build(v, kk) for kk, v in t.items()}
        if k == "pos":
            return torch.full(t.shape, -1, dtype=torch.int32)
        return torch.zeros(t.shape, dtype=cache_dtype)

    cache = build(spec)
    held = tree_leaves(cache)
    dec = getattr(blocks, f"{name}_decode")
    outs = []
    with torch.no_grad():
        for t in range(S):
            ctx = blocks.Ctx(cur_pos=t, window=cfg.sliding_window)
            y, c2 = dec(tw, torch.from_numpy(tokens_x[:, t:t + 1]), cache,
                        None, ctx, cfg)
            assert all(a is b for a, b in zip(tree_leaves(c2), held))
            outs.append(y)
    return torch.cat(outs, 1).numpy(), cache


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_block_decode_steps_equal_the_full_sequence(arch):
    """S steps through the block's decode (the cache written in place:
    the same tensors after every step) against its apply, f32.  hymba's
    S = 40 decodes past its 32-token window."""
    port, _, w, S = _block_fns(arch)
    x = _x((2, S, _cfg(arch).d_model))
    got, cache = _decode_run(arch, w, x, torch.float32, S)
    with torch.no_grad():
        want = port(bridge.params_from_numpy(w), torch.from_numpy(x))
    assert _rel(got, want.numpy()) <= BOUND
    assert all(bool((a != 0).any()) for a in tree_leaves(cache)
               if a.dtype != torch.int32)


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_bf16_state_cast_points_match_jax(arch):
    """A bf16 cache under f32 compute: both packages round the recurrent
    state to bf16 after every step.  The port lands within a tenth of the
    bf16 rounding's own effect (bf16 cache against an f32 one) of the
    reference: a cast point missing or added would be that effect whole."""
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as jblocks
    name, S = BLOCKS[arch][0], 16
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    w = _draw(getattr(blocks, f"{name}_spec")(cfg))
    x = _x((2, S, cfg.d_model))
    got16, _ = _decode_run(arch, w, x, torch.bfloat16, S)
    got32, _ = _decode_run(arch, w, x, torch.float32, S)
    spec = getattr(jblocks, f"{name}_cache_spec")(jcfg, 2, S)
    is_spec = lambda t: type(t).__name__ == "ParamSpec"
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.bfloat16), spec,
                         is_leaf=is_spec)
    if "kv" in cache:
        cache["kv"]["pos"] = jnp.full(cache["kv"]["pos"].shape, -1,
                                      jnp.int32)
    dec = getattr(jblocks, f"{name}_decode")
    step = jax.jit(lambda ww, xt, c, t: dec(
        ww, xt, c, None, jblocks.Ctx(cur_pos=t, window=jcfg.sliding_window),
        jcfg))
    jw, outs = _map(jnp.asarray, w), []
    for t in range(S):
        y, cache = step(jw, jnp.asarray(x[:, t:t + 1]), cache, jnp.int32(t))
        outs.append(np.asarray(y))
    want16 = np.concatenate(outs, 1)
    effect = _rel(got32, want16)
    assert effect > 1e-4, effect
    assert _rel(got16, want16) <= 0.1 * effect, (_rel(got16, want16), effect)


# ---------------------------------------------------------------------------
# tests/test_rwkv_chunked.py in the port, on the reference's data
# ---------------------------------------------------------------------------
# The reference's own parameters (its init at PRNGKey(0)) and batches,
# carried over: the step scan's f32 gradient is ill-conditioned on some
# draws (on the port's own draw below, the port's step scan is 1.9e-3 and
# the reference's 2.6e-4 from an f64 run, the chunked scan 2.5e-5), so
# the mirror holds the port to the reference's test on the reference's
# inputs.
def _model(chunk):
    return LayeredModel(_cfg("rwkv6-1.6b", rwkv_chunk=chunk))


@pytest.fixture(scope="module")
def ref_params():
    import jax
    from repro.models.model import LayeredModel as JModel
    params = JModel(_jcfg("rwkv6-1.6b")).init_params(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _batch(B, S, seed=1):
    """The reference test's batch: targets = tokens, all weights 1."""
    import jax
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    t = torch.from_numpy(np.asarray(jax.random.randint(
        ks[0], (B, S), 0, _cfg("rwkv6-1.6b").vocab_size)).astype(np.int64))
    return {"tokens": t, "targets": t, "mask": torch.ones(B, S)}


@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 32), (96, 16)])
def test_chunked_wkv_forward(ref_params, S, chunk):
    m0, m1 = _model(0), _model(chunk)
    params = bridge.params_from_numpy(ref_params)
    batch = _batch(2, S)
    with torch.no_grad():
        l0, _ = m0.full_loss(params, batch)
        l1, _ = m1.full_loss(params, batch)
    assert abs(float(l0) - float(l1)) < 1e-4


def test_chunked_wkv_gradients(ref_params):
    m0, m1 = _model(0), _model(16)
    params = bridge.params_from_numpy(ref_params)
    leaves = [a.requires_grad_() for a in tree_leaves(params)]
    batch = _batch(2, 64)
    g0 = torch.autograd.grad(m0.full_loss(params, batch)[0], leaves)
    g1 = torch.autograd.grad(m1.full_loss(params, batch)[0], leaves)
    for a, b in zip(g0, g1):
        diff = float((a - b).abs().max())
        scale = float(a.abs().max()) + 1e-9
        assert diff / scale < 1e-3


# ---------------------------------------------------------------------------
# the same mirror on the port's own draw, each scan held to an f64 run
# ---------------------------------------------------------------------------
# The port's init at seed 0 on a batch drawn by torch at seed 1 (B 2, S 64)
# is a draw on which the step scan's f32 gradient is far from the truth:
# the chunked scan's distance from the step scan is over the reference
# test's 1e-3 there.  The truth is the port's own f64 run (its f32 casts
# made f64), and each f32 run is measured against it.
def _grads(params, batch, chunk, f64=False):
    """Every leaf's gradient of the port's full loss, in f32 or f64."""
    dt = torch.float64 if f64 else torch.float32
    model = LayeredModel(_cfg("rwkv6-1.6b", rwkv_chunk=chunk).replace(
        dtype="float64" if f64 else "float32"))
    leaves = [a.detach().to(dt).requires_grad_()
              for a in tree_leaves(params)]
    p = tree_unflatten_like(params, leaves)
    return torch.autograd.grad(model.full_loss(p, {
        **batch, "mask": batch["mask"].to(dt)})[0], leaves)


def _dist(got, want):
    """The largest per-leaf max |got - want| over max |want|."""
    return max(float((a.double() - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


def _wkv_step_reference_order(rh, kh, vh, wh, u, s0):
    """The step scan in the reference's association: per step
    ``out_t = r_t · (s + u ∘ k_t v_tᵀ)``, ``s = w_t ∘ s + k_t v_tᵀ``."""
    B, H, S, hd = rh.shape
    s, outs = s0, []
    for t in range(S):
        kv = kh[:, :, t, :, None] * vh[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rh[:, :, t],
                                 s + u[..., :, None] * kv))
        s = wh[:, :, t, :, None] * s + kv
    return torch.stack(outs, 2), s


def test_wkv_scans_against_f64_on_the_port_draw(monkeypatch, capsys):
    """The chunked scan within 1e-4 of the f64 gradients, and the f32
    model with only the step scan run in f64 within 1e-4 too: what
    separates the f32 step scan from the truth is the recurrence's own
    f32 rounding, in either association (the port's, and the
    reference's, ``_wkv_step_reference_order``, land at the same
    distance).  Printed: each f32 run's distance, and the reference's f32
    step scan's on the same params."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import LayeredModel as JModel
    params = _model(0).init_params(torch.Generator().manual_seed(0))
    t = torch.randint(0, _cfg("rwkv6-1.6b").vocab_size, (2, 64),
                      generator=torch.Generator().manual_seed(1))
    batch = {"tokens": t, "targets": t, "mask": torch.ones(2, 64)}
    step32 = _grads(params, batch, 0)
    chunk32 = _grads(params, batch, 16)
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jm = JModel(_jcfg("rwkv6-1.6b"))
    ref32 = [torch.from_numpy(np.array(g)) for g in jax.tree.leaves(
        jax.jit(jax.grad(lambda p: jm.full_loss(p, jbatch)[0]))(jparams))]
    step = ssm._wkv_step_scan
    monkeypatch.setattr(ssm, "_wkv_step_scan", _wkv_step_reference_order)
    ref_order32 = _grads(params, batch, 0)

    def scan_f64(rh, kh, vh, wh, u, s0):
        y, s = step(*(a.double() for a in (rh, kh, vh, wh, u, s0)))
        return y.to(rh.dtype), s.to(rh.dtype)

    monkeypatch.setattr(ssm, "_wkv_step_scan", scan_f64)
    mixed = _grads(params, batch, 0)
    to64 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda a: a.double()
                        if a.is_floating_point() else to64(a))
    truth = _grads(params, batch, 0, f64=True)
    dists = {"step": _dist(step32, truth), "chunked": _dist(chunk32, truth),
             "step, the reference's association": _dist(ref_order32, truth),
             "reference step": _dist(ref32, truth),
             "step, scan in f64": _dist(mixed, truth)}
    with capsys.disabled():
        print("\nrwkv6 f32 gradients from the port's f64 run:", dists)
    assert dists["chunked"] <= 1e-4, dists
    assert dists["step, scan in f64"] <= 1e-4, dists
    assert abs(dists["step, the reference's association"] - dists["step"]) \
        <= 0.1 * dists["step"], dists


def test_wkv_step_scan_matches_reference_scan_against_f64():
    """The step scans of both packages on the same inputs: the
    ``(rh, kh, vh, wh, u, s0)`` that reach the scan in each layer of the
    port's forward on the port's draw (seed 0: the draw on which the
    port's f32 model gradients stand 1.89e-3 from its f64 run and the
    reference's 2.58e-4), and one fixed cotangent.  Each output and each
    input's vjp, of the port's f32 scan and of the reference's (JAX,
    ``jax.vjp``), within 1e-6 of the port's f64 scan (largest error over
    largest value): both at f32 rounding, neither the less accurate.
    So the model's gap is not the scan's arithmetic: it is how the
    reference's std-1/sqrt(depth) init amplifies the forward's f32
    rounding (ROADMAP, "Facts about tolerances")."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    params = _model(0).init_params(torch.Generator().manual_seed(0))
    t = torch.randint(0, _cfg("rwkv6-1.6b").vocab_size, (2, 64),
                      generator=torch.Generator().manual_seed(1))
    caps, step = [], ssm._wkv_step_scan

    def capture(*a):
        caps.append([x.detach().clone() for x in a])
        return step(*a)

    ssm._wkv_step_scan = capture
    try:
        with torch.no_grad():
            _model(0).full_loss(params, {"tokens": t, "targets": t,
                                         "mask": torch.ones(2, 64)})
    finally:
        ssm._wkv_step_scan = step
    rs = np.random.RandomState(2)
    ref_scan = jax.jit(lambda *a: jax.vjp(jssm._wkv_step_scan, *a[:6])[1](
        a[6:]))
    ref_fwd = jax.jit(jssm._wkv_step_scan)
    assert len(caps) == _cfg("rwkv6-1.6b").n_layers
    for ins in caps:
        cot = [torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
               for x in (ins[0], ins[5])]

        def port(dt):
            xs = [x.detach().to(dt).requires_grad_() for x in ins]
            y, s = step(*xs)
            return [y, s] + list(torch.autograd.grad(
                (y, s), xs, [c.to(dt) for c in cot]))

        want, got = port(torch.float64), port(torch.float32)
        jin = [jnp.asarray(x.numpy()) for x in ins + cot]
        ref = [np.asarray(a) for a in (*ref_fwd(*jin[:6]), *ref_scan(*jin))]
        for name, w, g, r in zip(("y", "s", "drh", "dkh", "dvh", "dwh",
                                  "du", "ds0"), want, got, ref):
            w = w.detach()
            top = float(w.abs().max())
            e_port = float((g.detach().double() - w).abs().max()) / top
            e_ref = float((torch.from_numpy(r).double() - w).abs().max()) \
                / top
            assert e_port <= 1e-6 and e_ref <= 1e-6, (name, e_port, e_ref)


class _ScanMix(torch.autograd.Function):
    """The step scan with its forward values and its gradients each from
    f32 or f64 arithmetic."""

    @staticmethod
    def forward(ctx, fwd64, bwd64, *a):
        ctx.bwd64 = bwd64
        ctx.save_for_backward(*a)
        y, s = _STEP(*((x.double() if fwd64 else x) for x in a))
        return y.float(), s.float()

    @staticmethod
    def backward(ctx, dy, ds):
        with torch.enable_grad():
            xs = [(x.double() if ctx.bwd64 else x).detach().requires_grad_()
                  for x in ctx.saved_tensors]
            y, s = _STEP(*xs)
            g = torch.autograd.grad((y, s), xs,
                                    (dy.to(y.dtype), ds.to(s.dtype)))
        return (None, None) + tuple(x.float() for x in g)


_STEP = ssm._wkv_step_scan


class _Swap(torch.autograd.Function):
    """Given forward values ``(y, s)`` of the step scan of inputs ``a``,
    with the port's f32 backward."""

    @staticmethod
    def forward(ctx, y, s, *a):
        ctx.save_for_backward(*a)
        return y.clone(), s.clone()

    @staticmethod
    def backward(ctx, dy, ds):
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            g = torch.autograd.grad(_STEP(*xs), xs, (dy, ds))
        return (None, None) + g


def _wkv_step_elementwise(rh, kh, vh, wh, u, s0):
    """The reference's association with each read-out summed from its
    elementwise products (another summation order than a matmul's)."""
    s, outs = s0, []
    for t in range(rh.shape[2]):
        kv = kh[:, :, t, :, None] * vh[:, :, t, None, :]
        outs.append((rh[:, :, t, :, None]
                     * (s + u[..., :, None] * kv)).sum(-2))
        s = wh[:, :, t, :, None] * s + kv
    return torch.stack(outs, 2), s


def _reindexed(scan, idx):
    """``scan`` with the key/head dimension taken in the order ``idx``
    (the same sums in another order); the state comes back in place."""
    def run(rh, kh, vh, wh, u, s0):
        back = torch.argsort(idx)
        y, s = scan(rh[..., idx], kh[..., idx], vh, wh[..., idx],
                    u[..., idx], s0[..., idx, :])
        return y, s[..., back, :]
    return run


def _reversed(scan):
    hd = _cfg("rwkv6-1.6b").d_model // _cfg("rwkv6-1.6b").n_heads
    return _reindexed(scan, torch.arange(hd - 1, -1, -1))


def _permuted(scan):
    hd = _cfg("rwkv6-1.6b").d_model // _cfg("rwkv6-1.6b").n_heads
    return _reindexed(scan, torch.randperm(
        hd, generator=torch.Generator().manual_seed(5)))


def test_wkv_model_amplifies_the_scans_forward_rounding(monkeypatch,
                                                        capsys):
    """Where the port's draw loses its f32 accuracy: the scan's forward
    values, amplified by the rest of the model at the reference's init.
    The model with the scan's forward in f32 and its backward in f64
    stands as far from the f64 run as the all-f32 model (1.89e-3); with
    the forward in f64 and the backward in f32 it stands 2.5e-5.  Random
    relative noise of the f32 scan's own size (1.5e-7) on an f64 scan's
    outputs lands within 1e-4: the amplified error is the forward's
    rounding in its own direction, not its size.  Which direction is a
    matter of summation order: the same step in f32 with its sums in
    other orders (elementwise products summed, the head dimension
    reversed or permuted) stands from 9.3e-5 to 2.5e-3, and the
    reference's own f32 scan (JAX) as the forward inside the port's model,
    with an f32 backward, stands 5.8e-4, inside that spread (ROADMAP,
    "Facts about tolerances", item 10).  Printed: each distance."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    params = _model(0).init_params(torch.Generator().manual_seed(0))
    t = torch.randint(0, _cfg("rwkv6-1.6b").vocab_size, (2, 64),
                      generator=torch.Generator().manual_seed(1))
    batch = {"tokens": t, "targets": t, "mask": torch.ones(2, 64)}

    def with_scan(scan, f64=False):
        monkeypatch.setattr(ssm, "_wkv_step_scan", scan)
        try:
            return _grads(params, batch, 0, f64=f64)
        finally:
            monkeypatch.setattr(ssm, "_wkv_step_scan", _STEP)

    gen = torch.Generator().manual_seed(100)

    def noisy(*a):
        y, s = _STEP(*(x.double() for x in a))
        y = y * (1 + 1.5e-7 * torch.randn(y.shape, generator=gen,
                                          dtype=torch.float64))
        return y.float(), s.float()

    mix = {f"forward {'f64' if f else 'f32'}, backward "
           f"{'f64' if b else 'f32'}": with_scan(
               lambda *a, f=f, b=b: _ScanMix.apply(f, b, *a))
           for f, b in ((False, True), (True, False))}
    mix["f64 scan, 1.5e-7 noise"] = with_scan(noisy)
    ref_fwd = jax.jit(jssm._wkv_step_scan)

    def reference_forward(*a):
        y, s = ref_fwd(*(jnp.asarray(x.detach().numpy()) for x in a))
        y, s = torch.from_numpy(np.array(y)), torch.from_numpy(np.array(s))
        return _Swap.apply(y, s, *a)

    orders = {"port": _STEP, "elementwise": _wkv_step_elementwise,
              "elementwise, head dim reversed": _reversed(
                  _wkv_step_elementwise),
              "head dim permuted": _permuted(_STEP)}
    orders = {k: with_scan(f) for k, f in orders.items()}
    mix["reference's f32 scan forward, f32 backward"] = with_scan(
        reference_forward)
    to64 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda a: a.double()
                        if a.is_floating_point() else to64(a))
    truth = with_scan(lambda *a: _STEP(*(x.double() for x in a)), f64=True)
    monkeypatch.setattr(torch.Tensor, "float", to64)
    dists = {k: _dist(v, truth) for k, v in mix.items()}
    spread = {k: _dist(v, truth) for k, v in orders.items()}
    with capsys.disabled():
        print("\nrwkv6 f32 gradients from the port's f64 run:", dists,
              "\nthe f32 step scan by summation order:", spread)
    fwd32 = dists["forward f32, backward f64"]
    fwd64 = dists["forward f64, backward f32"]
    assert fwd64 <= 1e-4 and fwd32 >= 10 * fwd64, dists
    assert dists["f64 scan, 1.5e-7 noise"] <= 1e-4, dists
    lo, hi = min(spread.values()), max(spread.values())
    assert hi >= 10 * lo, spread
    assert lo <= dists["reference's f32 scan forward, f32 backward"] <= hi, \
        (dists, spread)


def test_chunked_wkv_nonmultiple_falls_back(ref_params):
    """seq not divisible by chunk: silently use the step scan."""
    m0, m1 = _model(0), _model(16)
    params = bridge.params_from_numpy(ref_params)
    batch = _batch(2, 50)
    with torch.no_grad():
        l0, _ = m0.full_loss(params, batch)
        l1, _ = m1.full_loss(params, batch)
    assert torch.isfinite(l1) and float(l1) == float(l0)
