"""The port's optimizers against the JAX package's, on the same numpy
trees: the per-leaf updates, the fused flat update (K1's plain version on
the CPU), the schedules and the per-layer clip."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {"w": (rs.randn(16, 8) * scale).astype(np.float32),
            "b": {"x": (rs.randn(8) * scale).astype(np.float32)}}


def _to_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


_OPTS = [("adam", {}), ("adamw", {"weight_decay": 0.1}),
         ("adamw", {"weight_decay": 0.0}), ("lamb", {}),
         ("sgd", {}), ("sgd", {"momentum": 0.9})]


@pytest.mark.parametrize("name,kw", _OPTS)
def test_per_leaf_update_matches_jax(name, kw):
    jsched = jopt.make_schedule(1e-2, warmup=2, total=6, kind="cosine")
    tsched = topt.make_schedule(1e-2, warmup=2, total=6, kind="cosine")
    jo = jopt.get_optimizer(name, schedule=jsched, **kw)
    to = topt.get_optimizer(name, schedule=tsched, **kw)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _to_t(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = _tree(10 + step)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.int32(step))
        tp, ts = to.update(_to_t(g), ts, tp, step)
    # f32 chains, term by term; the step size's pow may differ in the
    # last ulp between XLA and torch: 1e-6 relative
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("name,kw", _OPTS[:3])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_flat_update_matches_per_leaf_bitwise_and_jax(name, kw, p_dtype):
    """The packed relay's fused update equals the per-leaf update bit for
    bit (the port's knob grid needs it), and the reference's flat update
    within 1e-6 relative (its step size is computed by XLA)."""
    to = topt.get_optimizer(name, lr=1e-3, **kw)
    jo = jopt.get_optimizer(name, lr=1e-3, **kw)
    rs = np.random.RandomState(3)
    n = 1000
    p = torch.from_numpy(rs.randn(n).astype(np.float32)).to(p_dtype)
    g = torch.from_numpy(rs.randn(n).astype(np.float32) * 1e-2)
    m = torch.from_numpy(rs.randn(n).astype(np.float32) * 1e-3)
    v = torch.from_numpy(np.abs(rs.randn(n)).astype(np.float32) * 1e-5)
    step = 4
    fp, fm, fv = to.flat_update(p, g, m, v, step)
    lp, ls = to.update({"p": g}, {"p": {"m": m, "v": v}}, {"p": p}, step)
    assert torch.equal(fp, lp["p"]) and torch.equal(fm, ls["p"]["m"]) \
        and torch.equal(fv, ls["p"]["v"])
    jdt = jnp.bfloat16 if p_dtype == torch.bfloat16 else jnp.float32
    jp, jm, jv = jo.flat_update(jnp.asarray(p.float().numpy()).astype(jdt),
                                jnp.asarray(g.numpy()), jnp.asarray(m.numpy()),
                                jnp.asarray(v.numpy()), jnp.int32(step))
    np.testing.assert_allclose(fm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(fv.numpy(), np.asarray(jv), rtol=1e-6)
    # bf16 masters: the same value or one bf16 ulp apart (the f32 result
    # may sit on a rounding boundary)
    tol = 8e-3 if p_dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(fp.float().numpy(),
                               np.asarray(jp).astype(np.float32), rtol=tol)


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
def test_schedule_matches_jax(kind):
    js = jopt.make_schedule(3e-4, warmup=5, total=20, kind=kind)
    ts = topt.make_schedule(3e-4, warmup=5, total=20, kind=kind)
    got = [float(ts(s)) for s in range(0, 22, 3)]
    want = [float(js(jnp.int32(s))) for s in range(0, 22, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_by_norm_matches_jax():
    tree = _tree(5, scale=3.0)
    jc, jn = jopt.clip_by_norm(jax.tree.map(jnp.asarray, tree), 1.5)
    tc, tn = topt.clip_by_norm(_to_t(tree), 1.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    np.testing.assert_allclose(float(topt.tree_global_norm(_to_t(tree))),
                               float(jopt.tree_global_norm(
                                   jax.tree.map(jnp.asarray, tree))),
                               rtol=1e-6)
