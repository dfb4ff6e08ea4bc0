"""The MoE layer of the port (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the same numpy inputs, f32: the
routing (expert ids equal before any value is compared, so a flipped
choice shows as a flip), the aux loss, the outputs and the vjp, on the
dense path (T <= 2E), the capacity path, and the capacity path with a
capacity factor low enough that tokens are dropped; deepseek-v2-lite
(SwiGLU experts, shared experts) and grok-1 (gated GELU experts, none
shared) at smoke size.  Ties in the router go to the lower expert, as
``jax.lax.top_k`` gives them.

On the card (marker ``card``; ``python -m pytest -m card --noconftest
tests/test_torch_moe.py``, which needs no JAX): the capacity path's
forward and backward twice, bitwise (no float atomics), and against its
CPU result.  JAX is imported inside the tests only."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.testing import fan_in_params  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b"]
# (B, S, capacity_factor): T = 8 <= 2E (dense), T = 32 (capacity), and
# T = 32 at a factor that leaves C = 4 slots for 16 choices per expert
PATHS = {"dense": (1, 8, 1.25), "capacity": (2, 16, 1.25),
         "capacity_drop": (2, 16, 0.25)}


def _cfg(arch, factor):
    return get_config(arch, "smoke").replace(dtype="float32",
                                             capacity_factor=factor)


def _layer(cfg, seed=0):
    """One MoE layer's weights at fan-in scales, as numpy (f32)."""
    rs = np.random.RandomState(seed)
    spec = moe.moe_spec(cfg)
    drawn = fan_in_params(spec, lambda shape: rs.randn(*shape))
    return _map(lambda a: np.asarray(a, np.float32), drawn)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _jax_cfg(arch, factor):
    from repro.configs.base import get_config as jget_config
    return jget_config(arch, "smoke").replace(dtype="float32",
                                              capacity_factor=factor)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_and_vjp_match_jax(arch, path):
    """Routing: the same expert ids, weights and aux (1e-6 relative);
    outputs and the vjp (every weight, x) within 1e-5 relative L2: f32 on
    both sides, sums in other orders."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    B, S, factor = PATHS[path]
    cfg, jcfg = _cfg(arch, factor), _jax_cfg(arch, factor)
    w = _layer(cfg)
    rs = np.random.RandomState(1)
    x = rs.randn(B, S, cfg.d_model).astype(np.float32)
    gy = rs.randn(B, S, cfg.d_model).astype(np.float32)
    ga = np.float32(0.7)
    jw = _map(jnp.asarray, w)

    # routing first: a flipped expert shows as a flip
    jt_w, jt_i, j_aux = jmoe._route(jw, jnp.asarray(x.reshape(B * S, -1)),
                                    jcfg)
    tw = bridge.params_from_numpy(w)
    tt_w, tt_i, t_aux = moe._route(tw, torch.from_numpy(x).reshape(B * S, -1),
                                   cfg)
    np.testing.assert_array_equal(tt_i.numpy(), np.asarray(jt_i))
    assert _rel(tt_w.numpy(), jt_w) <= 1e-6
    assert abs(float(t_aux) - float(j_aux)) <= 1e-6 * abs(float(j_aux))

    T, E, k = B * S, cfg.n_experts, cfg.experts_per_token
    if path == "capacity_drop":
        # the capacity really drops choices here
        C = min(T, max(1, math.ceil(T * k / E * factor)))
        counts = np.bincount(np.asarray(jt_i).reshape(-1), minlength=E)
        assert counts.max() > C, (counts, C)

    @jax.jit
    def jrun(ww, xx, g, a):
        out, vjp = jax.vjp(lambda w_, x_: jmoe.moe_apply(w_, x_, jcfg), ww,
                           xx)
        return out, vjp((g, a))

    (jy, jaux), (jdw, jdx) = jrun(jw, jnp.asarray(x), jnp.asarray(gy),
                                  jnp.asarray(ga))

    leaves = [a.requires_grad_() for a in tree_leaves(tw)]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(tw, xt, cfg)
    grads = torch.autograd.grad([y, aux], leaves + [xt],
                                grad_outputs=[torch.from_numpy(gy),
                                              torch.tensor(ga)])
    assert _rel(y.detach().numpy(), jy) <= 1e-5
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6 * abs(float(jaux))
    assert _rel(grads[-1].numpy(), jdx) <= 1e-5
    for g, want in zip(grads[:-1], jax.tree.leaves(jdw)):
        assert _rel(g.numpy(), want) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_pick_the_lower_expert(arch):
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1 for every token, with equal weights."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg = _cfg(arch, 1.25)
    w = _layer(cfg)
    w["router"] = np.zeros_like(w["router"])
    x = np.random.RandomState(2).randn(6, cfg.d_model).astype(np.float32)
    jt_w, jt_i, _ = jmoe._route(_map(jnp.asarray, w), jnp.asarray(x),
                                _jax_cfg(arch, 1.25))
    tt_w, tt_i, _ = moe._route(bridge.params_from_numpy(w),
                               torch.from_numpy(x), cfg)
    k = cfg.experts_per_token
    np.testing.assert_array_equal(np.asarray(jt_i), np.tile(np.arange(k),
                                                            (6, 1)))
    np.testing.assert_array_equal(tt_i.numpy(), np.asarray(jt_i))
    np.testing.assert_array_equal(tt_w.numpy(), np.asarray(jt_w))


def test_dense_path_rows_are_independent():
    """On the dense path (T <= 2E) a row's output depends on that row
    alone: other rows of the same shape of call, changed, leave it equal
    bit for bit (the continuous tick fills 2E rows, so a request's tokens
    do not depend on the others in flight)."""
    cfg = _cfg("deepseek-v2-lite-16b", 1.25)
    w = bridge.params_from_numpy(_layer(cfg))
    rs = np.random.RandomState(3)
    x = rs.randn(1, 2 * cfg.n_experts, cfg.d_model).astype(np.float32)
    with torch.no_grad():
        y, _ = moe.moe_apply(w, torch.from_numpy(x), cfg)
        for t in range(x.shape[1]):
            other = rs.randn(*x.shape).astype(np.float32)
            other[:, t] = x[:, t]
            yt, _ = moe.moe_apply(w, torch.from_numpy(other), cfg)
            assert torch.equal(yt[0, t], y[0, t])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_backward_is_bitwise_on_card(cuda, arch):
    """The capacity path (dropped tokens included) forward and backward
    twice on the card: bitwise equal (no float atomics), and within 1e-5
    relative L2 of the CPU's."""
    cfg = _cfg(arch, 0.25)
    w_np = _layer(cfg)
    x_np = np.random.RandomState(4).randn(4, 64, cfg.d_model) \
        .astype(np.float32)

    def run(device):
        w = bridge.params_from_numpy(w_np, device)
        leaves = [a.requires_grad_() for a in tree_leaves(w)]
        x = torch.from_numpy(x_np).to(device).requires_grad_()
        y, aux = moe.moe_apply(w, x, cfg)
        g = torch.autograd.grad([y, aux], leaves + [x],
                                grad_outputs=[torch.ones_like(y),
                                              torch.ones_like(aux)])
        return [t.detach().cpu().numpy() for t in (y, aux) + g]

    first, second, cpu = run(cuda), run(cuda), run("cpu")
    assert all(np.array_equal(a, b) for a, b in zip(first, second))
    for a, b in zip(first, cpu):
        assert _rel(a, b) <= 1e-5
