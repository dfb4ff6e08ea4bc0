"""K5's routes (``kernels/rmsnorm.py``): the CUDA C++ kernel (the default,
every launch of the serve path) and the Triton kernel kept for timing;
and the differentiable RMSNorm over it (``kernels/ops.rmsnorm_diff``).

On the CPU: the route names the wrapper refuses, and that a CPU tensor
takes the plain version whatever the route (held to the JAX package's
Pallas kernel in interpret mode); ``rmsnorm_diff``'s forward and vjp
against the JAX package's ``rmsnorm_diff`` in interpret mode; and that
the forward-only wrapper refuses a tensor autograd would follow.

On the card (marker ``card``; ``python -m pytest -m card
tests/test_torch_rmsnorm.py``, which needs no JAX): the CUDA kernel against
its plain version at the serve path's decode and prefill rows and at a
ragged width, in f32, bf16 and f16, on a strided row view, and what it
refuses; and granite-smoke's layer gradients through K5 on the card
against the CPU's plain path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402


@pytest.fixture(scope="module")
def jrms():
    pytest.importorskip("jax")
    from repro.kernels import rmsnorm
    return rmsnorm


def _xs(rows, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(rows, d).astype(np.float32) * 3.0,
            (1.0 + 0.1 * rs.randn(d)).astype(np.float32))


@pytest.mark.parametrize("route", ["bogus", "cpu", "", "CUDA"])
def test_route_names_refused(route):
    x, s = _xs(4, 64, 0)
    with pytest.raises(ValueError, match="route"):
        trms.rmsnorm_2d(torch.from_numpy(x), torch.from_numpy(s),
                        route=route)


@pytest.mark.parametrize("route", trms.ROUTES)
def test_cpu_tensor_takes_the_plain_version(monkeypatch, jrms, route):
    """Either route name on CPU tensors: no kernel library, no Triton, no
    launch counted; the plain version's output, within 1e-6 of the Pallas
    kernel (one f32 reduction in another order)."""
    import jax.numpy as jnp

    def no_launch():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "library", no_launch)
    monkeypatch.setattr(trms, "_triton_kernel", no_launch)
    x, s = _xs(8, 256, 1)
    before = dict(trms.rmsnorm_2d.launches_by_route)
    got = trms.rmsnorm_2d(torch.from_numpy(x), torch.from_numpy(s),
                          eps=1e-6, route=route)
    assert dict(trms.rmsnorm_2d.launches_by_route) == before
    assert torch.equal(got, trms.rmsnorm_2d_plain(torch.from_numpy(x),
                                                  torch.from_numpy(s)))
    want = np.asarray(jrms.rmsnorm_2d(jnp.asarray(x), jnp.asarray(s),
                                      eps=1e-6, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_refuses_before_any_launch(monkeypatch):
    """A tensor on neither the CPU nor a CUDA device (meta) is refused in
    the wrapper before the kernel library is touched."""
    def no_launch():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "library", no_launch)
    x = torch.empty(4, 64, dtype=torch.bfloat16, device="meta")
    s = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        trms.rmsnorm_2d(x, s)


def test_routes_are_counted_separately():
    assert set(trms.rmsnorm_2d.launches_by_route) == set(trms.ROUTES) \
        == {"cuda", "triton"}


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 256)])
def test_rmsnorm_diff_matches_jax_vjp(shape):
    """Forward, dx and dscale in f32 against ``repro.kernels.ops
    .rmsnorm_diff`` (its Pallas forward in interpret mode, its backward
    ``jax.vjp`` of the plain function): one f32 reduction in another
    order on each side, 1e-5 relative to each output's largest value."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rs = np.random.RandomState(sum(shape))
    x = (3.0 * rs.randn(*shape)).astype(np.float32)
    s = (1.0 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jops.rmsnorm_diff(
        a, b, eps=1e-6, interpret=True), jnp.asarray(x), jnp.asarray(s))
    wdx, wds = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    before = tops.rmsnorm_diff.forwards
    out = tops.rmsnorm_diff(xt, st, eps=1e-6)
    assert tops.rmsnorm_diff.forwards == before + 1
    dx, ds = torch.autograd.grad(out, (xt, st), torch.from_numpy(g))
    for got, w in ((out, want), (dx, wdx), (ds, wds)):
        w = np.asarray(w)
        assert got.shape == w.shape
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_rmsnorm_2d_refuses_a_tensor_autograd_follows():
    """The kernel writes a tensor with no ``grad_fn``: under grad, a
    tensor that requires grad is refused (a gradient is never cut
    silently); the same call under ``no_grad`` runs."""
    x, s = (torch.from_numpy(a) for a in _xs(4, 64, 2))
    for xr, sr in ((x.clone().requires_grad_(), s),
                   (x, s.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="rmsnorm_diff"):
            trms.rmsnorm_2d(xr, sr)
        with torch.no_grad():
            assert torch.equal(trms.rmsnorm_2d(xr, sr),
                               trms.rmsnorm_2d_plain(x, s))


def test_apply_norm_is_differentiable_under_grad():
    """``models.common.apply_norm`` takes ``rmsnorm_diff`` while grad is
    enabled and the forward-only wrapper otherwise."""
    from repro_torch.models.common import apply_norm
    x, s = (torch.from_numpy(a) for a in _xs(3, 32, 3))
    before = tops.rmsnorm_diff.forwards
    with torch.no_grad():
        apply_norm({"scale": s}, x)
    assert tops.rmsnorm_diff.forwards == before
    st = s.clone().requires_grad_()
    out = apply_norm({"scale": st}, x)
    assert tops.rmsnorm_diff.forwards == before + 1
    (ds,) = torch.autograd.grad(out.sum(), st)
    assert bool(torch.isfinite(ds).all()) and bool(ds.abs().gt(0).all())


# ---- on the card --------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


_MANTISSA = {torch.bfloat16: 8, torch.float16: 11}


def _close(got, want):
    """bf16 and f16: |got - want| within one ulp of want in its dtype (one
    rounding of the same f32 value, which may land on either neighbour);
    f32: 1e-5 relative to want's largest value (the sums run in another
    order, and rsqrtf is within 2 ulp)."""
    if want.dtype == torch.float32:
        return float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                      e - _MANTISSA[want.dtype])
    return bool(((got.float() - want.float()).abs() <= ulp).all())


# (rows, d): granite's decode rows (4, 4096) and the prefill rows
# chip_smoke.py times (8192, 4096), a ragged width (not a multiple of the
# 16-byte vector), many narrow rows, and one wide row
_CARD = [(4, 4096), (8192, 4096), (3, 1001), (2048, 100), (1, 8192)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,d", _CARD)
def test_cuda_matches_plain_on_card(cuda, rows, d, dtype):
    g = torch.Generator(cuda).manual_seed(rows + d)
    x = (3 * torch.randn(rows, d, generator=g, device=cuda)).to(dtype)
    s = 1.0 + 0.1 * torch.randn(d, generator=g, device=cuda)
    before = dict(trms.rmsnorm_2d.launches_by_route)
    for scale in (s, s.to(dtype)):
        got = trms.rmsnorm_2d(x, scale, eps=1e-5)
        want = trms.rmsnorm_2d_plain(x, scale, eps=1e-5)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert _close(got, want), (rows, d, dtype, scale.dtype)
    assert trms.rmsnorm_2d.launches_by_route["cuda"] == before["cuda"] + 2
    assert trms.rmsnorm_2d.launches_by_route["triton"] == before["triton"]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,d,pad,offset", [
    (4, 4096, 64, 0),       # rows of a wider buffer, aligned
    (2048, 4096, 8, 0),     # prefill rows, aligned stride
    (4, 4096, 3, 0),        # a row stride that is not 16 bytes
    (4, 512, 0, 1)])        # a base that is not 16-byte aligned
def test_cuda_strided_rows_on_card(cuda, rows, d, pad, offset, dtype):
    g = torch.Generator(cuda).manual_seed(d + pad + offset)
    buf = torch.randn(rows * (d + pad) + offset, generator=g,
                      device=cuda).to(dtype)
    x = buf[offset:].view(rows, d + pad)[:, :d]
    s = (1.0 + 0.1 * torch.randn(d + 1, generator=g, device=cuda))[offset:
                                                                   offset + d]
    got = trms.rmsnorm_2d(x, s)
    want = trms.rmsnorm_2d_plain(x, s)
    torch.cuda.synchronize()
    assert got.is_contiguous() and _close(got, want)


@pytest.mark.card
def test_cuda_refusals_on_card(cuda):
    x = torch.randn(4, 64, device=cuda)
    s = torch.ones(64, device=cuda)
    before = dict(trms.rmsnorm_2d.launches_by_route)
    for bad_x, bad_s, why in (
            (x.double(), s, "dtypes"),
            (x, s.double(), "dtypes"),
            (x.t().contiguous().t(), s, "rows must be contiguous"),
            (x, torch.ones(32, device=cuda), "scale"),
            (x, torch.ones(128, device=cuda)[::2], "scale"),
            (x, s.cpu(), "CUDA device"),
            (torch.ones(2, 40000, device=cuda).bfloat16(),
             torch.ones(40000, device=cuda), "at most")):
        with pytest.raises(ValueError, match=why):
            trms.rmsnorm_2d(bad_x, bad_s)
    assert dict(trms.rmsnorm_2d.launches_by_route) == before


def _rel_max(a, b):
    """max |a - b| over max |b| across a tree (tests/test_equivalence)."""
    from repro_torch.core.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    num = max(float((x.cpu() - y).abs().max()) for x, y in zip(la, lb))
    return num / max(max(float(y.abs().max()) for y in lb), 1e-12)


@pytest.mark.card
def test_granite_smoke_layer_grads_match_cpu_on_card(cuda):
    """The schedule's gradients of granite-3-8b smoke (f32, K5 under grad
    on the card, weights streamed from pinned rows) against the same call
    on the CPU (every kernel's plain version), at the usual scales: the
    bound ``tests/test_torch_train.py`` holds the port's gradients to,
    1e-5 of the largest per part; every norm scale's gradient is finite
    and not zero, layer by layer."""
    from repro_torch import engine as engines
    from repro_torch.configs.base import get_config
    from repro_torch.core.schedule import ExecutionConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.testing import fan_in_params
    cfg = get_config("granite-3-8b", "smoke").replace(dtype="float32",
                                                      use_pallas=True)
    kw = dict(n_microbatches=2, weight_stream=True, pack_params=True,
              prefetch_depth=1, transport="pallas", offload_stash=True)
    cpu = engines.create("l2l-p", cfg, ExecutionConfig(**kw), device="cpu")
    card = engines.create("l2l-p", cfg, ExecutionConfig(**kw))
    g = torch.Generator().manual_seed(0)
    params = fan_in_params(cpu.model.param_specs(),
                           lambda shape: torch.randn(shape, generator=g))
    rs = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                   (4, 32))),
             "targets": torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                    (4, 32))),
             "mask": torch.ones(4, 32)}
    loss_c, want = cpu.grads(params, batch)
    k5 = trms.rmsnorm_2d.launches_by_route["cuda"]
    diff = tops.rmsnorm_diff.forwards
    loss_g, got = card.grads(tree_map(lambda a: a.to(cuda), params), batch)
    torch.cuda.synchronize()
    assert trms.rmsnorm_2d.launches_by_route["cuda"] > k5
    assert tops.rmsnorm_diff.forwards > diff
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * float(loss_c)
    for part in ("embed", "head", "groups"):
        assert _rel_max(got[part], want[part]) < 1e-5, part
    layers = got["groups"][0]
    scales = [layers[k]["scale"] for k in ("ln1", "ln2") if k in layers]
    for g in scales + [got["head"]["ln_f"]["scale"][None]]:
        g = g.cpu()              # (layers, d): one row per layer
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum(-1).gt(0)
                                                     .all())
