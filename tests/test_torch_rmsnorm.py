"""K5's routes (``kernels/rmsnorm.py``): the CUDA C++ kernel (the default,
every launch of the serve path) and the Triton kernel kept for timing.

On the CPU: the route names the wrapper refuses, and that a CPU tensor
takes the plain version whatever the route (held to the JAX package's
Pallas kernel in interpret mode).

On the card (marker ``card``; ``python -m pytest -m card
tests/test_torch_rmsnorm.py``, which needs no JAX): the CUDA kernel against
its plain version at the serve path's decode and prefill rows and at a
ragged width, in f32, bf16 and f16, on a strided row view, and what it
refuses.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
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
