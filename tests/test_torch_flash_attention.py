"""The bf16 (wgmma) route of K2, K3a and K3b (``kernels/flash_attention.py``).

On the CPU: the route's numerics, emulated in plain torch
(``ref_attention(..., tensor_cores=True)`` and its backward), against the
JAX package's Pallas kernels in interpret mode on bf16 inputs, within the
bounds ``chip_smoke.py`` holds the kernels to; the Python-side
preconditions of the TMA tensor maps; the routing by dtype.

On the card (marker ``card``; ``python -m pytest -m card
tests/test_torch_flash_attention.py``, which needs no JAX): the CUDA
kernels against their plain versions at D = 32, 64 and 128, with GQA,
causal, window, soft-cap and ragged lengths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.ref import (ref_attention,  # noqa: E402
                                     ref_attention_bwd)

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def jfa():
    pytest.importorskip("jax")
    from repro.kernels import flash_attention
    return flash_attention


def _inputs(B, H, Hkv, S, D, seed, n_q=2):
    """bf16 (B, H, S, D) q-shaped and (B, Hkv, S, D) kv-shaped tensors from
    a seeded numpy draw: q, k, v and, with ``n_q=2``, dO."""
    rs = np.random.RandomState(seed)
    shapes = [(B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)] + \
        [(B, H, S, D)] * (n_q - 1)
    return [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(BF16)
            for s in shapes]


def _jnp_bf16(t):
    import jax.numpy as jnp
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return np.array(x, dtype=np.float32)


# (B, H, Hkv, S, D, mask): every head dim of the route, GQA and MHA, causal,
# a window, soft-cap (forward only: the reference's backward has none), and
# a non-causal call
_FWD = [(1, 4, 2, 128, 32, dict(causal=True)),
        (1, 4, 2, 128, 64, dict(causal=True, window=40)),
        (1, 4, 2, 256, 128, dict(causal=True)),
        (1, 2, 2, 128, 64, dict(causal=True, soft_cap=5.0)),
        (1, 2, 1, 128, 128, dict(causal=False))]


@pytest.mark.parametrize("B,H,Hkv,S,D,mask", _FWD)
def test_tensor_core_numerics_fwd_within_bounds(jfa, B, H, Hkv, S, D, mask):
    """The route's rounding points (scale after the f32 product, P in bf16
    before P·V) stay within chip_smoke.py's bf16 bound on o and lse: 2e-2
    against the Pallas kernel on the same bf16 inputs."""
    q, k, v = _inputs(B, H, Hkv, S, D, seed=S + D, n_q=1)
    rep = H // Hkv
    o_ref, lse_ref = jfa.flash_attention_fwd_bhsd(
        _jnp_bf16(q), _jnp_bf16(k.repeat_interleave(rep, 1)),
        _jnp_bf16(v.repeat_interleave(rep, 1)), interpret=True, **mask)
    o, lse = ref_attention(q, k, v, tensor_cores=True, **mask)
    assert o.dtype == BF16 and lse.dtype == torch.float32
    assert np.abs(o.float().numpy() - _np(o_ref)).max() <= 2e-2
    assert np.abs(lse.numpy() - _np(lse_ref)).max() <= 2e-2


_BWD = [(1, 4, 2, 128, 32, dict(causal=True)),
        (1, 2, 2, 128, 64, dict(causal=True)),
        (1, 4, 2, 128, 64, dict(causal=True, window=40)),
        (1, 4, 2, 128, 128, dict(causal=True)),
        (1, 2, 2, 128, 128, dict(causal=False))]


@pytest.mark.parametrize("B,H,Hkv,S,D,mask", _BWD)
def test_tensor_core_numerics_dkv_within_bounds(jfa, B, H, Hkv, S, D, mask):
    """P^T and dS^T in bf16 before their products, dk's scale after the sum:
    dk and dv within chip_smoke.py's bf16 bound, 1e-2 of the largest
    gradient, of the Pallas backward on the same bf16 inputs (summed over
    each kv head's q heads)."""
    q, k, v, do = _inputs(B, H, Hkv, S, D, seed=3 * S + D)
    rep = H // Hkv
    ke, ve = (t.repeat_interleave(rep, 1) for t in (k, v))
    jq, jk, jv, jdo = (_jnp_bf16(t) for t in (q, ke, ve, do))
    o, lse = jfa.flash_attention_fwd_bhsd(jq, jk, jv, interpret=True, **mask)
    _, jdk, jdv = jfa.flash_attention_bwd_bhsd(jq, jk, jv, o, lse, jdo,
                                               interpret=True, **mask)
    want = [_np(g).reshape(B, Hkv, rep, S, D).sum(2) for g in (jdk, jdv)]
    o_t = torch.from_numpy(_np(o)).to(BF16)
    _, dk, dv = ref_attention_bwd(q, k, v, o_t, torch.from_numpy(_np(lse)),
                                  do, tensor_cores=True, **mask)
    top = max(np.abs(w).max() for w in want)
    for got, w in zip((dk, dv), want):
        assert got.dtype == BF16
        assert np.abs(got.float().numpy() - w).max() <= 1e-2 * top


@pytest.mark.parametrize("B,H,Hkv,S,D,mask", _BWD)
def test_tensor_core_numerics_dq_within_bounds(jfa, B, H, Hkv, S, D, mask):
    """dS in bf16 before dS·K, the scale after the f32 product q·k and after
    the sum: dq within chip_smoke.py's bf16 bound, 1e-2 of the largest
    gradient, of the Pallas backward on the same bf16 inputs."""
    q, k, v, do = _inputs(B, H, Hkv, S, D, seed=5 * S + D)
    rep = H // Hkv
    ke, ve = (t.repeat_interleave(rep, 1) for t in (k, v))
    jq, jk, jv, jdo = (_jnp_bf16(t) for t in (q, ke, ve, do))
    o, lse = jfa.flash_attention_fwd_bhsd(jq, jk, jv, interpret=True, **mask)
    jdq, _, _ = jfa.flash_attention_bwd_bhsd(jq, jk, jv, o, lse, jdo,
                                             interpret=True, **mask)
    want = _np(jdq)
    o_t = torch.from_numpy(_np(o)).to(BF16)
    dq, _, _ = ref_attention_bwd(q, k, v, o_t, torch.from_numpy(_np(lse)),
                                 do, tensor_cores=True, **mask)
    assert dq.dtype == BF16
    assert np.abs(dq.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()


def _bshd(B, S, H, D, pad=0, offset=0):
    """A (B, H, S, D) bf16 view of a (B, S, H, D + pad) buffer, starting
    ``offset`` elements into it: the model's layout read through strides."""
    buf = torch.zeros(B * S * H * (D + pad) + offset, dtype=BF16)
    t = buf[offset:].view(B, S, H, D + pad)[..., :D]
    return t.transpose(1, 2)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_tma_preconditions_accept_the_model_layout(D):
    tfa.check_tma(_bshd(2, 48, 4, D), _bshd(1, 16, 2, D))
    # a dim of extent 1 may carry any stride
    tfa.check_tma(torch.zeros(3 * D, dtype=BF16).as_strided(
        (1, 3, 1, D), (7, D, 5, 1)))


@pytest.mark.parametrize("bad,why", [
    (lambda: _bshd(2, 16, 4, 32, pad=4), "strides"),      # 72-byte rows
    (lambda: _bshd(2, 16, 4, 64, offset=1), "aligned"),   # base + 2 bytes
    (lambda: _bshd(2, 16, 4, 96), "head dim"),
    (lambda: _bshd(2, 64, 4, 64).transpose(2, 3), "contiguous"),
    (lambda: _bshd(2, 16, 4, 64).float(), "dtype"),
])
def test_tma_preconditions_refuse_what_a_tensor_map_cannot_describe(bad,
                                                                    why):
    with pytest.raises(ValueError, match=why):
        tfa.check_tma(bad())


def test_tma_preconditions_run_before_any_launch(monkeypatch):
    """A bf16 call the tensor maps cannot describe raises in the wrapper
    before the kernel library is touched (device checks stubbed: meta
    tensors stand in for CUDA ones)."""
    def no_launch():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "library", no_launch)
    monkeypatch.setattr(tfa, "_check", lambda *a: None)
    monkeypatch.setattr(tfa, "_check_bwd", lambda *a: None)
    q = torch.empty(1, 16, 4, 36, dtype=BF16, device="meta")[..., :32] \
        .transpose(1, 2)
    k = torch.empty(1, 2, 16, 32, dtype=BF16, device="meta")
    lse = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="strides"):
        tfa.flash_attention_fwd_bhsd(q, k, k)
    with pytest.raises(ValueError, match="strides"):
        tfa.flash_attention_bwd_dkv(q, k, k, q, lse, lse)


def test_dq_tma_preconditions_run_before_any_launch(monkeypatch):
    """K3a's bf16 call that the tensor maps cannot describe raises in the
    wrapper before the kernel library is touched, as K2's and K3b's do."""
    def no_launch():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "library", no_launch)
    monkeypatch.setattr(tfa, "_check_bwd", lambda *a: None)
    q = torch.empty(1, 16, 4, 36, dtype=BF16, device="meta")[..., :32] \
        .transpose(1, 2)
    k = torch.empty(1, 2, 16, 32, dtype=BF16, device="meta")
    lse = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="strides"):
        tfa.flash_attention_bwd_dq(q, k, k, q, lse, lse)
    # the right dtype with an explicit route name that does not exist
    with pytest.raises(ValueError, match="route"):
        tfa.flash_attention_bwd_dq(k, k, k, k, lse, lse, route="tensor")


class _FakeLib:
    """Stands in for the kernel library: records which entry was called."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 0
        return entry


@pytest.mark.parametrize("dtype,entry,route", [
    (torch.bfloat16, "fa_bwd_dq_sm90", "wgmma"),
    (torch.float32, "fa_bwd_dq", "cuda_core")])
def test_dq_routes_by_dtype(monkeypatch, dtype, entry, route):
    """K3a launches the wgmma kernel for bf16 and the CUDA-core kernel for
    f32, and counts the launch on that route (device checks, strides and
    stream stubbed: meta tensors stand in for CUDA ones)."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(tfa, "_check_bwd", lambda *a: None)
    monkeypatch.setattr(tfa, "_bwd_args", lambda q, *a: (
        None, tuple(q.shape[:2]) + (2, 16, 16, 32), (0.1, 1, 0, 1, 0)))
    q = torch.empty(1, 16, 4, 32, dtype=dtype, device="meta").transpose(1, 2)
    k = torch.empty(1, 2, 16, 32, dtype=dtype, device="meta")
    lse = torch.empty(1, 4, 16, device="meta")
    before = dict(tfa.flash_attention_bwd_dq.launches_by_route)
    dq = tfa.flash_attention_bwd_dq(q, k, k, q, lse, lse)
    assert lib.called == [entry]
    assert dq.shape == q.shape and dq.dtype == dtype
    assert tfa.flash_attention_bwd_dq.launches_by_route[route] == \
        before[route] + 1


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_core")])
def test_route_by_dtype(dtype, route):
    assert tfa.route_for(dtype) == route
    assert set(tfa.flash_attention_fwd_bhsd.launches_by_route) == \
        set(tfa.ROUTES) == set(tfa.flash_attention_bwd_dkv.launches_by_route) \
        == set(tfa.flash_attention_bwd_dq.launches_by_route)


def test_route_refuses_other_dtypes_and_names():
    with pytest.raises(ValueError):
        tfa.route_for(torch.float16)
    with pytest.raises(ValueError):
        tfa._route(torch.zeros(1, dtype=BF16), "cpu")


# ---- on the card --------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(B, H, Hkv, S, D, seed, dev):
    """bf16 tensors in the model's (B, S, H, D) layout on the card, read as
    (B, H, S, D) views."""
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(B, S, h, D, generator=g, device=dev).to(BF16)
            .transpose(1, 2) for h in (H, Hkv, Hkv, H)]


# (B, H, Hkv, S, D, mask): the head dims, GQA, masks, and lengths that the
# tiles do not divide (16: one tile, mostly past the end; the wrapper's
# tiling contract takes a length that is not a multiple of 128 only up to
# 128)
_CARD = [(2, 4, 2, 256, 32, dict(causal=True)),
         (2, 4, 2, 512, 64, dict(causal=True)),
         (1, 4, 1, 384, 128, dict(causal=True)),
         (4, 8, 2, 16, 128, dict(causal=True)),
         (1, 4, 2, 100, 64, dict(causal=True, window=70)),
         (1, 2, 2, 120, 128, dict(causal=False)),
         (1, 4, 2, 256, 64, dict(causal=True, soft_cap=5.0))]


@pytest.mark.card
@pytest.mark.parametrize("B,H,Hkv,S,D,mask", _CARD)
def test_wgmma_fwd_matches_plain_on_card(cuda, B, H, Hkv, S, D, mask):
    q, k, v, _ = _card_inputs(B, H, Hkv, S, D, S + D, cuda)
    before = dict(tfa.flash_attention_fwd_bhsd.launches_by_route)
    o, lse = tfa.flash_attention_fwd_bhsd(q, k, v, **mask)
    po, plse = tfa.flash_attention_fwd_bhsd_plain(q, k, v, **mask)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd_bhsd.launches_by_route["wgmma"] == \
        before["wgmma"] + 1
    # chip_smoke.py's bf16 bound on o and lse
    assert float((o.float() - po.float()).abs().max()) <= 2e-2
    assert float((lse - plse).abs().max()) <= 2e-2


@pytest.mark.card
@pytest.mark.parametrize("B,H,Hkv,S,D,mask",
                         [c for c in _CARD if "soft_cap" not in c[5]])
def test_wgmma_dkv_matches_plain_on_card(cuda, B, H, Hkv, S, D, mask):
    q, k, v, do = _card_inputs(B, H, Hkv, S, D, 2 * S + D, cuda)
    o, lse = tfa.flash_attention_fwd_bhsd(q, k, v, **mask)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **mask)
    again = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **mask)
    _, pk, pv = tfa.flash_attention_bwd_bhsd_plain(q, k, v, o, lse, do,
                                                   **mask)
    torch.cuda.synchronize()
    # no atomics: the same bits on every run
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    top = max(float(t.float().abs().max()) for t in (pk, pv))
    # chip_smoke.py's bf16 bound: 1e-2 of the largest gradient
    for got, want in ((dk, pk), (dv, pv)):
        assert float((got.float() - want.float()).abs().max()) <= 1e-2 * top


@pytest.mark.card
@pytest.mark.parametrize("B,H,Hkv,S,D,mask",
                         [c for c in _CARD if "soft_cap" not in c[5]])
def test_wgmma_dq_matches_plain_on_card(cuda, B, H, Hkv, S, D, mask):
    q, k, v, do = _card_inputs(B, H, Hkv, S, D, 3 * S + D, cuda)
    o, lse = tfa.flash_attention_fwd_bhsd(q, k, v, **mask)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    before = dict(tfa.flash_attention_bwd_dq.launches_by_route)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **mask)
    again = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **mask)
    pq, pk, pv = tfa.flash_attention_bwd_bhsd_plain(q, k, v, o, lse, do,
                                                    **mask)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd_dq.launches_by_route["wgmma"] == \
        before["wgmma"] + 2
    # no atomics: the same bits on every run
    assert torch.equal(dq, again)
    top = max(float(t.float().abs().max()) for t in (pq, pk, pv))
    # chip_smoke.py's bf16 bound: 1e-2 of the largest gradient
    assert float((dq.float() - pq.float()).abs().max()) <= 1e-2 * top


@pytest.mark.card
def test_wgmma_dq_refuses_unaligned_views_on_card(cuda):
    q = torch.zeros(1, 16, 4, 36, dtype=BF16, device=cuda)[..., :32] \
        .transpose(1, 2)
    lse = torch.zeros(1, 4, 16, device=cuda)
    before = dict(tfa.flash_attention_bwd_dq.launches_by_route)
    with pytest.raises(ValueError, match="strides"):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    assert dict(tfa.flash_attention_bwd_dq.launches_by_route) == before


@pytest.mark.card
def test_wgmma_route_refuses_unaligned_views_on_card(cuda):
    q = torch.zeros(1, 16, 4, 36, dtype=BF16, device=cuda)[..., :32] \
        .transpose(1, 2)
    with pytest.raises(ValueError, match="strides"):
        tfa.flash_attention_fwd_bhsd(q, q, q)
