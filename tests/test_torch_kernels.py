"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode, same numpy inputs.

The CUDA and Triton kernels themselves run only on the card; chip_smoke.py
holds each one to the plain version tested here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import relay_copy as jrc  # noqa: E402
from repro.kernels import rmsnorm as jrms  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import relay_copy as trc  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402


@pytest.mark.parametrize("size,width", [(1, 1), (1, 2), (1, 7), (2, 5),
                                        (3, 1), (4, 16)])
def test_chunk_plan_matches_reference(size, width):
    assert trc._chunk_plan(size, width) == jrc._chunk_plan(size, width)


# multi-row plans (one chunk per row) and the single-row half-split plan;
# a copy is a copy: bitwise
@pytest.mark.parametrize("n,w,start,size", [(5, 33, 1, 3), (4, 16, 0, 4),
                                            (3, 1001, 2, 1), (2, 7, 0, 1)])
def test_copy_rows_bitwise(n, w, start, size):
    src = np.random.RandomState(n * w).randn(n, w).astype(np.float32)
    ref = np.asarray(jrc.copy_rows(jnp.asarray(src), start, size=size,
                                   interpret=True))
    got = trc.copy_rows(torch.from_numpy(src), start, size=size)
    assert got.numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("size,squeeze", [(1, True), (2, False)])
def test_fetch_slot_tree_bitwise(size, squeeze):
    rs = np.random.RandomState(3)
    tree = {"b": rs.randn(3, 4, 5).astype(np.float32),
            "a": {"w": rs.randn(3, 6).astype(np.float32)}}
    ref = jrc.fetch_slot({"b": jnp.asarray(tree["b"]),
                          "a": {"w": jnp.asarray(tree["a"]["w"])}},
                         1, size, squeeze=squeeze, interpret=True)
    got = trc.fetch_slot({"b": torch.from_numpy(tree["b"]),
                          "a": {"w": torch.from_numpy(tree["a"]["w"])}},
                         1, size, squeeze=squeeze)
    for r, g in [(ref["b"], got["b"]), (ref["a"]["w"], got["a"]["w"])]:
        assert g.numpy().tobytes() == np.asarray(r).tobytes()


@pytest.mark.parametrize("rows,d", [(8, 256), (4, 4096)])
def test_rmsnorm_2d_matches_pallas(rows, d):
    rs = np.random.RandomState(rows + d)
    x = rs.randn(rows, d).astype(np.float32) * 3.0
    s = (1.0 + 0.1 * rs.randn(d)).astype(np.float32)
    ref = np.asarray(jrms.rmsnorm_2d(jnp.asarray(x), jnp.asarray(s),
                                     eps=1e-6, interpret=True))
    got = trms.rmsnorm_2d(torch.from_numpy(x), torch.from_numpy(s), eps=1e-6)
    # one f32 reduction in a different order: 1e-6
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tops.rmsnorm(torch.from_numpy(x).reshape(2, rows // 2, d),
                     torch.from_numpy(s)).reshape(rows, d).numpy(),
        got.numpy())


# (B, H, Hkv, S, D): an MHA shape and a GQA shape (the kernel reads KV head
# h // (H/Hkv); the reference gets the expanded heads)
_SHAPES = [(1, 2, 2, 256, 32), (2, 4, 2, 128, 64)]
_MASKS = [dict(causal=True), dict(causal=True, window=48),
          dict(causal=True, soft_cap=5.0), dict(causal=False)]


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("mask", _MASKS)
def test_flash_attention_fwd_matches_pallas(shape, mask):
    B, H, Hkv, S, D = shape
    rs = np.random.RandomState(S + D)
    q = rs.randn(B, H, S, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    rep = H // Hkv
    o_ref, lse_ref = jfa.flash_attention_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=1)),
        jnp.asarray(np.repeat(v, rep, axis=1)), interpret=True, **mask)
    o, lse = tfa.flash_attention_fwd_bhsd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **mask)
    # f32 online softmax vs one f32 softmax over the whole row: 1e-5
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5,
                               rtol=1e-5)


def test_flash_attention_keeps_the_tiling_contract():
    q = torch.zeros(1, 1, 192, 32)
    with pytest.raises(AssertionError):
        tfa.flash_attention_fwd_bhsd(q, q, q)


def test_cuda_only_paths_refuse_cpu_misuse():
    src = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        trc.copy_rows(src, 0, size=1, device="meta")


# ---- K1 fused Adam: the plain version against the Pallas kernel --------
from repro.kernels import fused_adam as jadam  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fused_adam as tadam  # noqa: E402


@pytest.mark.parametrize("wd_form,wd", [(False, 0.0), (True, 0.01),
                                        (True, 0.0)])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
def test_fused_adam_plain_matches_pallas(wd_form, wd, p_dtype):
    rs = np.random.RandomState(7)
    n = 4096
    p = rs.randn(n).astype(np.float32)
    g = (rs.randn(n) * 1e-2).astype(np.float32)
    m = (rs.randn(n) * 1e-3).astype(np.float32)
    v = (np.abs(rs.randn(n)) * 1e-5).astype(np.float32)
    a, clip = np.float32(3e-4), np.float32(0.5)
    jdt = jnp.dtype(p_dtype)
    jp, jm, jv = jadam.fused_adam_flat(
        jnp.asarray(p).astype(jdt), jnp.asarray(g), jnp.asarray(m),
        jnp.asarray(v), jnp.float32(a), jnp.float32(clip), wd=wd,
        wd_form=wd_form, block=1024, interpret=True)
    tp = torch.from_numpy(p).to(getattr(torch, p_dtype))
    got = tadam.fused_adam_flat(tp, torch.from_numpy(g), torch.from_numpy(m),
                                torch.from_numpy(v), torch.tensor(a),
                                torch.tensor(clip), wd=wd, wd_form=wd_form)
    # the Pallas f32 adam arm is not bitwise to the eager chain on the CPU
    # (two red reference tests: XLA contracts b1*m + (1-b1)*g into an FMA,
    # and where the two terms cancel the relative error grows): 1e-6
    # relative to each array's largest value; bf16 masters may round to
    # the neighbouring value (one bf16 ulp, 2^-8 relative)
    def close(got_, want_, rtol=1e-6):
        want_ = np.asarray(want_).astype(np.float32)
        np.testing.assert_allclose(got_.float().numpy(), want_, rtol=rtol,
                                   atol=1e-6 * np.abs(want_).max())
    tol = 8e-3 if p_dtype == "bfloat16" else 1e-6
    close(got[0], jp, tol)
    close(got[1], jm)
    close(got[2], jv)
    if wd_form:
        want = jref.ref_adam(jnp.asarray(p).astype(jdt), jnp.asarray(g),
                             jnp.asarray(m), jnp.asarray(v), a, clip, wd=wd)
        close(got[0], want[0], tol)


def test_fused_adam_op_keeps_shape():
    p = torch.randn(3, 5)
    z = torch.zeros(3, 5)
    out = tops.fused_adam(p, torch.ones(3, 5), z, z, 1e-3, 1.0)
    assert all(o.shape == (3, 5) for o in out)
    assert torch.equal(out[1], torch.full((3, 5), 0.1))


# ---- K3 flash-attention backward ---------------------------------------
# (B, H, Hkv, S, D, mask): causal, a window, and two lengths that the CUDA
# kernels' 64- and 32-row tiles do not divide, one of them GQA
_BWD = [(2, 2, 2, 128, 32, dict(causal=True)),
        (1, 2, 2, 128, 64, dict(causal=True, window=40)),
        (1, 4, 2, 72, 32, dict(causal=True)),
        (1, 2, 2, 100, 32, dict(causal=False))]


@pytest.mark.parametrize("B,H,Hkv,S,D,mask", _BWD)
def test_flash_attention_bwd_matches_pallas(B, H, Hkv, S, D, mask):
    rs = np.random.RandomState(S * D)
    q = rs.randn(B, H, S, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    do = rs.randn(B, H, S, D).astype(np.float32)
    rep = H // Hkv
    ke, ve = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    o, lse = jfa.flash_attention_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve), interpret=True,
        **mask)
    jdq, jdk, jdv = jfa.flash_attention_bwd_bhsd(
        jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve), o, lse,
        jnp.asarray(do), interpret=True, **mask)
    jdk = np.asarray(jdk).reshape(B, Hkv, rep, S, D).sum(2)
    jdv = np.asarray(jdv).reshape(B, Hkv, rep, S, D).sum(2)
    got = tfa.flash_attention_bwd_bhsd(
        *(torch.from_numpy(np.asarray(a)) for a in (q, k, v, o, lse, do)),
        **mask)
    # f32, tiled sums in the Pallas kernel against whole-row products: 1e-5
    for g, w in zip(got, (np.asarray(jdq), jdk, jdv)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    # the K3a / K3b wrappers' CPU paths give the same pieces
    t = [torch.from_numpy(np.asarray(a)) for a in (q, k, v, do, lse)]
    delta = (t[3] * torch.from_numpy(np.asarray(o))).sum(-1)
    assert torch.equal(tfa.flash_attention_bwd_dq(*t, delta, **mask), got[0])
    dk, dv = tfa.flash_attention_bwd_dkv(*t, delta, **mask)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=True, window=9)])
def test_flash_attention_autograd_matches_reference(mask):
    """ops.flash_attention (the autograd.Function) against torch autograd
    through ref_attention, on the model's (B, S, H, D) layout with GQA."""
    from repro_torch.kernels.ref import ref_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 48, h, 32, generator=g) for h in (4, 2, 2))
    do = torch.randn(2, 48, 4, 32, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves, **mask)
    got = torch.autograd.grad(out, leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want_o = ref_attention(*(t.transpose(1, 2) for t in leaves),
                           **mask)[0].transpose(1, 2)
    want = torch.autograd.grad(want_o, leaves, do)
    # f32: autograd through softmax vs the recomputed-p formula, 1e-5
    assert torch.equal(out.detach(), want_o.detach())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_soft_cap_has_no_backward():
    q = torch.randn(1, 16, 2, 32, requires_grad=True)
    out = tops.flash_attention(q, q, q, soft_cap=5.0)
    with pytest.raises(NotImplementedError):
        out.sum().backward()


# ---- K4 write-back -----------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_writeback_slot_bitwise(dtype):
    """A layer's products land in their row of the stacked buffers, bit
    for bit, as the reference's write-back (an identity copy) leaves
    them."""
    import jax
    rs = np.random.RandomState(11)
    tree = {"a": rs.randn(4, 5).astype(np.float32),
            "b": {"c": rs.randn(7).astype(np.float32)}}
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)
    want = jrc.writeback_slot(jt, interpret=True)
    tt = jax.tree.map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)),
                      tree)
    out = {"a": torch.zeros(3, 4, 5, dtype=getattr(torch, dtype)),
           "b": {"c": torch.zeros(3, 7, dtype=getattr(torch, dtype))}}
    trc.writeback_slot(tt, out=out, row=1)
    for w, o in [(want["a"], out["a"]), (want["b"]["c"], out["b"]["c"])]:
        w = np.asarray(w.astype(jnp.float32))
        assert np.array_equal(o[1].float().numpy(), w)
        assert not o[0].any() and not o[2].any()


# ---- K4's spans: the pure-Python part of the launch --------------------
from repro_torch.kernels import host_alloc as tha  # noqa: E402


def _random_spans(rs):
    es = int(rs.choice([1, 2, 4]))
    size, w = int(rs.choice([1, 1, 2, 3])), int(rs.randint(1, 3000))
    start = int(rs.randint(0, 4))
    src_addr = int(rs.randint(0, 1 << 20)) * int(rs.choice([1, 4, 16]))
    dst_addr = int(rs.randint(0, 1 << 16)) * 256
    host_is_src = bool(rs.rand() < 0.5)
    lines = bool(rs.rand() < 0.7)
    spans = trc._spans(trc._chunk_plan(size, w), es, w * es, start, 0,
                       src_addr=src_addr, dst_addr=dst_addr,
                       host_is_src=host_is_src, lines=lines)
    return (es, size, w, start, src_addr, dst_addr, host_is_src, lines,
            spans)


@pytest.mark.parametrize("seed", range(4))
def test_spans_cover_the_plan_exactly_once(seed):
    """Merged or split at the host's 128-byte lines, the spans of a chunk
    plan cover its bytes [0, size * w * es) of the slot exactly once, each
    at its own row offset of the source."""
    rs = np.random.RandomState(seed)
    for _ in range(200):
        es, size, w, start, sa, da, host_src, lines, spans = \
            _random_spans(rs)
        covered = np.zeros(size * w * es, dtype=np.int64)
        for s, d, n in spans:
            assert n > 0 and s - d == start * w * es
            covered[d:d + n] += 1
        assert (covered == 1).all()
        if not lines:
            continue
        for s, d, n in spans:
            host = (sa + s) if host_src else (da + d)
            if (sa + s - da - d) % 16 == 0 and n >= trc.LINE \
                    and host % trc.LINE == 0:
                assert n % trc.LINE == 0      # a body: whole lines


def test_spans_merge_and_peel():
    # one span per chunk of the plan, or the plan's chunks merged (the
    # half-row plan of one row, three whole rows) and split at the host's
    # 128-byte lines: a row that starts 16 bytes into a line gets a
    # 112-byte head, whole lines and a tail
    assert trc._spans(trc._chunk_plan(1, 1000), 4, 4000, 0, 0) == \
        [(0, 0, 2000), (2000, 2000, 2000)]
    assert trc._spans(trc._chunk_plan(1, 1024), 4, 4096, 0, 0,
                      lines=True) == [(0, 0, 4096)]
    assert trc._spans(trc._chunk_plan(3, 1024), 4, 4096, 2, 0,
                      lines=True) == [(8192, 0, 12288)]
    got = trc._spans(((0, 0, 1028),), 4, 4112, 1, 0, lines=True)
    assert got == [(4112, 0, 112), (4224, 112, 3968), (8192, 4080, 32)]
    # sides that disagree modulo 16 bytes are not split (word loop)
    assert trc._spans(trc._chunk_plan(1, 1001), 4, 4004, 1, 0,
                      lines=True) == [(4004, 0, 4004)]


def test_relay_copy_routes():
    assert trc.FETCH_ROUTE == trc.WRITEBACK_ROUTE == "lines"
    assert trc.ROUTES["lines"].blocks == trc.LINE_BLOCKS
    assert set(trc.copy_rows.launches_by_route) == set(trc.ROUTES)
    assert set(trc.writeback_rows.launches_by_route) == set(trc.ROUTES)
    # a CPU tensor takes the plain version, whatever the route
    src = torch.arange(12.0).view(3, 4)
    for route in trc.ROUTES:
        assert torch.equal(trc.copy_rows(src, 1, size=2, route=route),
                           src[1:3])
    with pytest.raises(ValueError):
        tha.empty((4,), torch.float32, kind="pageable")
