"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode, same numpy inputs.

The CUDA and Triton kernels themselves run only on the card; chip_smoke.py
holds each one to the plain version tested here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
