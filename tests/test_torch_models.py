"""The port's model modules on the CPU against the JAX package: the same
numpy inputs and bridged parameters through both, f32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.model import LayeredModel as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import init_numpy  # noqa: E402


# the dense configurations the port runs; the last three add qkv biases
# and a half-width rope (chatglm3, GQA 16 at full width), a parallel block
# with tied embeddings (command-r) and qkv biases at d 8192 (qwen1.5)
ARCHS = ["granite-3-8b", "bert-large", "chatglm3-6b", "command-r-35b",
         "qwen1.5-110b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _layer_weights(cfg, seed):
    """One dense layer drawn with numpy at a per-layer fan-in scale (the
    reference's own init draws every stacked matrix at std 1/sqrt(N) and
    drives activations into the thousands); norm scales near 1."""
    rs = np.random.RandomState(seed)

    def leaf(spec):
        if spec.init == "ones":
            return (1.0 + 0.1 * rs.randn(*spec.shape)).astype(np.float32)
        if spec.init == "zeros":          # biases: non-zero, to be seen
            return (0.1 * rs.randn(*spec.shape)).astype(np.float32)
        return (rs.randn(*spec.shape) / np.sqrt(spec.shape[0])) \
            .astype(np.float32)
    return jax.tree.map(leaf, jblocks.dense_spec(cfg),
                        is_leaf=jcommon.is_spec)


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e7), (0.5, 1e4),
                                            (0.25, 1e4)])
def test_apply_rope_matches_reference(fraction, theta):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 7, 3, 16).astype(np.float32)
    pos = rs.randint(0, 200, size=(2, 7)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda a, p: jcommon.apply_rope(
        a, p, theta, fraction))(jnp.asarray(x), jnp.asarray(pos)))
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta, fraction)
    # interleaved pairs rotated in f32; sin/cos of angles up to 200 rad
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunk", [0, 4, 16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_attend_matches_reference(chunk, causal, window):
    rs = np.random.RandomState(chunk + window)
    B, Sq, Sk, H, D = 2, 6, 11, 4, 8
    q = rs.randn(B, Sq, H, D).astype(np.float32)
    k = rs.randn(B, Sk, H, D).astype(np.float32)
    v = rs.randn(B, Sk, H, D).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(5, 5 + Sq, dtype=np.int32), (B, Sq))
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    k_pos[0, [2, 7]] = -1          # ring-buffer holes
    kw = dict(causal=causal, window=window, chunk=chunk)
    ref = np.asarray(jax.jit(lambda *a: jattn.attend(*a, **kw))(
        *map(jnp.asarray, (q, k, v, q_pos, k_pos))))
    got = tattn.attend(*map(torch.from_numpy, (q, k, v, np.array(q_pos),
                                               k_pos)), **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


# granite: RMSNorm, gated SiLU, GQA, rope theta 1e7; bert-large:
# layernorm, tanh-GELU, biased q/k/v/o and MLP; and the three above
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_dense_apply_matches_reference(arch, use_pallas):
    cfg = jget_config(arch, "smoke").replace(
        dtype="float32", use_pallas=use_pallas)
    tcfg = get_config(arch, "smoke").replace(
        dtype="float32", use_pallas=use_pallas)
    w = _layer_weights(cfg, seed=0)
    x = np.random.RandomState(1).randn(2, 16, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    prev = jcommon.use_pallas_rmsnorm(use_pallas)
    try:
        ref, _ = jax.jit(lambda ww, xx, pp: jblocks.dense_apply(
            ww, xx, None, jblocks.Ctx(positions=pp), cfg))(
            jax.tree.map(jnp.asarray, w), jnp.asarray(x), jnp.asarray(pos))
    finally:
        jcommon.use_pallas_rmsnorm(prev)
    got, _ = tblocks.dense_apply(
        bridge.params_from_numpy(w), torch.from_numpy(x), None,
        tblocks.Ctx(positions=torch.from_numpy(np.array(pos))), tcfg)
    # one f32 layer, attention via the flash kernel's plain version or
    # attend (and the Pallas kernel / attend on the JAX side): 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_dense_decode_matches_reference(per_row):
    cfg = jget_config("granite-3-8b", "smoke").replace(dtype="float32")
    tcfg = get_config("granite-3-8b", "smoke").replace(dtype="float32")
    w = _layer_weights(cfg, seed=3)
    rs = np.random.RandomState(2)
    B, L = 2, 8
    cache = {"k": rs.randn(B, L, cfg.n_kv_heads, cfg.d_head)
             .astype(np.float32),
             "v": rs.randn(B, L, cfg.n_kv_heads, cfg.d_head)
             .astype(np.float32),
             "pos": np.array([[0, 1, 2, -1, -1, -1, -1, -1]] * B, np.int32)}
    x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
    cur = np.array([3, -1], np.int32) if per_row else 3
    jcur = jnp.asarray(cur) if per_row else jnp.int32(cur)
    ref, ref_cache = jax.jit(lambda ww, xx, cc, cp: jblocks.dense_decode(
        ww, xx, cc, None, jblocks.Ctx(cur_pos=cp), cfg))(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), jcur)
    t_cache = bridge.params_from_numpy(cache)
    tcur = torch.from_numpy(cur) if per_row else cur
    got, got_cache = tblocks.dense_decode(
        bridge.params_from_numpy(w), torch.from_numpy(x), t_cache, None,
        tblocks.Ctx(cur_pos=tcur), tcfg)
    assert got_cache is t_cache           # the port updates in place
    rows = [0] if per_row else [0, 1]     # row 1 is padding when per-row
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows],
                               atol=1e-5, rtol=1e-5)
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(got_cache[key].numpy(),
                                   np.asarray(ref_cache[key]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_params_rows_byte_identical(arch, dtype):
    cfg = jget_config(arch, "smoke")
    params = jax.tree.map(jnp.asarray, init_numpy(cfg, 0, dtype))
    ref = jpacking.pack_params(params)["groups"][0]
    got = packing.pack_params(bridge.params_from_numpy(_np(params)))
    got = got["groups"][0]
    assert sorted(got.segs) == sorted(ref.segs)
    for key, seg in ref.segs.items():
        want = np.asarray(seg)
        have = bridge.params_to_numpy(got.segs[key])
        assert have.shape == want.shape
        assert have.tobytes() == want.tobytes()
    # and unpack gives the leaves back as views of the rows
    back = packing.unpack(got)
    orig = bridge.params_from_numpy(_np(params))["groups"][0]
    assert torch.equal(back["attn"]["wq"], orig["attn"]["wq"])
    leaves = tree_leaves(back)            # sorted-key order, as JAX's
    assert leaves[0].data_ptr() == got.segs[dtype].data_ptr()
    assert leaves[1].data_ptr() == got.segs[dtype].data_ptr() + \
        got.spec.leaves[1].offset * got.segs[dtype].element_size()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    ref = JModel(jget_config(arch, "smoke")).param_specs()
    got = LayeredModel(get_config(arch, "smoke")).param_specs()
    flat_ref = jax.tree.leaves(ref, is_leaf=jcommon.is_spec)
    flat_got = tree_leaves(got, is_leaf=tcommon.is_spec)
    assert [tuple(s) for s in flat_got] == [tuple(s) for s in flat_ref]
