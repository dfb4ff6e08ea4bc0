"""The parameter bridge between the JAX package and the port, and the
port's import boundary."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.testing import init_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["granite-3-8b", "bert-large"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(arch, dtype):
    tree = init_numpy(jget_config(arch, "smoke"), 1, dtype)
    t = bridge.params_from_numpy(tree)
    assert isinstance(t["groups"], tuple)
    assert t["embed"]["tok"].dtype == getattr(torch, dtype)
    back = bridge.params_to_numpy(t)
    want = jax.tree.leaves(tree)
    got = jax.tree.leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py",
     ROOT / "tests" / "torch_dp_worker.py"]))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


# ---- training states ----------------------------------------------------
from repro import engine as jengines  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core.schedule import ExecutionConfig as JExec  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.core import packing as tpacking  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402


@pytest.fixture(scope="module")
def jax_state():
    """A packed JAX l2l-p TrainState with bf16 masters, the loss scale on,
    and its parameters and Adam slots filled with numpy draws (so no slot
    is all zeros), in the reference's own shapes and layout
    (``Engine.init``'s, without compiling its initializers)."""
    from repro.engine.state import TrainState as JState
    cfg = jget_config("bert-large", "smoke").replace(
        n_layers=2, param_dtype="bfloat16")
    eng = jengines.create("l2l-p", cfg, JExec(
        pack_params=True, n_microbatches=2, loss_scale_init=128.0),
        donate=False)
    rs = np.random.RandomState(3)
    drawn = jax.tree.map(
        lambda s: jnp.asarray(rs.randn(*s.shape).astype(np.float32),
                              dtype=jnp.bfloat16),
        eng.model.param_specs(), is_leaf=lambda x: hasattr(x, "axes"))
    params = eng._relay_params(drawn)
    state = JState.from_legacy(params, eng._init_opt_legacy(params))
    rs = np.random.RandomState(0)
    opt = jpacking.unpack_opt_state(state.legacy_opt(), state.params)
    opt = {k: jax.tree.map(lambda a: jnp.asarray(
        rs.randn(*a.shape).astype(np.float32)), opt[k])
        for k in ("embed", "head", "groups")}
    opt = jpacking.pack_opt_state({**opt, "step": jnp.int32(7),
                                   "loss_scale": state.loss_scale},
                                  state.params)
    return JState.from_legacy(state.params, opt)


@pytest.mark.parametrize("pack", [False, True])
def test_train_state_round_trip_is_bit_exact(jax_state, pack):
    opt = jpacking.unpack_opt_state(jax_state.legacy_opt(), jax_state.params)
    params = jax.tree.map(np.asarray,
                          jpacking.unpack_params(jax_state.params))
    opt_np = {k: jax.tree.map(np.asarray, opt[k])
              for k in ("embed", "head", "groups")}
    ls = jax.tree.map(np.asarray, jax_state.loss_scale)
    st = bridge.train_state_from_numpy(params, opt_np, int(jax_state.step),
                                       ls, pack=pack)
    assert tpacking.is_packed(st.params["groups"][0]) == pack
    assert tpacking.opt_is_packed(st.opt_state["groups"][0]) == pack
    if pack:
        # the port's packed rows are the reference's, byte for byte
        for key, seg in jax_state.params["groups"][0].segs.items():
            assert bridge.params_to_numpy(
                st.params["groups"][0].segs[key]).tobytes() == \
                _bits(seg).tobytes()
        for slot in ("m", "v"):
            for key, seg in jax_state.opt_state["groups"][0][slot] \
                    .segs.items():
                assert st.opt_state["groups"][0][slot].segs[key] \
                    .numpy().tobytes() == np.asarray(seg).tobytes()
    p2, o2, step, ls2 = bridge.train_state_to_numpy(st)
    assert step == int(jax_state.step)
    for want, got in ((params, p2), (opt_np, o2), (ls, ls2)):
        lw, lg = jax.tree.leaves(want), jax.tree.leaves(got)
        assert len(lw) == len(lg)
        for w, g in zip(lw, lg):
            assert g.dtype == _bits(w).dtype and \
                g.tobytes() == _bits(w).tobytes()


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3)])
def test_synthetic_batches_equal_the_reference(seed, step):
    kw = dict(vocab_size=512, seq_len=48, global_batch=3, seed=seed)
    want = JSyntheticLM(JDataConfig(**kw)).batch(step)
    got = SyntheticLM(DataConfig(**kw)).batch(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
