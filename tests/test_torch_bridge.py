"""The parameter bridge between the JAX package and the port, and the
port's import boundary."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.models.model import LayeredModel as JModel  # noqa: E402
from repro_torch import bridge  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["granite-3-8b", "bert-large"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(arch, dtype):
    params = JModel(jget_config(arch, "smoke")).init_params(
        jax.random.PRNGKey(1), dtype=jnp.dtype(dtype))
    tree = jax.tree.map(np.asarray, params)
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
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"
