"""Data-parallel L2L-p over the mesh's data axes on the CPU: two gloo
ranks (tests/torch_dp_worker.py, one process each, one file store), each
on its rows of a global batch, held to the JAX reference run on one device
over the whole batch; the ranks bit for bit equal to each other; a world of
one bit for bit the meshless engine on every entry point; the relay knobs
bit for bit inside the two-rank mesh; MoE on two data ranks and on a
model axis and the VLM family on a model axis accepted, ``serve_session``
on two data ranks refused.

bert-large (layernorm, MHA with biases) and granite-3-8b (RMSNorm, GQA)
at smoke size, f32, parameters drawn with numpy at fan-in scales
(``repro_torch.testing.fan_in_params``) and bridged into both packages.
One spawn of the three processes for the module, and of the train CLI
on two ranks under ``torch.distributed.run`` (the JAX reference runs
beside them)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengines  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core.schedule import ExecutionConfig as JExec  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ARCHS = ("bert-large", "granite-3-8b")
N_KNOBS = 6                      # torch_dp_worker.KNOBS, the first the base
TOL_UPDATE = 1e-3
B, S = 4, 16


def _draw(arch):
    """numpy parameters (port flatten order) and a global batch."""
    rs = np.random.RandomState(ARCHS.index(arch))
    cfg = get_config(arch, "smoke")
    specs = LayeredModel(cfg).param_specs()
    params = fan_in_params(specs, lambda shape: rs.randn(*shape))
    leaves = [np.asarray(a, np.float32)
              for a in tree_leaves(params)]
    mask = np.ones((B, S), np.float32)
    mask[1, -3:] = 0.0                      # a weighted loss, as padding
    mask[2, -6:] = 0.0                      # unequal weight on each rank
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "targets": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "mask": mask}
    return leaves, batch


def _cli(tmp):
    """The train CLI on two gloo ranks under ``torch.distributed.run``."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--device", "cpu",
         "--mesh", "data=2", "--arch", "bert-large", "--variant", "smoke",
         "--d-model", "32", "--n-layers", "2", "--batch", "4", "--seq",
         "16", "--ub", "2", "--steps", "2", "--pack", "--weight-stream",
         "--ckpt-dir", str(tmp / "ck")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)


def _spawn(tmp, inp, world):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    store = str(tmp / f"store{world}")
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_worker.py"), inp,
         str(tmp / f"out{world}_{r}.npz"), store, str(r), str(world)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]


def _reference(arch, leaves, batch):
    """The JAX l2l-p engine on the whole batch: two train steps (the first
    one's Adam slots give the gradients), prefill and decode (plain
    attention; the port's kernels' plain versions are held to the Pallas
    ones elsewhere)."""
    from repro.engine.state import TrainState as JState
    cfg = jget_config(arch, "smoke").replace(dtype="float32")
    eng = jengines.create("l2l-p", cfg, JExec(n_microbatches=2),
                          donate=False)
    like = eng.model.param_specs()
    it = iter(leaves)
    params = jax.tree.map(lambda _: jnp.asarray(next(it)), like,
                          is_leaf=lambda x: hasattr(x, "axes"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = JState.from_legacy(params, eng._init_opt_legacy(params))
    out = {}
    for i in range(2):
        state, m = eng.train_step(state, jb)
        out[f"train{i}/loss"] = float(m["loss"])
        out[f"train{i}/grad_norm"] = float(m["grad_norm"])
        if i == 0:
            # Adam's first step leaves m = (1 - b1)·g = 0.1·g: the
            # gradients without a second compiled program
            opt = jpacking.unpack_opt_state(state.legacy_opt(),
                                            state.params)
            out["grads/loss"] = out["train0/loss"]
            out["grads/grads"] = [
                np.asarray(s["m"]) / np.float32(0.1) for s in jax.tree.leaves(
                    {k: opt[k] for k in ("embed", "head", "groups")},
                    is_leaf=lambda x: isinstance(x, dict) and "m" in x)]
    out["train/params"] = [np.asarray(a) for a in jax.tree.leaves(
        jpacking.unpack_params(state.params))]
    prompt = jb["tokens"][:, :8]
    out["prefill"] = np.asarray(eng.prefill(params, {"tokens": prompt}))
    caches, last = eng.decode_init(params, prompt, 10)
    logits = [np.asarray(last)]
    for i in range(2):
        lg, caches = eng.decode_step(params, caches,
                                     jb["tokens"][:, 8 + i:9 + i],
                                     jnp.int32(8 + i))
        logits.append(np.asarray(lg[:, -1]))
    out["decode"] = logits
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    drawn = {a: _draw(a) for a in ARCHS}
    inp = {}
    for a, (leaves, batch) in drawn.items():
        inp.update({f"{a}/p/{i}": x for i, x in enumerate(leaves)})
        inp.update({f"{a}/b/{k}": v for k, v in batch.items()})
    path = str(tmp / "in.npz")
    np.savez(path, **inp)
    procs = _spawn(tmp, path, 2) + _spawn(tmp, path, 1) + [_cli(tmp)]
    try:
        ref = {a: _reference(a, *drawn[a]) for a in ARCHS}
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs[:-1], logs):
        assert p.returncode == 0, log
    load = lambda name: dict(np.load(str(tmp / name)))
    return dict(ranks=[load("out2_0.npz"), load("out2_1.npz")],
                one=load("out1_0.npz"), ref=ref,
                params={a: drawn[a][0] for a in ARCHS},
                batch={a: drawn[a][1] for a in ARCHS},
                cli=(procs[-1].returncode, logs[-1], str(tmp / "ck")))


def _get(out, key):
    """The arrays stored under ``key`` (``key/0``, ``key/1``, ...)."""
    n = 0
    while f"{key}/{n}" in out:
        n += 1
    assert n, key
    return [out[f"{key}/{i}"] for i in range(n)]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rows(arrays, rank):
    """A rank's half of full-batch rows (B // 2 each, rank order)."""
    h = B // 2
    return [a[rank * h:(rank + 1) * h] for a in arrays]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["train", "grads", "prefill", "decode"])
def test_two_ranks_match_the_reference_on_the_whole_batch(runs, arch,
                                                          what):
    """f32 at fan-in scales; the two ranks' microbatches hold other rows
    than the reference's, so sums run in other orders: losses, grad norms
    and gradients (rel L2 per leaf) within 1e-5 (measured: 0, 8.7e-8 -
    7.9e-7, 1.6e-6), logits within 1e-5 of their largest (1.5e-6); after
    two Adam steps each leaf's update within 1e-3 relative L2 of the
    reference's (3.9e-4 measured: Adam moves an element whose gradient is
    near 0 by ~lr either way)."""
    ref = runs["ref"][arch]
    for rank, out in enumerate(runs["ranks"]):
        pre = f"{arch}/"
        if what == "train":
            for i in range(2):
                for k in ("loss", "grad_norm"):
                    got = float(_get(out, f"{pre}train{i}/{k}")[0])
                    want = ref[f"train{i}/{k}"]
                    assert abs(got - want) <= 1e-5 * abs(want), (i, k)
            wsum = float(runs["batch"][arch]["mask"].sum())
            assert float(_get(out, f"{pre}train0/weight_sum")[0]) == wsum
            for g, w, p0 in zip(_get(out, f"{pre}train/params"),
                                ref["train/params"], runs["params"][arch]):
                assert _rel_l2(g - p0, w - p0) <= TOL_UPDATE
        elif what == "grads":
            assert abs(float(_get(out, f"{pre}grads/loss")[0])
                       - ref["grads/loss"]) <= 1e-5 * ref["grads/loss"]
            for g, w in zip(_get(out, f"{pre}grads/grads"),
                            ref["grads/grads"]):
                assert _rel_l2(g, w) <= 1e-5
        else:
            got = _get(out, pre + what)
            want = ([ref["prefill"]] if what == "prefill"
                    else ref["decode"])
            for g, w in zip(got, _rows(want, rank)):
                scale = max(float(np.abs(w).max()), 1e-6)
                assert float(np.abs(g - w).max()) <= 1e-5 * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_the_ranks_are_bitwise_equal(runs, arch):
    """Every rank ends each step with the same state: the global
    gradient, reduced once a layer, before any update."""
    r0, r1 = runs["ranks"]
    for key in ("train/params", "train/opt", "grads/grads",
                "train0/loss", "train1/loss", "grads/loss"):
        for a, b in zip(_get(r0, f"{arch}/{key}"), _get(r1, f"{arch}/{key}")):
            assert np.array_equal(a, b), key


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["l2l-p", "baseline"])
def test_a_world_of_one_is_bitwise_meshless(runs, arch, name):
    """An all-reduce over one rank is the identity and every division
    follows it: the same bits as the engine without a mesh."""
    one = runs["one"]
    pre = f"{arch}/mesh/{name}/"
    keys = sorted({k[len(pre):].rsplit("/", 1)[0] for k in one
                   if k.startswith(pre)})
    assert {"train/params", "grads/grads"} <= set(keys)
    if name == "l2l-p":
        assert {"prefill", "decode"} <= set(keys)
    for key in keys:
        if key.endswith("all_reduces"):
            continue
        for a, b in zip(_get(one, pre + key),
                        _get(one, f"{arch}/none/{name}/{key}")):
            assert np.array_equal(a, b), key
    if name == "l2l-p":
        # a layer row each, the static tree, the loss weight and loss
        n_layers = get_config(arch, "smoke").n_layers
        assert int(_get(one, pre + "train0/all_reduces")[0]) == n_layers + 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("knob", range(1, N_KNOBS))
def test_knob_points_are_bitwise_inside_the_mesh(runs, arch, knob):
    """prefetch 0 / 1, G 1 / 2, stash_every 1 / 2, pack on / off: one
    train step each on the two-rank mesh, the same bits as the first step
    of the base configuration (the first point)."""
    for out in runs["ranks"]:
        got = _get(out, f"{arch}/knob{knob}")
        base = _get(out, f"{arch}/knob0")
        assert len(got) == len(base)
        for a, b in zip(got, base):
            assert np.array_equal(a, b)


def test_a_mesh_needs_a_world_of_its_size(runs):
    """``make_debug_mesh(data=2, model=1)`` on the two ranks; the
    production mesh (16 x 16) on them fails, its message naming both
    sizes."""
    for out in runs["ranks"]:
        msg = str(_get(out, "production_mesh")[0])
        assert "256" in msg and "world has 2" in msg, msg


def test_moe_on_data_ranks_and_a_model_axis_are_refused(runs):
    """deepseek-v2-lite on data=2 (the router's statistics and the
    dispatch over the data group) and on model=2 (expert parallelism) is
    no longer refused (tests/test_torch_moe_parallel.py), nor is
    internvl2-1b on model=2 (tests/test_torch_modality_parallel.py);
    NotImplementedError for ``serve_session`` on data=2."""
    for out in runs["ranks"]:
        assert [int(x) for x in _get(out, "refused")] == [0, 0, 0, 1]



def test_the_train_cli_on_two_ranks(runs):
    """``torch.distributed.run`` of the train CLI with ``--mesh data=2``
    (started by the fixture beside the workers): the world and the
    all-reduces a step in its JSON line, the two ranks' final checksums
    equal, one snapshot written (by rank 0)."""
    import json
    rc, log, d = runs["cli"]
    assert rc == 0, log
    line = json.loads([ln for ln in log.splitlines()
                       if ln.startswith("{")][-1])
    assert line["world"] == 2 and line["backend"] == "gloo"
    assert line["all_reduces_per_step"] == 2 + 3
    sums = line["rank_checksums"]
    assert len(sums) == 2 and sums[0] == sums[1]
    assert sorted(os.listdir(d)) == ["ckpt_2"]
