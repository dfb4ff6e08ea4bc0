"""Checkpoints of the port (``repro_torch/checkpoint/io.py``,
``Engine.save`` / ``restore``, the train CLI's ``--ckpt-dir`` /
``--resume`` and its SIGTERM path).

On the CPU: snapshots interchange with the JAX package both ways — its
engine writes and the port's restores, the port's writes and
``repro.checkpoint.io.verify`` and the JAX engine's ``restore`` read —
packed and unpacked, with f32 and bf16 masters and a loss scale, byte for
byte, and a two-group packed deepseek-v2-lite state (MLA, experts); corruption (``repro_torch.testing.faults.corrupt_snapshot``) falls back to
the previous good snapshot; a fingerprint mismatch is refused; ``prune``
sweeps staging debris; one SIGTERM kill of ``python -m
repro_torch.launch.train --device cpu`` resumes to the final snapshot of
an uninterrupted run.

On the card (marker ``card``; no JAX needed): a save from pinned rows and
a restore into a fresh engine continue training bit for bit.
"""
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.testing import init_numpy  # noqa: E402

ARCH = "bert-large"


def _cfg(param_dtype="float32", arch=ARCH):
    return get_config(arch, "smoke").replace(param_dtype=param_dtype)


def _exec(pack):
    return dict(n_microbatches=2, pack_params=pack, loss_scale_init=512.0)


def _random_state(params, seed):
    """numpy (params, opt) in the unpacked layout: the given params,
    random Adam slots, a step and a loss scale."""
    rs = np.random.RandomState(seed)

    def slots(tree):
        if isinstance(tree, dict):
            return {k: slots(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(slots(v) for v in tree)
        return {"m": rs.randn(*tree.shape).astype(np.float32),
                "v": rs.rand(*tree.shape).astype(np.float32)}
    opt = {k: slots(params[k]) for k in ("embed", "head", "groups")}
    return opt, 7 + seed, {"good_steps": np.int32(3 + seed),
                           "scale": np.float32(512.0 * (seed + 1))}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_bytes(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        x, y = _bits(x), _bits(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.ascontiguousarray(x).tobytes() == \
            np.ascontiguousarray(y).tobytes()


@pytest.fixture(scope="module")
def jax_side():
    """The JAX engine per (pack, param dtype), and params at its init scales as
    numpy (unpacked)."""
    jax = pytest.importorskip("jax")
    from repro import engine as jengines
    from repro.configs.base import get_config as jget_config
    from repro.core.schedule import ExecutionConfig as JExec
    engs = {}

    def get(pack, pdt, arch=ARCH):
        if (pack, pdt, arch) not in engs:
            cfg = jget_config(arch, "smoke").replace(param_dtype=pdt)
            eng = jengines.create("l2l-p", cfg, JExec(**_exec(pack)),
                                  donate=False)
            engs[pack, pdt, arch] = (eng, init_numpy(cfg, 1, pdt))
        return engs[pack, pdt, arch]
    return get


def _jax_state(eng, params, opt, step, loss_scale):
    import jax
    import jax.numpy as jnp
    from repro.core import packing as jpacking
    from repro.engine.state import TrainState as JState
    p = jax.tree.map(jnp.asarray, params)
    o = {**jax.tree.map(jnp.asarray, opt), "step": jnp.int32(step),
         "loss_scale": jax.tree.map(jnp.asarray, loss_scale)}
    if eng.exec_cfg.pack_params:
        p = jpacking.pack_params(p)
        o = jpacking.pack_opt_state(o, p)
    return JState.from_legacy(p, o)


def _jax_unpacked(eng, state):
    import jax
    from repro.core import packing as jpacking
    p, o = state.params, state.legacy_opt()
    if eng.exec_cfg.pack_params:
        o = jpacking.unpack_opt_state(o, p)
        p = jpacking.unpack_params(p)
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o)


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pack", [False, True])
def test_snapshots_interchange_with_the_reference(tmp_path, jax_side, pack,
                                                  pdt):
    """JAX writes, the port restores; the port writes, the reference
    verifies and restores: every array byte for byte, the step and the
    loss scale included."""
    _interchange(tmp_path, jax_side, pack, pdt, ARCH)


def test_two_group_snapshots_interchange_with_the_reference(tmp_path,
                                                            jax_side):
    """The same both ways for deepseek-v2-lite smoke, packed: two layer
    groups (the dense layer 0, the MoE layers with 4-D expert leaves)."""
    _interchange(tmp_path, jax_side, True, "float32",
                 "deepseek-v2-lite-16b")


def _interchange(tmp_path, jax_side, pack, pdt, arch):
    from repro.checkpoint import io as jckpt
    jeng, params = jax_side(pack, pdt, arch)
    assert len(params["groups"]) == (2 if arch != ARCH else 1)
    eng = engines.create("l2l-p", _cfg(pdt, arch),
                         ExecutionConfig(**_exec(pack)), device="cpu")
    assert eng.state_fingerprint() == jeng.state_fingerprint()

    # JAX -> port
    opt, step, ls = _random_state(params, 0)
    d1 = str(tmp_path / "from_jax")
    jeng.save(d1, _jax_state(jeng, params, opt, step, ls))
    state, got_step = eng.restore(d1)
    assert got_step == step == state.step
    p, o, st, gls = bridge.train_state_to_numpy(state)
    _same_bytes(p, params)
    _same_bytes(o, opt)
    _same_bytes(gls, ls)

    # port -> JAX
    opt2, step2, ls2 = _random_state(params, 1)
    d2 = str(tmp_path / "from_port")
    eng.save(d2, bridge.train_state_from_numpy(params, opt2, step2, ls2,
                                               pack=pack))
    path = ckpt.snapshot_path(d2, step2)
    assert jckpt.verify(path, fingerprint=jeng.state_fingerprint())
    assert ckpt.read_manifest(path)["dtypes"] == \
        jckpt.read_manifest(ckpt.snapshot_path(d1, step))["dtypes"]
    jstate, jstep = jeng.restore(d2)
    assert jstep == step2 and int(jstate.step) == step2
    jp, jo = _jax_unpacked(jeng, jstate)
    _same_bytes(jp, params)
    _same_bytes({k: jo[k] for k in ("embed", "head", "groups")}, opt2)
    _same_bytes(jo["loss_scale"], ls2)


def test_bf16_leaf_and_scalars_round_trip_through_both_modules(tmp_path):
    """A bf16 leaf is stored as uint16 bits under the dtype "bfloat16";
    either module restores what the other wrote, bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.checkpoint import io as jckpt
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(3, 5).astype(np.float32)).bfloat16()
    tree = {"w": x, "loss_scale": {"good_steps": np.int32(4),
                                   "scale": np.float32(2.0 ** 15)},
            "t": (torch.arange(4, dtype=torch.int32),)}
    ckpt.save(str(tmp_path / "p"), tree, step=1)
    man = ckpt.read_manifest(str(tmp_path / "p"))
    assert man["keys"] == ["loss_scale/good_steps", "loss_scale/scale",
                           "t/0", "w"]
    assert man["dtypes"][-1] == "bfloat16"
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
        np.shape(a), jnp.bfloat16 if isinstance(a, torch.Tensor) and
        a.dtype == torch.bfloat16 else np.asarray(a).dtype), tree)
    back = jckpt.restore(str(tmp_path / "p"), like)
    assert back["w"].dtype == jnp.bfloat16
    assert np.asarray(back["w"]).view(np.uint16).tobytes() == \
        x.view(torch.int16).numpy().tobytes()
    jckpt.save(str(tmp_path / "j"), back, step=1)
    like_t = {"w": x, "loss_scale": {"good_steps": torch.zeros(
        (), dtype=torch.int32), "scale": torch.zeros(())}, "t": tree["t"]}
    again = ckpt.restore(str(tmp_path / "j"), like_t)
    assert again["w"].dtype == torch.bfloat16 and torch.equal(again["w"], x)
    assert int(again["loss_scale"]["good_steps"]) == 4
    assert float(again["loss_scale"]["scale"]) == 2.0 ** 15


def _saved_engine(tmp_path, steps=(2, 4)):
    eng = engines.create("l2l-p", _cfg(), ExecutionConfig(**_exec(True)),
                         device="cpu")
    state = eng.init(torch.Generator().manual_seed(0))
    d = str(tmp_path / "ck")
    for s in steps:
        eng.save(d, state, step=s)
    return eng, state, d


@pytest.mark.parametrize("mode,target", [("bitflip", "arrays"),
                                         ("truncate", "arrays"),
                                         ("bitflip", "manifest"),
                                         ("truncate", "manifest")])
def test_corrupt_newest_snapshot_falls_back(tmp_path, mode, target):
    from repro_torch.testing import faults
    eng, state, d = _saved_engine(tmp_path)
    faults.corrupt_snapshot(ckpt.snapshot_path(d, 4), mode=mode,
                            target=target, seed=3)
    assert not ckpt.verify(ckpt.snapshot_path(d, 4))
    assert ckpt.latest_step(d) == 4 and ckpt.latest_good(d) == 2
    restored, step = eng.restore(d)
    assert step == 2
    _same_bytes(bridge.train_state_to_numpy(restored)[0],
                bridge.train_state_to_numpy(state)[0])


@pytest.mark.parametrize("injector,seed", [("bitflip", 0), ("bitflip", 7),
                                           ("truncate", 3), ("poison", 0),
                                           ("poison", 11), ("checksums", 0)])
def test_seeded_injectors_match_the_reference(tmp_path, injector, seed):
    """The port's fault injectors do, byte for byte, what the reference's
    do from the same seed: the same flipped bit or cut length, the same
    planted NaN, the same per-array crc32 list of a snapshot."""
    pytest.importorskip("jax")
    from repro.testing import faults as jfaults
    from repro_torch.testing import faults
    if injector in ("bitflip", "truncate"):
        data = np.random.RandomState(seed).bytes(4096)
        paths = [str(tmp_path / n) for n in ("port", "ref")]
        for path in paths:
            with open(path, "wb") as f:
                f.write(data)
        faults.corrupt_file(paths[0], mode=injector, seed=seed)
        jfaults.corrupt_file(paths[1], mode=injector, seed=seed)
        got, want = (open(path, "rb").read() for path in paths)
        assert got == want != data
    elif injector == "poison":
        rs = np.random.RandomState(seed)
        batch = {"tokens": rs.randint(0, 9, (4, 8)).astype(np.int32),
                 "mask": rs.rand(4, 8).astype(np.float32)}
        got = faults.poison_batch(batch, seed=seed)
        want = jfaults.poison_batch(batch, seed=seed)
        assert np.isnan(got["mask"]).sum() == 1
        for k in batch:
            assert got[k].tobytes() == want[k].tobytes()
        assert not np.isnan(batch["mask"]).any()
    else:
        _, _, d = _saved_engine(tmp_path, steps=(2, 4))
        for step in (None, 2):
            assert faults.snapshot_checksums(d, step=step) == \
                jfaults.snapshot_checksums(d, step=step)


def test_fingerprint_mismatch_is_refused(tmp_path):
    eng, _, d = _saved_engine(tmp_path, steps=(2,))
    other = engines.create("l2l-p", _cfg().replace(n_layers=3),
                           ExecutionConfig(**_exec(True)), device="cpu")
    assert other.state_fingerprint() != eng.state_fingerprint()
    assert not ckpt.verify(ckpt.snapshot_path(d, 2),
                           fingerprint=other.state_fingerprint())
    assert ckpt.latest_good(d, fingerprint=other.state_fingerprint()) is None
    with pytest.raises(AssertionError, match="no verifiable checkpoint"):
        other.restore(d)


def test_prune_keeps_the_newest_and_sweeps_debris(tmp_path):
    d = str(tmp_path)
    for s in range(1, 5):
        ckpt.save_train_state(d, {"a": torch.full((4,), float(s))},
                              {"m": np.zeros(2, np.float32)}, step=s,
                              keep_last=2)
    assert ckpt._snapshot_steps(d, "ckpt") == [3, 4]
    os.makedirs(os.path.join(d, ".tmp-ckpt_9.12345"))
    assert ckpt.prune(d, keep_last=0) == []
    assert not [f for f in os.listdir(d) if f.startswith(".tmp-")]
    assert ckpt._snapshot_steps(d, "ckpt") == [3, 4]


# ---- the CLI: one SIGTERM kill and resume ------------------------------
# the reference's chaos-suite size (tests/test_faults.py's TINY)
TINY = ["--arch", "bert-large", "--variant", "smoke",
        "--d-model", "32", "--n-layers", "2",
        "--batch", "4", "--seq", "16", "--ub", "2",
        "--steps", "6", "--log-every", "1", "--seed", "3",
        "--engine", "l2l-p", "--pack", "--device", "cpu"]


def _launch(argv):
    """``python -m repro_torch.launch.train`` as a subprocess, its output
    line by line (``repro_torch.testing.faults.launch_train``), with one
    intra-op thread, as tests/torch_threads.py gives the test process:
    beside the suite's busy workers an OpenMP team of one thread a core
    waits on the others."""
    from repro_torch.testing import faults
    return faults.launch_train(argv, env={"OMP_NUM_THREADS": "1"})


def _run(argv):
    from repro_torch.testing import faults
    return faults.run_train(argv, timeout=300,
                            env={"OMP_NUM_THREADS": "1"})


def test_sigterm_resume_matches_an_uninterrupted_run(tmp_path):
    """SIGTERM at step 2: the CLI finishes the step, saves, writes
    PREEMPTED.json and exits 0; ``--resume auto`` replays the rest to a
    final snapshot whose per-array crc32s equal an uninterrupted run's."""
    from repro_torch.testing import faults
    ref = str(tmp_path / "ref")
    # the uninterrupted run beside the one that is killed
    unbroken = _launch(TINY + ["--ckpt-dir", ref])
    d = str(tmp_path / "killed")
    proc = _launch(TINY + ["--ckpt-dir", d, "--ckpt-every", "2",
                           "--step-delay-ms", "300", "--resume", "auto"])
    rc, out = faults.kill_at_step(proc, 2, sig=signal.SIGTERM, timeout=300)
    ref_out, _ = unbroken.communicate(timeout=300)
    assert unbroken.returncode == 0, ref_out
    assert json.loads(ref_out.strip().splitlines()[-1])["resumed_from"] \
        is None
    want = faults.snapshot_checksums(ref, step=6)
    assert rc == 0, f"graceful preemption should exit 0:\n{out}"
    marker = os.path.join(d, "PREEMPTED.json")
    with open(marker) as f:
        info = json.load(f)
    assert 0 < info["step"] < 6 and info["signal"] == signal.SIGTERM
    assert ckpt.latest_good(d) == info["step"]

    out = _run(TINY + ["--ckpt-dir", d, "--ckpt-every", "2",
                       "--resume", "auto"])
    assert f"resumed from {d} at step {info['step']}" in out
    assert json.loads(out.strip().splitlines()[-1])["resumed_from"] == \
        info["step"]
    assert not os.path.exists(marker)
    assert faults.snapshot_checksums(d, step=6) == want


def test_resume_from_a_directory_without_snapshots_errors(tmp_path):
    from repro_torch.launch import train as train_cli
    with pytest.raises(SystemExit, match="no verifiable checkpoint"):
        train_cli.main(TINY + ["--steps", "1",
                               "--resume", str(tmp_path / "nowhere")])


# ---- on the card ------------------------------------------------------
@pytest.mark.card
def test_save_from_pinned_rows_and_restore_on_card(tmp_path):
    """bert-large smoke under l2l-p with its weights and Adam slots in
    pinned rows: a step, a save (read from the pinned rows after the
    card is waited for), a restore into a fresh engine, then one more step
    on each: losses, params and slots equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _cfg().replace(use_pallas=True)
    kw = dict(n_microbatches=2, weight_stream=True, pack_params=True,
              prefetch_depth=1, transport="pallas", offload_stash=True)
    g = torch.Generator("cuda").manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                                     device="cuda"),
             "targets": torch.randint(0, cfg.vocab_size, (4, 64),
                                      generator=g, device="cuda"),
             "mask": torch.ones(4, 64, device="cuda")}
    eng = engines.create("l2l-p", cfg, ExecutionConfig(**kw))
    state, _ = eng.train_step(eng.init(torch.Generator("cuda").manual_seed(0)),
                              batch)
    assert state.params["groups"][0].segs["float32"].is_pinned()
    eng.save(str(tmp_path), state)
    fresh = engines.create("l2l-p", cfg, ExecutionConfig(**kw))
    back, step = fresh.restore(str(tmp_path))
    assert step == 1 and back.params["groups"][0].segs["float32"].is_pinned()
    a, ma = eng.train_step(state, batch)
    b, mb = fresh.train_step(back, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(bridge.train_state_to_numpy(a)[:2],
                    bridge.train_state_to_numpy(b)[:2]):
        for u, v in zip(tree_leaves(x), tree_leaves(y)):
            assert np.array_equal(u, v)
