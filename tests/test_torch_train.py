"""The training slice as a whole on the CPU: one L2L-p step and the
schedule's gradients of bert-large smoke under the slice's configuration
(weight streaming, packed relay, prefetch 1, the relay-copy transport,
the offloaded stash, the flash kernels — the JAX ones in interpret mode)
against the JAX engine, then the port against itself: its knob grid
bit for bit, Alg 3 against Alg 4, the baseline against L2L, the
non-finite sentinel, and the train CLI."""
import json
import os

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
from repro.models import common as jcommon  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.testing import fan_in_params, init_numpy  # noqa: E402,E501

SLICE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas", offload_stash=True, n_microbatches=2)
B, S = 4, 64


def _batch(vocab, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, -5:] = 0.0                      # a weighted loss, as padding
    return {"tokens": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "targets": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "mask": mask}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draw_params(like, seed=0):
    """numpy parameters shaped like the reference's, at the usual scales
    (``repro_torch.testing.fan_in_params``), drawn in f64 by a seeded
    RandomState and stored in f32.  (The reference's own init gives every
    stacked matrix std 1/sqrt(n_layers) — 0.71 at the smoke depth, where
    the backward amplifies f32 rounding; ``test_grads_at_reference_init``
    compares at that init too.)"""
    rs = np.random.RandomState(seed)
    drawn = fan_in_params(like, lambda shape: rs.randn(*shape))
    return jax.tree.map(lambda a: a.astype(np.float32), drawn)


def _jax_engine(arch):
    cfg = jget_config(arch, "smoke").replace(dtype="float32", use_pallas=True)
    return jengines.create("l2l-p", cfg, JExec(**SLICE), donate=False)


def _jax_step(eng, state, jb):
    """One step of the JAX engine -> (state, metrics, unpacked opt,
    grads).  Adam's first step leaves m = (1 - b1)·g = 0.1·g, so the
    gradients are read back from m (one compiled program, not two).  Its
    RMSNorm is ``rmsnorm_diff`` (the Pallas forward in interpret mode), the
    counterpart of the port's."""
    prev = jcommon.use_pallas_rmsnorm(True)
    try:
        new, metrics = eng.train_step(state, jb)
    finally:
        jcommon.use_pallas_rmsnorm(prev)
    opt = jpacking.unpack_opt_state(new.legacy_opt(), new.params)
    opt = {k: _np(opt[k]) for k in ("embed", "head", "groups")}
    is_slot = lambda x: isinstance(x, dict) and set(x) == {"m", "v"}
    grads = jax.tree.map(lambda s: s["m"] / np.float32(0.1), opt,
                         is_leaf=is_slot)
    return new, metrics, opt, grads


def _drawn_reference(arch):
    """The JAX engine's l2l-p step from numpy parameters at the usual
    scales (``_draw_params``), with what the parity tests read."""
    from repro.engine.state import TrainState as JState
    eng = _jax_engine(arch)
    batch = _batch(eng.model.cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _draw_params(eng.model.param_specs())
    packed = eng._relay_params(jax.tree.map(jnp.asarray, params))
    state = JState.from_legacy(packed, eng._init_opt_legacy(packed))
    opt = jpacking.unpack_opt_state(state.legacy_opt(), state.params)
    new, metrics, new_opt, grads = _jax_step(eng, state, jb)
    return dict(arch=arch, eng=eng, jb=jb,
                params=params, opt={k: _np(opt[k]) for k in
                                    ("embed", "head", "groups")},
                batch=batch, new_params=_np(jpacking.unpack_params(
                    new.params)),
                new_opt=new_opt, loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]), grads=grads)


@pytest.fixture(scope="module")
def reference():
    """bert-large's: the step from numpy parameters, and from parameters
    at the reference's init scales (the port's init, seed 0)."""
    ref = _drawn_reference("bert-large")
    from repro.engine.state import TrainState as JState
    eng = ref["eng"]
    own_params = init_numpy(eng.model.cfg, 0)
    packed = eng._relay_params(jax.tree.map(jnp.asarray, own_params))
    own = JState.from_legacy(packed, eng._init_opt_legacy(packed))
    _, own_metrics, _, own_grads = _jax_step(eng, own, ref["jb"])
    return dict(ref, own_params=own_params,
                own_loss=float(own_metrics["loss"]), own_grads=own_grads)


# bert-large (slice 2) and the dense configs the port's blocks cover:
# RMSNorm through rmsnorm_diff, qkv biases, a half-width rope, GQA,
# a parallel block with tied embeddings
ARCHS = ["bert-large", "chatglm3-6b", "command-r-35b", "qwen1.5-110b"]


@pytest.fixture(scope="module", params=ARCHS)
def step_reference(request, reference):
    if request.param == "bert-large":
        return reference
    return _drawn_reference(request.param)


def _cfg(arch="bert-large", **kw):
    return get_config(arch, "smoke").replace(dtype="float32",
                                             use_pallas=True, **kw)


def _engine(name="l2l-p", cfg=None, **exec_kw):
    return engines.create(name, cfg or _cfg(), ExecutionConfig(**exec_kw),
                          device="cpu")


def _state(ref, pack=False):
    return bridge.train_state_from_numpy(ref["params"], ref["opt"], 0,
                                         pack=pack)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(a, b):
    """max |a - b| over max |b| across a tree (tests/test_equivalence)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    num = max(float(np.abs(x - y).max()) for x, y in zip(la, lb))
    return num / max(max(float(np.abs(y).max()) for y in lb), 1e-12)


def test_l2lp_step_matches_jax(step_reference):
    ref = step_reference
    eng = _engine(cfg=_cfg(ref["arch"]), **SLICE)
    new, metrics = eng.train_step(_state(ref), _tbatch(ref["batch"]))
    params, opt, step, _ = bridge.train_state_to_numpy(new)
    assert step == 1
    # f32 on both sides, the same algorithm; sums in other orders: 1e-5
    assert abs(float(metrics["loss"]) - ref["loss"]) <= 1e-5 * ref["loss"]
    assert abs(float(metrics["grad_norm"]) - ref["grad_norm"]) \
        <= 1e-5 * ref["grad_norm"]
    # Adam slots: m = 0.1 g, v = 0.001 g^2 after one step, so they carry
    # the gradients' agreement: 1e-5 relative L2 per leaf
    for slot in ("m", "v"):
        for part in ("embed", "head", "groups"):
            want = jax.tree.leaves(ref["new_opt"][part])
            got = jax.tree.leaves(opt[part])
            names = [p for p in jax.tree_util.tree_leaves_with_path(
                ref["new_opt"][part])]
            for (path, _), w, g in zip(names, want, got):
                if jax.tree_util.keystr(path).endswith(f"['{slot}']"):
                    assert _rel_l2(g, w) <= 1e-5, (part, path)
    # updated params, where the gradient is not negligible: Adam's first
    # step moves every element by ~lr·sign(g), so an element whose |g| is
    # near 0 may move either way on either side; above |g| = 1e-4 the
    # step no longer depends on the gradient's last digits
    grads = ref["grads"]
    for part in ("embed", "head", "groups"):
        for w, g, gr in zip(jax.tree.leaves(ref["new_params"][part]),
                            jax.tree.leaves(params[part]),
                            jax.tree.leaves(grads[part])):
            keep = np.abs(gr) > 1e-4
            np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5,
                                       atol=1e-6)


def test_grads_match_jax(reference):
    ref = reference
    loss, grads = _engine(**SLICE).grads(
        bridge.params_from_numpy(ref["params"]), _tbatch(ref["batch"]))
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * ref["loss"]
    # the bound tests/test_equivalence.py holds the engines to, per part
    got = bridge.params_to_numpy(grads)
    for part in ("embed", "head", "groups"):
        assert _rel_max(got[part], ref["grads"][part]) < 1e-5, part


def test_grads_at_reference_init(reference):
    """At the reference's init scales (every stacked matrix at std
    1/sqrt(n_layers); drawn by the port's init) the backward amplifies f32
    rounding:
    measured on the CPU, each package's f32 gradients stand 1e-4 to 3e-4
    (relative L2 per leaf) from the port's gradients with f64 activations
    (its norms and loss reductions stay f32), JAX's as far as the port's.
    So here the two are held to 1e-3 per leaf and the loss to 1e-5; with
    parameters at the usual scales they agree to ~1e-6 (above)."""
    ref = reference
    loss, grads = _engine(**SLICE).grads(
        bridge.params_from_numpy(ref["own_params"]), _tbatch(ref["batch"]))
    assert abs(float(loss) - ref["own_loss"]) <= 1e-5 * ref["own_loss"]
    got = jax.tree.leaves(bridge.params_to_numpy(grads))
    for g, w in zip(got, jax.tree.leaves(ref["own_grads"])):
        assert _rel_l2(g, w) <= 1e-3


def _run(eng, ref_state, batch):
    new, metrics = eng.train_step(ref_state, batch)
    params, opt, _, _ = bridge.train_state_to_numpy(new)
    return float(metrics["loss"]), jax.tree.leaves(params), \
        jax.tree.leaves(opt)


# the relay knobs, at a depth G=2 and K=2 do not divide; every point must
# equal the plain schedule bit for bit (deterministic, the same ops per
# layer), Alg 3 (l2l) included
_GRID = [dict(pack_params=pk, prefetch_depth=k, layers_per_relay=g,
              stash_every=se, transport=t)
         for pk, k, g, se, t in [(True, 1, 1, 1, "pallas"),
                                 (False, 1, 2, 1, "xla"),
                                 (True, 0, 2, 2, "pallas"),
                                 (False, 2, 1, 2, "pallas"),
                                 (True, 1, 1, 3, "xla")]]


@pytest.fixture(scope="module")
def grid_base(reference):
    cfg = _cfg(n_layers=3)
    eng = _engine("l2l-p", cfg, n_microbatches=2)
    st = eng.init(torch.Generator().manual_seed(5))
    st = st.replace(params=eng.model.init_params(
        torch.Generator().manual_seed(5)))
    batch = _tbatch(reference["batch"])
    return cfg, st, batch, _run(eng, st, batch)


@pytest.mark.parametrize("engine,kw", [("l2l-p", g) for g in _GRID]
                         + [("l2l", dict(pack_params=True, prefetch_depth=1,
                                         stash_every=2)),
                            ("l2l", dict(**SLICE))])
def test_knob_grid_is_bitwise(grid_base, engine, kw):
    cfg, st, batch, want = grid_base
    kw = {"n_microbatches": 2, **kw}
    got = _run(_engine(engine, cfg, **kw), st, batch)
    assert got[0] == want[0]
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))


def test_baseline_matches_l2l(reference):
    """Alg 2 (the whole model at once, gradients accumulated over the
    microbatches) against Alg 4: the bound of tests/test_equivalence.py."""
    ref = reference
    batch = _tbatch(ref["batch"])
    outs = {}
    for name in ("baseline", "l2l-p"):
        new, m = _engine(name, n_microbatches=2).train_step(_state(ref),
                                                            batch)
        outs[name] = (bridge.train_state_to_numpy(new)[0], float(m["loss"]))
    assert _rel_max(outs["baseline"][0], outs["l2l-p"][0]) < 1e-5
    assert abs(outs["baseline"][1] - outs["l2l-p"][1]) < 1e-5
    # the gradients alone, and Alg 1 (one microbatch) against Alg 2
    l_b, g_b = _engine("baseline", n_microbatches=2).grads(
        bridge.params_from_numpy(ref["params"]), batch)
    l_1, g_1 = _engine("baseline").grads(
        bridge.params_from_numpy(ref["params"]), batch)
    assert abs(float(l_b) - float(l_1)) < 1e-5
    assert _rel_max(bridge.params_to_numpy(g_b),
                    bridge.params_to_numpy(g_1)) < 1e-5
    assert _rel_max(bridge.params_to_numpy(g_b), ref["grads"]) < 1e-5


@pytest.mark.parametrize("name,pack", [("l2l-p", True), ("l2l", False),
                                       ("baseline", False)])
def test_skip_nonfinite_returns_the_prior_state(reference, name, pack):
    ref = reference
    params = jax.tree.map(np.copy, ref["params"])
    params["head"]["out"][0, 0] = np.nan
    state = bridge.train_state_from_numpy(params, ref["opt"], 3, pack=pack)
    want = bridge.train_state_to_numpy(state)
    eng = _engine(name, skip_nonfinite=True, n_microbatches=2,
                  pack_params=pack)
    new, metrics = eng.train_step(state, _tbatch(ref["batch"]))
    got = bridge.train_state_to_numpy(new)
    assert metrics["skipped_steps"] == 1 and got[2] == 3
    for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(want[:2])):
        assert a.tobytes() == b.tobytes()


def test_sgd_packed_step_is_bitwise_to_unpacked(reference):
    """A stateless optimizer on the packed relay (empty slots; the update
    unpacks and repacks)."""
    ref = reference
    outs = []
    for pack in (False, True):
        eng = engines.create("l2l-p", _cfg(), ExecutionConfig(
            n_microbatches=2, pack_params=pack), optimizer=sgd(lr=0.1),
            device="cpu")
        st = eng.init(torch.Generator().manual_seed(2))
        outs.append(_run(eng, st, _tbatch(ref["batch"])))
    assert outs[0][0] == outs[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_train_cli_on_cpu(capsys, tmp_path):
    argv = ["--device", "cpu", "--variant", "smoke", "--steps", "3",
            "--batch", "4", "--seq", "32", "--ub", "2", "--weight-stream",
            "--pack", "--prefetch", "1", "--transport", "pallas",
            "--offload-stash", "--log-every", "1"]
    losses = train_cli.main(argv)
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert '"final_step": 3' in out and '"tier_metrics": null' in out
    # the disk tier: layer 1 of 2 past a budget of one layer's weights
    # and Adam slots (~1.6 MB) rests in segment files between steps; the
    # losses are the two-tier run's bit for bit
    tiered = train_cli.main(argv + ["--tiers", "3", "--host-budget",
                                    str(2 << 20), "--tier-dir",
                                    str(tmp_path / "tier")])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert tiered == losses
    m = line["tier_metrics"]
    assert m["demoted_layers"] == 1 and m["reads"] > 0 and m["writes"] > 0
    assert os.path.isdir(str(tmp_path / "tier" / "g0_w"))
    # --resume auto needs a --ckpt-dir (tests/test_torch_checkpoint.py runs
    # the checkpoints; the host optimizer and dynamic depth run in their
    # own test files)
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--resume", "auto"])
