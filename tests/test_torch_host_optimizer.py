"""The optimizer on the host in the port (``ExecutionConfig.host_optimizer``,
``core.host_opt``): a worker thread applies each layer's update to its
rows while the backward goes on (Alg 4), or a host loop after it (Alg 3).

The reference's case (bert-large smoke, f32, ``adam(lr=1e-3)``, two
microbatches, one step: host against device within 1e-6 and an equal
loss), the port's host step against the JAX engine's, the knob grid bit
for bit (a gradient ring of one row among it, under a short switch
interval), AMP's per-layer skip of an injected non-finite layer,
``skip_nonfinite``, a checkpoint round trip and the train CLI.

On the card (marker ``card``; ``python -m pytest -m card --noconftest
tests/test_torch_host_optimizer.py``, which needs no JAX): bert-large at
full width, 2 layers, pinned rows, the host optimizer against the
device optimizer (K1).  JAX is imported inside the tests only."""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.testing import fan_in_params  # noqa: E402

B, S = 4, 16


def _batch(vocab, seed=0):
    rs = np.random.RandomState(seed)
    return {"tokens": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "targets": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cfg(**kw):
    return get_config("bert-large", "smoke").replace(dtype="float32", **kw)


def _engine(name="l2l-p", cfg=None, lr=1e-3, **kw):
    return engines.create(name, cfg or _cfg(), ExecutionConfig(
        n_microbatches=2, **kw), optimizer=adam(lr=lr), device="cpu")


def _np_state(state):
    p, o, step, ls = bridge.train_state_to_numpy(state)
    return tree_leaves((p, o)), step


def _max_abs(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def reference():
    """numpy parameters of bert-large smoke at the usual scales, zero Adam
    slots, and the JAX engine's host-optimizer step from them."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.configs.base import get_config as jget_config
    from repro.core.schedule import ExecutionConfig as JExec
    from repro.engine.state import TrainState as JState
    from repro.optim import adam as jadam
    jcfg = jget_config("bert-large", "smoke").replace(dtype="float32")
    jeng = jengines.create("l2l-p", jcfg, JExec(n_microbatches=2,
                                                host_optimizer=True),
                           optimizer=jadam(1e-3), donate=False)
    # the draws need the parameters' shapes only
    shapes = jeng.model.abstract_params()
    rs = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        fan_in_params(shapes,
                      lambda shape: rs.randn(*shape)))
    opt = jax.tree.map(np.asarray, {
        k: v for k, v in jeng._init_opt_legacy(params).items()
        if k in ("embed", "head", "groups")})
    batch = _batch(jcfg.vocab_size)
    state = JState.from_legacy(jax.tree.map(jnp.asarray, params),
                               jeng._init_opt_legacy(params))
    new, metrics = jeng.train_step(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    # Adam's first step leaves m = 0.1 g: the gradients, read back
    is_slot = lambda x: isinstance(x, dict) and set(x) == {"m", "v"}
    grads = jax.tree.map(lambda s: np.asarray(s["m"]) / np.float32(0.1),
                         {k: new.legacy_opt()[k]
                          for k in ("embed", "head", "groups")},
                         is_leaf=is_slot)
    return dict(params=params, opt=opt, batch=batch,
                loss=float(metrics["loss"]), grads=grads,
                new_params=jax.tree.map(np.asarray, new.params))


def _state(ref, pack=False):
    return bridge.train_state_from_numpy(ref["params"], ref["opt"], 0,
                                         pack=pack)


def test_host_matches_device_and_jax(reference):
    """The reference's bar (tests/test_system.py): max abs <= 1e-6 and an
    equal loss, host against device; on the CPU both run the same ops,
    so they are bitwise.  Against the JAX host step: the loss to 1e-5
    and the updated params where the gradient is not negligible (Adam's
    first step moves each element by ~lr·sign(g), so an element whose
    |g| is near 0 may move either way; tests/test_torch_train.py's
    bound)."""
    ref = reference
    outs = {}
    for host in (False, True):
        new, m = _engine(host_optimizer=host).train_step(
            _state(ref), _tbatch(ref["batch"]))
        outs[host] = (float(m["loss"]), _np_state(new)[0], new, m)
    assert outs[True][0] == outs[False][0]
    assert _max_abs(outs[True][1], outs[False][1]) <= 1e-6
    assert all(np.array_equal(a, b)
               for a, b in zip(outs[True][1], outs[False][1]))
    m = outs[True][3]
    assert len(m["host_update_ms"]) == _cfg().n_layers and m["host_wait_s"] >= 0
    assert abs(outs[True][0] - ref["loss"]) <= 1e-5 * ref["loss"]
    got = bridge.params_to_numpy(outs[True][2].params)
    for part in ("embed", "head", "groups"):
        for w, g, gr in zip(tree_leaves(ref["new_params"][part]),
                            tree_leaves(got[part]),
                            tree_leaves(ref["grads"][part])):
            keep = np.abs(gr) > 1e-4
            np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5,
                                       atol=1e-6)


# Alg 4 and Alg 3 across pack, K, G, prefetch and transport, and the
# gradient ring down to one row: every point bitwise equal to the
# device optimizer's plain schedule
_GRID = [("l2l-p", dict(pack_params=True, prefetch_depth=1)),
         ("l2l-p", dict(stash_every=2, layers_per_relay=2,
                        transport="pallas")),
         ("l2l-p", dict(pack_params=True, stash_every=2, prefetch_depth=2,
                        transport="pallas", ring=1)),
         ("l2l", dict()),
         ("l2l", dict(pack_params=True, layers_per_relay=2, stash_every=2,
                      prefetch_depth=1, transport="pallas"))]


@pytest.fixture(scope="module")
def grid_base(reference):
    eng = _engine(cfg=_cfg(n_layers=3))
    st = eng.init(torch.Generator().manual_seed(5))
    batch = _tbatch(reference["batch"])
    new, m = eng.train_step(st, batch)
    return st, batch, float(m["loss"]), _np_state(new)[0]


@pytest.mark.parametrize("name,kw", _GRID)
def test_knob_grid_is_bitwise(grid_base, name, kw):
    st, batch, loss, want = grid_base
    kw = dict(kw)
    ring = kw.pop("ring", None)
    eng = _engine(name, cfg=_cfg(n_layers=3), host_optimizer=True, **kw)
    old = sys.getswitchinterval()
    if ring:
        # one gradient row: every layer waits for the worker to read the
        # one before; a short switch interval interleaves the two threads
        eng.grad_ring = ring
        sys.setswitchinterval(1e-6)
    try:
        new, m = eng.train_step(st, batch)
    finally:
        sys.setswitchinterval(old)
    assert float(m["loss"]) == loss
    assert all(np.array_equal(a, b) for a, b in zip(_np_state(new)[0], want))


class _Poison(torch.autograd.Function):
    """Zero forward, NaN gradient: a layer whose weight gradient is not
    finite while its input's gradient is."""

    @staticmethod
    def forward(ctx, w):
        ctx.shape = w.shape
        return w.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        return torch.full(ctx.shape, float("nan"))


def _poison_layer(eng, marker):
    """Layer whose ``attn/bo[0]`` equals ``marker`` gets a NaN gradient."""
    group = eng.model.groups[0]
    apply = group.apply

    def poisoned(w, x, mem, ctx):
        y, aux = apply(w, x, mem, ctx)
        bo = w["attn"]["bo"]
        if float(bo.detach().reshape(-1)[0]) == marker:
            y = y + _Poison.apply(bo)
        return y, aux
    eng.model.groups = (group._replace(apply=poisoned),)


@pytest.mark.parametrize("pack", [False, True])
def test_amp_skips_only_the_nonfinite_layer(reference, pack):
    """Under AMP a layer whose gradient is not finite keeps its rows (the
    flag travels with its gradient row); the others update as on the
    device path, bit for bit."""
    ref = reference
    params = tree_map(np.copy, ref["params"])
    marker = np.float32(0.123)
    params["groups"][0]["attn"]["bo"][1, 0] = marker
    batch = _tbatch(ref["batch"])
    outs = []
    for host in (False, True):
        eng = _engine(host_optimizer=host, pack_params=pack,
                      loss_scale_init=64.0)
        _poison_layer(eng, float(marker))
        state = bridge.train_state_from_numpy(
            params, ref["opt"], 0, loss_scale={
                "scale": np.float32(64.0), "good_steps": np.int32(0)},
            pack=pack)
        new, m = eng.train_step(state, batch)
        assert int(m["nonfinite_layers"]) == 1
        outs.append(bridge.train_state_to_numpy(new))
    for a, b in zip(tree_leaves(outs[0][:2]), tree_leaves(outs[1][:2])):
        assert np.array_equal(a, b)
    p1, o1 = outs[1][0]["groups"][0], outs[1][1]["groups"][0]
    p0, o0 = params["groups"][0], ref["opt"]["groups"][0]
    for a, b in zip(tree_leaves((p1, o1)), tree_leaves((p0, o0))):
        assert np.array_equal(a[1], b[1])          # the poisoned layer
        assert not np.array_equal(a[0], b[0])      # the others moved


@pytest.mark.parametrize("name", ["l2l-p", "l2l"])
def test_skip_nonfinite_returns_the_prior_state(reference, name):
    ref = reference
    params = tree_map(np.copy, ref["params"])
    params["head"]["out"][0, 0] = np.nan
    state = bridge.train_state_from_numpy(params, ref["opt"], 3, pack=True)
    want = bridge.train_state_to_numpy(state)
    eng = _engine(name, host_optimizer=True, pack_params=True,
                  skip_nonfinite=True)
    new, m = eng.train_step(state, _tbatch(ref["batch"]))
    got = bridge.train_state_to_numpy(new)
    assert m["skipped_steps"] == 1 and got[2] == 3
    for a, b in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
        assert a.tobytes() == b.tobytes()


def test_checkpoint_round_trip(reference, tmp_path):
    """Save after a host-optimizer step, restore into a fresh engine and
    continue: bit for bit an unbroken run."""
    batch = _tbatch(reference["batch"])
    kw = dict(host_optimizer=True, pack_params=True, prefetch_depth=1)
    eng = _engine(**kw)
    st = eng.init(torch.Generator().manual_seed(1))
    for _ in range(2):
        st, _m = eng.train_step(st, batch)
    want = _np_state(st)
    st = eng.init(torch.Generator().manual_seed(1))
    st, _m = eng.train_step(st, batch)
    eng.save(str(tmp_path), st)
    fresh = _engine(**kw)
    st, step = fresh.restore(str(tmp_path))
    assert step == 1
    st, _m = fresh.train_step(st, batch)
    got = _np_state(st)
    assert got[1] == want[1] == 2
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))


def test_train_cli_host_optimizer(capsys):
    losses = train_cli.main([
        "--device", "cpu", "--variant", "smoke", "--steps", "2",
        "--batch", "4", "--seq", "16", "--ub", "2", "--host-optimizer",
        "--pack", "--prefetch", "1", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert '"final_step": 2' in capsys.readouterr().out


# ---- on the card ------------------------------------------------------
@pytest.mark.card
def test_host_matches_device_on_card():
    """bert-large at full width, 2 layers, bf16 compute, f32 rows and Adam
    slots pinned in host memory: one step with the update on the host
    against the same step with K1 on the card, within the reference's bar
    (max abs 1e-6, equal loss); K1 is not launched on the host path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import fused_adam
    cfg = get_config("bert-large", "full").replace(n_layers=2,
                                                   use_pallas=True)
    rs = np.random.RandomState(0)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (4, 128)),
             "targets": rs.randint(0, cfg.vocab_size, (4, 128)),
             "mask": np.ones((4, 128), np.float32)}
    outs = {}
    for host in (False, True):
        eng = engines.create("l2l-p", cfg, ExecutionConfig(
            n_microbatches=2, weight_stream=True, pack_params=True,
            prefetch_depth=1, transport="pallas", offload_stash=True,
            host_optimizer=host), optimizer=adam(lr=1e-4))
        state = eng.init(torch.Generator("cuda").manual_seed(0))
        k1 = fused_adam.fused_adam_flat.launches
        new, m = eng.train_step(state, batch)
        outs[host] = (float(m["loss"]), _np_state(new)[0],
                      fused_adam.fused_adam_flat.launches - k1)
    assert outs[True][2] == 0 and outs[False][2] > 0
    assert outs[True][0] == outs[False][0]
    assert _max_abs(outs[True][1], outs[False][1]) <= 1e-6
