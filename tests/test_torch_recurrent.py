"""The recurrent families through the port's engines on the CPU: hymba-1.5b
(attention heads beside Mamba heads off one norm, a sliding window) and
rwkv6-1.6b (WKV6, layernorm, no attention) at smoke size, against the JAX
package on the same numpy inputs, f32, and the port against itself.

* the full-width configs build: the reference's groups and ParamSpec
  shapes leaf for leaf;
* ``Engine.grads`` under baseline, l2l and l2l-p against the JAX engine's
  l2l-p gradients (S = 40: hymba's 32-token window masks);
* 3 ``train_step`` losses under l2l-p with the slice's knobs against the
  JAX engine's, and one step under Alg 3 (l2l) and the host optimizer;
* ``Engine.prefill`` logits and greedy ``decode_init`` / ``decode_step``
  tokens against the JAX engine's, the recurrent state written into the
  caches in place;
* the reference's knob points ``(G, k, pack)`` bit for bit inside the
  port, one ``dynamic_depth`` case (run depth 1 of 2 against a static
  one-layer engine) and the host optimizer against the device's;
* both CLIs with ``--arch``: the reference's ``tests/test_system.py``
  serve driver test for rwkv6, and both archs through the train CLI.

On the card (marker ``card``; ``python -m pytest -m card --noconftest
tests/test_torch_recurrent.py``, which needs no JAX): one layer's forward
and vjp of each family at full width on the card (hymba's attention
through K2 / K3a / K3b, its norms through K5) against the same call on
the CPU.  Parameters are drawn at the usual fan-in scales
(``repro_torch.testing.fan_in_params``) for the gradient checks, and the
reference's own init for serving."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.common import is_spec  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params, init_numpy  # noqa: E402,E501

ARCHS = ["hymba-1.5b", "rwkv6-1.6b"]
SLICE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas", offload_stash=True, n_microbatches=2)
B, S = 4, 40
PROMPT, STEPS = 8, 4


def _cfg(arch, **kw):
    return get_config(arch, "smoke").replace(dtype="float32", **kw)


def _jcfg(arch):
    from repro.configs.base import get_config as jget_config
    return jget_config(arch, "smoke").replace(dtype="float32")


def _batch(vocab, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0
    return {"tokens": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "targets": rs.randint(0, vocab, (B, S)).astype(np.int32),
            "mask": mask}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(la, lb):
    """max |a - b| over max |b| across two leaf lists."""
    num = max(float(np.abs(x - y).max()) for x, y in zip(la, lb))
    return num / max(max(float(np.abs(y).max()) for y in lb), 1e-12)


def _engine(name, arch, **kw):
    return engines.create(name, _cfg(arch), ExecutionConfig(**kw),
                          device="cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_configs_build(arch):
    """LayeredModel builds each config at full width: one group of all
    the layers, and the reference's ParamSpec shapes leaf for leaf (no
    weight drawn); f32 bytes per layer 162.6 MB (hymba), 221.9 MB (rwkv6)."""
    import jax
    from repro.configs.base import get_config as jget_config
    from repro.models.model import LayeredModel as JModel
    from repro_torch.models.common import param_bytes
    model = LayeredModel(get_config(arch, "full"))
    jmodel = JModel(jget_config(arch, "full"))
    assert [(g.name, g.n_layers) for g in model.groups] == \
        [(g.name, g.n_layers) for g in jmodel.groups]
    got = tree_leaves(model.param_specs(), is_leaf=is_spec)
    want = jax.tree.leaves(jmodel.param_specs(),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s.shape) for s in got] == [tuple(s.shape) for s in want]
    per_layer = param_bytes(model.groups[0].spec)
    assert round(per_layer / 1e6, 1) == {"hymba-1.5b": 162.6,
                                         "rwkv6-1.6b": 221.9}[arch]


@pytest.fixture(scope="module", params=ARCHS)
def drawn(request):
    """numpy parameters at the usual fan-in scales, zero Adam slots, a
    batch, and the JAX engine's three l2l-p steps from them (the first
    step's gradients read back from Adam's first moment, m = 0.1 g)."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.core.schedule import ExecutionConfig as JExec
    from repro.engine.state import TrainState as JState
    arch = request.param
    jeng = jengines.create("l2l-p", _jcfg(arch), JExec(n_microbatches=2),
                           donate=False)
    # the draws need the parameters' shapes only
    shapes = jeng.model.abstract_params()
    rs = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        fan_in_params(shapes,
                      lambda s: rs.randn(*s)))
    opt = jax.tree.map(np.asarray, {
        k: v for k, v in jeng._init_opt_legacy(params).items()
        if k in ("embed", "head", "groups")})
    batch = _batch(jeng.model.cfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = JState.from_legacy(jax.tree.map(jnp.asarray, params),
                               jeng._init_opt_legacy(params))
    losses = []
    for i in range(3):
        state, metrics = jeng.train_step(state, jbatch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            is_slot = lambda x: isinstance(x, dict) and set(x) == {"m", "v"}
            grads = jax.tree.map(
                lambda s: np.asarray(s["m"]) / np.float32(0.1),
                jax.tree.map(np.asarray, {k: state.legacy_opt()[k] for k in
                                          ("embed", "head", "groups")}),
                is_leaf=is_slot)
            new_params = jax.tree.map(np.asarray, state.params)
    return dict(arch=arch, params=params, opt=opt, batch=batch,
                losses=losses, grads=grads, new_params=new_params)


def test_full_loss_matches_jax(drawn):
    import jax
    import jax.numpy as jnp
    from repro.models.model import LayeredModel as JModel
    arch = drawn["arch"]
    jl, _ = jax.jit(JModel(_jcfg(arch)).full_loss)(
        jax.tree.map(jnp.asarray, drawn["params"]),
        {k: jnp.asarray(v) for k, v in drawn["batch"].items()})
    with torch.no_grad():
        tl, _ = LayeredModel(_cfg(arch)).full_loss(
            bridge.params_from_numpy(drawn["params"]),
            _tbatch(drawn["batch"]))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
GRAD_ENGINES = {"baseline": ("baseline", dict(n_microbatches=2)),
                "l2l": ("l2l", SLICE), "l2l-p": ("l2l-p", SLICE)}


@pytest.mark.parametrize("which", sorted(GRAD_ENGINES))
def test_grads_match_jax(drawn, which):
    """Engine.grads against the JAX engine's l2l-p gradients: the loss to
    1e-5 and every part to tests/test_equivalence.py's 1e-5."""
    import jax
    name, kw = GRAD_ENGINES[which]
    loss, grads = _engine(name, drawn["arch"], **kw).grads(
        bridge.params_from_numpy(drawn["params"]), _tbatch(drawn["batch"]))
    assert abs(float(loss) - drawn["losses"][0]) <= 1e-5 * drawn["losses"][0]
    got = bridge.params_to_numpy(grads)
    for part in ("embed", "head", "groups"):
        assert _rel_max(jax.tree.leaves(got[part]),
                        jax.tree.leaves(drawn["grads"][part])) < 1e-5, part


def test_three_train_steps_match_jax(drawn):
    """Three l2l-p steps (Adam, lr 1e-3) with the slice's knobs: each
    step's loss within 1e-5 relative of the JAX engine's."""
    eng = _engine("l2l-p", drawn["arch"], **SLICE)
    state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"], 0,
                                          pack=True)
    batch = _tbatch(drawn["batch"])
    losses = []
    for _ in range(3):
        state, metrics = eng.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    assert state.step == 3
    for got, want in zip(losses, drawn["losses"]):
        assert abs(got - want) <= 1e-5 * want, (losses, drawn["losses"])
    assert drawn["losses"][2] < drawn["losses"][0]


@pytest.mark.parametrize("which", ["alg3", "host"])
def test_train_step_matches_jax(drawn, which):
    """One step under Alg 3 (l2l) and under the host optimizer against the
    JAX engine's l2l-p step: the params to 1e-5 where |g| > 1e-4 (Adam's
    first step moves an element by ~lr·sign(g): tests/test_torch_train)."""
    import jax
    name, kw = {"alg3": ("l2l", {}),
                "host": ("l2l-p", dict(host_optimizer=True))}[which]
    eng = _engine(name, drawn["arch"], **{**SLICE, **kw})
    state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"], 0,
                                          pack=True)
    new, metrics = eng.train_step(state, _tbatch(drawn["batch"]))
    params, _, step, _ = bridge.train_state_to_numpy(new)
    assert step == 1
    loss = drawn["losses"][0]
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * loss
    for part in ("embed", "head", "groups"):
        for w, g, gr in zip(jax.tree.leaves(drawn["new_params"][part]),
                            jax.tree.leaves(params[part]),
                            jax.tree.leaves(drawn["grads"][part])):
            keep = np.abs(gr) > 1e-4
            np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5,
                                       atol=1e-6)


# the reference's (G, prefetch, pack) points (tests/test_relay.py); G = 3
# is deeper than the two-layer stack, which it relays whole
KNOBS = [(1, 0, False), (2, 2, True), (3, 1, False)]


@pytest.mark.parametrize("g,k,pack", KNOBS)
def test_grads_knob_points_are_bitwise(drawn, g, k, pack):
    arch, params = drawn["arch"], bridge.params_from_numpy(drawn["params"])
    batch = _tbatch(drawn["batch"])
    want = _engine("l2l-p", arch, n_microbatches=2).grads(params, batch)
    got = _engine("l2l-p", arch, n_microbatches=2, layers_per_relay=g,
                  prefetch_depth=k, pack_params=pack,
                  transport="pallas" if pack else "xla").grads(params, batch)
    assert float(got[0]) == float(want[0])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got[1]), tree_leaves(want[1])))


def test_host_optimizer_equals_the_device_optimizer(drawn):
    """The host optimizer's step against K1's (its plain version here):
    the loss, params and Adam slots bit for bit."""
    outs = []
    for kw in ({}, dict(host_optimizer=True)):
        eng = _engine("l2l-p", drawn["arch"], **{**SLICE, **kw})
        state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"],
                                              0, pack=True)
        new, m = eng.train_step(state, _tbatch(drawn["batch"]))
        p, o, _, _ = bridge.train_state_to_numpy(new)
        outs.append((float(m["loss"]), tree_leaves(p), tree_leaves(o)))
    assert outs[0][0] == outs[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


def test_dynamic_depth_equals_static_depth(drawn):
    """Capacity 2 at run depth 1: grads and prefill equal a static
    one-layer engine's on the first rows bit for bit, the idle row's
    gradient 0."""
    arch, batch = drawn["arch"], _tbatch(drawn["batch"])
    params = bridge.params_from_numpy(drawn["params"])
    first = {**params, "groups": tuple(tree_map(lambda a: a[:1], g)
                                       for g in params["groups"])}
    dyn = _engine("l2l-p", arch, **SLICE, dynamic_depth=True)
    stat = engines.create("l2l-p", _cfg(arch, n_layers=1),
                          ExecutionConfig(**SLICE), device="cpu")
    (ld, gd), (ls, gs) = (dyn.grads(params, batch, n_layers=1),
                          stat.grads(first, batch))
    assert float(ld) == float(ls)
    for a, b in zip(tree_leaves(gd["groups"]), tree_leaves(gs["groups"])):
        assert torch.equal(a[:1], b) and not a[1:].any()
    prompt = batch["tokens"][:, :PROMPT]
    assert torch.equal(dyn.prefill(params, {"tokens": prompt}, n_layers=1),
                       stat.prefill(first, {"tokens": prompt}))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The JAX engine's greedy run and prefill logits at the reference's
    init scales (the port's init, seed 0)."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.core.schedule import ExecutionConfig as JExec
    cfg = _jcfg(request.param)
    eng = jengines.create("l2l", cfg, JExec(), donate=False)
    params = jax.tree.map(jnp.asarray, init_numpy(cfg, 0))
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)
    caches, last = eng.decode_init(params, jnp.asarray(prompt),
                                   PROMPT + STEPS)
    logits = [np.asarray(last)]
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for i in range(STEPS):
        lg, caches = eng.decode_step(params, caches, tok,
                                     jnp.int32(PROMPT + i))
        logits.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    prefill = np.asarray(eng.prefill(params, {"tokens": jnp.asarray(prompt)}))
    return dict(arch=request.param, params=jax.tree.map(np.asarray, params),
                prompt=prompt, tokens=np.concatenate(toks, 1),
                logits=np.stack(logits), prefill=prefill,
                caches=jax.tree.map(np.asarray, caches))


def test_serving_matches_jax_engine(served):
    """The serve knobs (weight_stream, pack, prefetch 1, the relay-copy
    transport): greedy tokens equal, decode logits within 1e-4 relative
    L2, the final recurrent state within 1e-4, and Engine.prefill's
    last-token logits within 1e-4 of the JAX prefill's."""
    import jax
    eng = engines.create("l2l", _cfg(served["arch"]), ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1,
        transport="pallas"), device="cpu")
    params = bridge.params_from_numpy(served["params"])
    prompt = torch.from_numpy(served["prompt"])
    caches, last = eng.decode_init(params, prompt, PROMPT + STEPS)
    held = tree_leaves(caches)
    logits, tok = [last], last.argmax(-1)[:, None]
    toks = [tok]
    for i in range(STEPS):
        lg, caches = eng.decode_step(params, caches, tok, PROMPT + i)
        logits.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1)[:, None]
        toks.append(tok)
    # the steps wrote into the caches decode_init made
    assert all(a is b for a, b in zip(tree_leaves(caches), held))
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(),
                                  served["tokens"])
    assert _rel_l2(torch.stack(logits).numpy(), served["logits"]) <= 1e-4
    for a, b in zip(tree_leaves(caches), jax.tree.leaves(served["caches"])):
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert _rel_l2(a.numpy(), b) <= 1e-4
    pf = eng.prefill(params, {"tokens": prompt})
    assert _rel_l2(pf.numpy(), served["prefill"]) <= 1e-4


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def test_serve_driver_cli_rwkv6():
    """tests/test_system.py's serve driver test in the port: continuous
    (the default mode) and --mode oneshot."""
    from repro_torch.launch.serve import main
    reqs = main(["--device", "cpu", "--arch", "rwkv6-1.6b", "--variant",
                 "smoke", "--requests", "3", "--max-batch", "2",
                 "--prompt-len", "8", "--gen", "4"])
    assert len(reqs) == 3
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    toks = main(["--device", "cpu", "--arch", "rwkv6-1.6b", "--variant",
                 "smoke", "--mode", "oneshot", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4"])
    assert toks.shape == (2, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_on_cpu(arch, capsys):
    """``--arch`` through the train CLI (l2l-p, the slice's knobs) and the
    serve CLI (continuous, the slice's knobs: the prefill chunk is forced
    to 1 for a recurrent family)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    flags = ["--device", "cpu", "--arch", arch, "--variant", "smoke"]
    losses = train_cli.main(flags + [
        "--steps", "2", "--batch", "4", "--seq", "16", "--ub", "2",
        "--weight-stream", "--pack", "--prefetch", "1", "--transport",
        "pallas", "--offload-stash"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    reqs = serve_cli.main(flags + [
        "--requests", "3", "--max-batch", "2", "--prompt-len", "8", "--gen",
        "4", "--prefill-chunk", "4", "--weight-stream", "--pack",
        "--prefetch", "1", "--transport", "pallas"])
    assert all(len(r.generated) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert '"final_step": 2' in out and "done=3" in out


# ---- on the card --------------------------------------------------------
@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_grads_on_card_match_cpu(arch):
    """One layer at full width (hymba 1600 wide, 25 heads over 5, window
    2048; rwkv6 2048 wide), f32, B=2 x S=128, at fan-in scales: the
    forward and the vjp on the card (hymba's attention through K2 and
    K3a/K3b's f32 route, its norms through K5) against the CPU's, 1e-4
    relative L2 per leaf.  TF32 off: rwkv's decay is f32 matmuls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, "full").replace(dtype="float32", use_pallas=True)
    group = LayeredModel(cfg).groups[0]
    gen = torch.Generator().manual_seed(0)
    w = fan_in_params(group.spec, lambda s: torch.randn(s, generator=gen))
    x = torch.randn(2, 128, cfg.d_model, generator=gen)
    gy = torch.randn(2, 128, cfg.d_model, generator=gen)
    pos = torch.arange(128, dtype=torch.int32).expand(2, 128)

    def run(dev):
        from repro_torch.models.blocks import Ctx
        ww = tree_map(lambda a: a.to(dev).requires_grad_(), w)
        leaves = tree_leaves(ww)
        xx = x.to(dev).requires_grad_()
        ctx = Ctx(positions=pos.to(dev), window=cfg.sliding_window)
        y, _ = group.apply(ww, xx, None, ctx)
        g = torch.autograd.grad(y, leaves + [xx], gy.to(dev))
        return [t.detach().cpu().numpy() for t in (y,) + g]

    for got, want in zip(run("cuda"), run("cpu")):
        assert _rel_l2(got, want) <= 1e-4
