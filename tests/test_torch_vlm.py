"""internvl2-1b (the ``vlm`` family: a stubbed ViT's patches, projected by
``proj_w`` / ``proj_b`` in front of the tokens of a Qwen2-0.5B backbone)
through the port's engines on the CPU, at smoke size (2 layers, d 128, 4
heads over 2 kv, 4 patches of width 48) against the JAX package on the
same numpy inputs, f32, and the port against itself:

* the full-width config builds: the reference's groups and ParamSpec
  shapes leaf for leaf;
* the loss, ``Engine.grads`` and two ``train_step`` s under baseline, l2l
  and l2l-p against the JAX engine's, ``Engine.prefill`` with patches
  against the JAX prefill's, and greedy ``decode_init`` / ``decode_step``
  (text only, as the reference decodes) against the JAX engine's;
* ``head_loss`` reads the token positions only;
* the reference's ``add_modality_stubs`` case
  (``tests/test_data_checkpoint.py``), in the port;
* a zeroed ``proj_w`` fails the gradient check (the patch branch enters
  at full weight: ``proj_b`` is drawn as a bias, ``testing.BIASES``);
* the relay knob points ``(G, k, pack, K)`` and the host optimizer bit
  for bit inside the port, a snapshot the reference restores byte for
  byte, and both CLIs with ``--arch internvl2-1b``.

On the card (marker ``card``; ``python -m pytest -m card --noconftest
tests/test_torch_vlm.py``, which needs no JAX): the patch projection and
one layer's forward and vjp at full width (K2 / K3a / K3b at GQA 7, K5 at
width 896) against the same call on the CPU.  Gradient checks draw the
parameters at the usual fan-in scales (``repro_torch.testing``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.synthetic import add_modality_stubs  # noqa: E402
from repro_torch.models.common import is_spec  # noqa: E402
from repro_torch.models.model import LayeredModel  # noqa: E402
from repro_torch.testing import fan_in_params  # noqa: E402

ARCH = "internvl2-1b"
SLICE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas", offload_stash=True, n_microbatches=2)
B, S = 4, 12                    # 12 tokens behind 4 patches
PROMPT, STEPS = 8, 4
BOUND = 1e-5                    # tests/test_equivalence.py's


def _cfg(**kw):
    return get_config(ARCH, "smoke").replace(dtype="float32", **kw)


def _jcfg():
    from repro.configs.base import get_config as jget_config
    return jget_config(ARCH, "smoke").replace(dtype="float32")


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0
    return add_modality_stubs(
        {"tokens": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "targets": rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": mask}, cfg, np.random.default_rng(seed))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(la, lb):
    """max |a - b| over max |b| across two leaf lists."""
    num = max(float(np.abs(x - y).max()) for x, y in zip(la, lb))
    return num / max(max(float(np.abs(y).max()) for y in lb), 1e-12)


def _engine(name, **kw):
    return engines.create(name, _cfg(), ExecutionConfig(**kw), device="cpu")


def _grads_close(got, want, bound=BOUND):
    """Each part (embed, head, groups) within ``bound`` of ``want``."""
    import jax
    return all(_rel_max(jax.tree.leaves(got[p]), jax.tree.leaves(want[p]))
               < bound for p in ("embed", "head", "groups"))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_full_width_config_builds():
    """24 layers at d 896 in one group, the reference's ParamSpec shapes
    leaf for leaf (no weight drawn), the projection (1024, 896)."""
    import jax
    from repro.configs.base import get_config as jget_config
    from repro.models.model import LayeredModel as JModel
    model = LayeredModel(get_config(ARCH, "full"))
    jmodel = JModel(jget_config(ARCH, "full"))
    assert [(g.name, g.n_layers) for g in model.groups] == \
        [(g.name, g.n_layers) for g in jmodel.groups] == [("layers", 24)]
    got = tree_leaves(model.param_specs(), is_leaf=is_spec)
    want = jax.tree.leaves(jmodel.param_specs(),
                           is_leaf=lambda x: type(x).__name__ == "ParamSpec")
    assert [tuple(s.shape) for s in got] == [tuple(s.shape) for s in want]
    assert model.param_specs()["embed"]["proj_w"].shape == (1024, 896)


@pytest.fixture(scope="module")
def drawn():
    """numpy parameters at the usual fan-in scales, zero Adam slots, a
    batch with patches, and the JAX engine's two l2l-p steps from them
    (the first step's gradients read back from Adam's first moment,
    m = 0.1 g), its prefill logits and its loss function."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.core.schedule import ExecutionConfig as JExec
    from repro.engine.state import TrainState as JState
    jeng = jengines.create("l2l-p", _jcfg(), JExec(n_microbatches=2),
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
    batch = _batch(jeng.model.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = JState.from_legacy(jax.tree.map(jnp.asarray, params),
                               jeng._init_opt_legacy(params))
    losses = []
    for i in range(2):
        state, metrics = jeng.train_step(state, jbatch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            is_slot = lambda x: isinstance(x, dict) and set(x) == {"m", "v"}
            grads = jax.tree.map(
                lambda s: np.asarray(s["m"]) / np.float32(0.1),
                jax.tree.map(np.asarray, {k: state.legacy_opt()[k] for k in
                                          ("embed", "head", "groups")}),
                is_leaf=is_slot)
    prompt = {k: jbatch[k][:, :PROMPT] if k == "tokens" else jbatch[k]
              for k in ("tokens", "patches")}
    prefill = np.asarray(jeng.prefill(jax.tree.map(jnp.asarray, params),
                                      prompt))
    return dict(params=params, opt=opt, batch=batch, losses=losses,
                grads=grads, new_params=jax.tree.map(np.asarray,
                                                     state.params),
                prefill=prefill)


def test_full_loss_matches_jax(drawn):
    import jax
    import jax.numpy as jnp
    from repro.models.model import LayeredModel as JModel
    jl, _ = jax.jit(JModel(_jcfg()).full_loss)(
        jax.tree.map(jnp.asarray, drawn["params"]),
        {k: jnp.asarray(v) for k, v in drawn["batch"].items()})
    with torch.no_grad():
        tl, _ = LayeredModel(_cfg()).full_loss(
            bridge.params_from_numpy(drawn["params"]),
            _tbatch(drawn["batch"]))
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))


def test_head_loss_reads_token_positions_only(drawn):
    """Changing the patch positions of the head's input leaves the loss
    as it was, the head's gradient there is zero, and the loss equals the
    reference's head_loss on the same input (1e-6)."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import LayeredModel as JModel
    cfg = _cfg()
    P = cfg.n_patches
    params = bridge.params_from_numpy(drawn["params"])
    static = {"embed": params["embed"], "head": params["head"]}
    batch = _tbatch(drawn["batch"])
    x = torch.from_numpy(np.random.RandomState(3).randn(
        B, P + S, cfg.d_model).astype(np.float32)).requires_grad_()
    model = LayeredModel(cfg)
    loss, _ = model.head_loss(static, x, batch)
    (gx,) = torch.autograd.grad(loss, x)
    assert not gx[:, :P].any() and gx[:, P:].abs().sum() > 0
    x2 = x.detach().clone()
    x2[:, :P] = 100.0
    with torch.no_grad():
        assert float(model.head_loss(static, x2, batch)[0]) == \
            float(loss.detach())
    jl, _ = JModel(_jcfg()).head_loss(
        jax.tree.map(jnp.asarray, {"embed": drawn["params"]["embed"],
                                   "head": drawn["params"]["head"]}),
        jnp.asarray(x.detach().numpy()),
        {k: jnp.asarray(v) for k, v in drawn["batch"].items()})
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * abs(float(jl))


def test_modality_stubs_match_the_reference():
    """The reference's tests/test_data_checkpoint.py case for internvl2:
    the port's stub patches are the reference's, array for array."""
    from repro.configs.base import get_config as jget_config
    from repro.data.synthetic import add_modality_stubs as jstubs
    cfg = get_config(ARCH, "smoke")
    b = add_modality_stubs({"tokens": np.zeros((2, 8), np.int32)}, cfg)
    assert b["patches"].shape == (2, cfg.n_patches, cfg.vit_dim)
    want = jstubs({"tokens": np.zeros((2, 8), np.int32)},
                  jget_config(ARCH, "smoke"))
    np.testing.assert_array_equal(b["patches"], want["patches"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
GRAD_ENGINES = {"baseline": ("baseline", dict(n_microbatches=2)),
                "l2l": ("l2l", SLICE), "l2l-p": ("l2l-p", SLICE)}


@pytest.mark.parametrize("which", sorted(GRAD_ENGINES))
def test_grads_match_jax(drawn, which):
    """Engine.grads against the JAX engine's l2l-p gradients: the loss to
    1e-5 and every part to 1e-5."""
    name, kw = GRAD_ENGINES[which]
    loss, grads = _engine(name, **kw).grads(
        bridge.params_from_numpy(drawn["params"]), _tbatch(drawn["batch"]))
    assert abs(float(loss) - drawn["losses"][0]) <= BOUND * drawn["losses"][0]
    assert _grads_close(bridge.params_to_numpy(grads), drawn["grads"])


def test_zeroed_patch_projection_fails_the_check(drawn):
    """proj_w zeroed in the port only: the gradients leave the 1e-5 bound
    of the JAX engine's, so the check sees the patch branch."""
    params = bridge.params_from_numpy(drawn["params"])
    params["embed"]["proj_w"] = torch.zeros_like(params["embed"]["proj_w"])
    _, grads = _engine("l2l-p", **SLICE).grads(params,
                                               _tbatch(drawn["batch"]))
    assert not _grads_close(bridge.params_to_numpy(grads), drawn["grads"],
                            1e-2)


@pytest.mark.parametrize("which", sorted(GRAD_ENGINES))
def test_two_train_steps_match_jax(drawn, which):
    """Two steps (Adam, lr 1e-3): each loss within 1e-5 of the JAX l2l-p
    engine's, and the params after them within 1e-5 where the first
    step's |g| > 1e-4 (Adam moves an element by ~lr sign(g))."""
    import jax
    name, kw = GRAD_ENGINES[which]
    eng = _engine(name, **kw)
    state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"], 0,
                                          pack=kw.get("pack_params", False))
    batch = _tbatch(drawn["batch"])
    losses = []
    for _ in range(2):
        state, metrics = eng.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    for got, want in zip(losses, drawn["losses"]):
        assert abs(got - want) <= BOUND * want, (losses, drawn["losses"])
    params, _, step, _ = bridge.train_state_to_numpy(state)
    assert step == 2
    for part in ("embed", "head", "groups"):
        for w, g, gr in zip(jax.tree.leaves(drawn["new_params"][part]),
                            jax.tree.leaves(params[part]),
                            jax.tree.leaves(drawn["grads"][part])):
            keep = np.abs(gr) > 1e-4
            np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5,
                                       atol=1e-6)


# the reference's (G, prefetch, pack) points (tests/test_relay.py) and two
# stash points (tests/test_stash.py); G = 3 relays the two layers whole
KNOBS = [(1, 0, False, 1), (2, 2, True, 1), (3, 1, False, 2)]


@pytest.mark.parametrize("g,k,pack,se", KNOBS)
def test_grads_knob_points_are_bitwise(drawn, g, k, pack, se):
    params = bridge.params_from_numpy(drawn["params"])
    batch = _tbatch(drawn["batch"])
    want = _engine("l2l-p", n_microbatches=2).grads(params, batch)
    got = _engine("l2l-p", n_microbatches=2, layers_per_relay=g,
                  prefetch_depth=k, pack_params=pack, stash_every=se,
                  transport="pallas" if pack else "xla").grads(params, batch)
    assert float(got[0]) == float(want[0])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got[1]), tree_leaves(want[1])))


def test_host_optimizer_equals_the_device_optimizer(drawn):
    """The host optimizer's step against K1's (its plain version here):
    the loss, params and Adam slots bit for bit."""
    outs = []
    for kw in ({}, dict(host_optimizer=True)):
        eng = _engine("l2l-p", **{**SLICE, **kw})
        state = bridge.train_state_from_numpy(drawn["params"], drawn["opt"],
                                              0, pack=True)
        new, m = eng.train_step(state, _tbatch(drawn["batch"]))
        p, o, _, _ = bridge.train_state_to_numpy(new)
        outs.append((float(m["loss"]), tree_leaves(p), tree_leaves(o)))
    assert outs[0][0] == outs[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    assert all(np.array_equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


def test_snapshot_round_trip_and_the_reference_restores_it(drawn,
                                                           tmp_path):
    """A step, a save, a restore into a fresh engine, a second step: the
    same bits as two unbroken steps; the reference restores the port's
    snapshot of the first step byte for byte."""
    import jax
    from repro import engine as jengines
    from repro.core.schedule import ExecutionConfig as JExec
    batch = _tbatch(drawn["batch"])
    eng = _engine("l2l-p", **SLICE)
    s1, _ = eng.train_step(bridge.train_state_from_numpy(
        drawn["params"], drawn["opt"], 0, pack=True), batch)
    s2, _ = eng.train_step(s1, batch)
    eng.save(str(tmp_path), s1)
    back, step = _engine("l2l-p", **SLICE).restore(str(tmp_path))
    assert step == 1
    s2b, _ = _engine("l2l-p", **SLICE).train_step(back, batch)
    a, b = bridge.train_state_to_numpy(s2), bridge.train_state_to_numpy(s2b)
    assert all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a[:2]), jax.tree.leaves(b[:2])))
    jeng = jengines.create("l2l-p", _jcfg(), JExec(n_microbatches=2),
                           donate=False)
    jstate, jstep = jeng.restore(str(tmp_path))
    assert jstep == 1
    want = bridge.train_state_to_numpy(s1)[0]
    assert all(np.array_equal(np.asarray(x), y) for x, y in
               zip(jax.tree.leaves(jstate.params), jax.tree.leaves(want)))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_prefill_with_patches_matches_jax(drawn):
    """Engine.prefill's last-token logits with the patches in front of 8
    prompt tokens, under the serve knobs, within 1e-5 relative L2 of the
    JAX engine's."""
    eng = engines.create("l2l", _cfg(), ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1,
        transport="pallas"), device="cpu")
    batch = _tbatch(drawn["batch"])
    got = eng.prefill(bridge.params_from_numpy(drawn["params"]),
                      {"tokens": batch["tokens"][:, :PROMPT],
                       "patches": batch["patches"]})
    assert _rel_l2(got.numpy(), drawn["prefill"]) <= BOUND


def test_text_decode_matches_jax(drawn):
    """Greedy decode_init / decode_step on text (the reference decodes the
    language backbone, no patches) under the serve knobs: the tokens
    equal, the logits within 1e-5 relative L2."""
    import jax
    import jax.numpy as jnp
    from repro import engine as jengines
    from repro.core.schedule import ExecutionConfig as JExec
    jeng = jengines.create("l2l", _jcfg(), JExec(), donate=False)
    prompt = drawn["batch"]["tokens"][:2, :PROMPT]
    jp = jax.tree.map(jnp.asarray, drawn["params"])
    eng = engines.create("l2l", _cfg(), ExecutionConfig(
        weight_stream=True, pack_params=True, prefetch_depth=1,
        transport="pallas"), device="cpu")
    tp = bridge.params_from_numpy(drawn["params"])
    jc, jl = jeng.decode_init(jp, jnp.asarray(prompt), PROMPT + STEPS)
    tc, tl = eng.decode_init(tp, torch.from_numpy(prompt), PROMPT + STEPS)
    got, want = [tl.numpy()], [np.asarray(jl)]
    for i in range(STEPS):
        tok = torch.from_numpy(np.array(jnp.argmax(jl, -1)))[:, None]
        assert torch.equal(tok[:, 0], tl.argmax(-1))
        jl, jc = jeng.decode_step(jp, jc, jnp.asarray(tok.numpy()),
                                  jnp.int32(PROMPT + i))
        tl, tc = eng.decode_step(tp, tc, tok, PROMPT + i)
        jl, tl = jl[:, -1], tl[:, -1]
        got.append(tl.numpy())
        want.append(np.asarray(jl))
    assert _rel_l2(np.stack(got), np.stack(want)) <= BOUND


def test_clis_run_on_cpu(capsys):
    """``--arch internvl2-1b`` through the train CLI (l2l-p, the slice's
    knobs: the patches come from add_modality_stubs) and the serve CLI
    (continuous batching on the text backbone)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    flags = ["--device", "cpu", "--arch", ARCH, "--variant", "smoke"]
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
def test_layer_and_projection_on_card_match_cpu():
    """At full width (d 896, 14 heads over 2, GQA 7), f32, B=2 x 128
    tokens behind 256 patches (384 positions: they tile by 128), at
    fan-in scales: prepare's patch projection and one layer's forward and
    vjp on the card (attention through K2 and K3a/K3b's f32 route, the
    norms through K5) against the CPU's, 1e-4 relative L2 per leaf.  TF32
    off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH, "full").replace(dtype="float32", use_pallas=True)
    model = LayeredModel(cfg)
    group = model.groups[0]
    gen = torch.Generator().manual_seed(0)
    rand = lambda s: torch.randn(s, generator=gen)
    w = fan_in_params(group.spec, rand)
    emb = fan_in_params({k: v for k, v in
                         model.param_specs()["embed"].items()
                         if k.startswith("proj")}, rand)
    n = cfg.n_patches + 128
    patches = rand((2, cfg.n_patches, cfg.vit_dim))
    gy = rand((2, n, cfg.d_model))
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    emb["tok"] = 0.02 * rand((cfg.vocab_size, cfg.d_model))

    def run(dev):
        from repro_torch.models.blocks import Ctx
        ww = tree_map(lambda a: a.to(dev).requires_grad_(), w)
        leaves = tree_leaves(ww)
        static = {"embed": tree_map(lambda a: a.to(dev), emb)}
        x, _ = model.prepare(static, {"tokens": tokens.to(dev),
                                      "patches": patches.to(dev)})
        xx = x.detach().requires_grad_()
        ctx = Ctx(positions=torch.arange(n, dtype=torch.int32,
                                         device=dev).expand(2, n))
        y, _ = group.apply(ww, xx, None, ctx)
        g = torch.autograd.grad(y, leaves + [xx], gy.to(dev))
        return [t.detach().cpu().numpy() for t in (x, y) + g]

    for got, want in zip(run("cuda"), run("cpu")):
        assert _rel_l2(got, want) <= 1e-4
