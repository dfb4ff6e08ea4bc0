"""The serving slice as a whole on the CPU: the port's Engine against the
JAX engine under the slice's configuration (weight streaming, packed
relay, prefetch 1, the relay-copy transport, the flash and RMSNorm
kernels — the JAX ones in interpret mode), and the port against itself
across the relay knobs."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengines  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core.schedule import ExecutionConfig as JExec  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.testing import init_numpy  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve.sampling import sample, sample_batch  # noqa: E402

SLICE = dict(weight_stream=True, pack_params=True, prefetch_depth=1,
             transport="pallas", n_microbatches=2)
B, PROMPT, STEPS = 2, 8, 6


# granite-3-8b (slice 1) and the dense configs the port's blocks cover
ARCHS = ["granite-3-8b", "chatglm3-6b", "command-r-35b", "qwen1.5-110b"]


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The JAX engine's greedy run and prefill logits, with the params."""
    cfg = jget_config(request.param, "smoke").replace(dtype="float32",
                                                      use_pallas=True)
    eng = jengines.create("l2l", cfg, JExec(**SLICE), donate=False)
    params = jax.tree.map(jnp.asarray, init_numpy(cfg, 0))
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    prev = jcommon.use_pallas_rmsnorm(True)
    try:
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
        prefill = np.asarray(eng.prefill(params,
                                         {"tokens": jnp.asarray(prompt)}))
    finally:
        jcommon.use_pallas_rmsnorm(prev)
    return dict(arch=request.param,
                params=jax.tree.map(np.asarray, params), prompt=prompt,
                tokens=np.concatenate(toks, 1), logits=np.stack(logits),
                prefill=prefill)


def _greedy(eng, params, prompt, steps=STEPS):
    """(tokens (B, steps + 1), logits (steps + 1, B, V)); the cache holds
    the whole context, or the decode window's ring."""
    live = eng.exec_cfg.decode_window or prompt.shape[1] + steps
    caches, last = eng.decode_init(params, prompt, live)
    logits = [last]
    tok = last.argmax(-1)[:, None]
    toks = [tok]
    for i in range(steps):
        lg, caches = eng.decode_step(params, caches, tok, prompt.shape[1] + i)
        logits.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, 1), torch.stack(logits)


def _port_engine(arch="granite-3-8b", **exec_kw):
    cfg = get_config(arch, "smoke").replace(dtype="float32", use_pallas=True)
    return engines.create("l2l", cfg, ExecutionConfig(**exec_kw),
                          device="cpu")


def test_greedy_tokens_match_jax_engine(reference):
    eng = _port_engine(reference["arch"], **SLICE)
    params = bridge.params_from_numpy(reference["params"])
    toks, logits = _greedy(eng, params,
                           torch.from_numpy(reference["prompt"]))
    np.testing.assert_array_equal(toks.numpy(), reference["tokens"])
    # 2 f32 layers + the head, per token: 1e-4 on logits of size ~1
    np.testing.assert_allclose(logits.numpy(), reference["logits"],
                               atol=1e-4, rtol=1e-4)


def test_prefill_logits_match_jax_engine(reference):
    eng = _port_engine(reference["arch"], **SLICE)
    params = bridge.params_from_numpy(reference["params"])
    got = eng.prefill(params, {"tokens": torch.from_numpy(
        reference["prompt"])})
    np.testing.assert_allclose(got.numpy(), reference["prefill"],
                               atol=1e-4, rtol=1e-4)
    # prefill and the token-by-token decode_init agree on the last token
    np.testing.assert_allclose(got.numpy(), reference["logits"][0],
                               atol=1e-4, rtol=1e-4)


# pack x prefetch x G at a depth G=2 does not divide: bitwise inside the port
_GRID = list(itertools.product((False, True), (0, 1), (1, 2)))


@pytest.fixture(scope="module")
def grid_base():
    cfg = get_config("granite-3-8b", "smoke").replace(dtype="float32",
                                                      n_layers=3)
    params = engines.create("l2l", cfg, device="cpu").model.init_params(
        torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (B, 5),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, prompt


@pytest.mark.parametrize("pack,prefetch,group", _GRID)
def test_relay_knobs_bitwise(grid_base, pack, prefetch, group):
    cfg, params, prompt = grid_base
    runs = []
    for knobs in (dict(), dict(pack_params=pack, prefetch_depth=prefetch,
                               layers_per_relay=group, transport="pallas")):
        eng = engines.create("l2l-p", cfg, ExecutionConfig(
            weight_stream=True, **knobs), device="cpu")
        toks, logits = _greedy(eng, params, prompt, steps=3)
        runs.append((toks, logits, eng.prefill(params, {"tokens": prompt})))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pack", [False, True])
def test_streaming_init_equals_model_init(pack):
    cfg = get_config("granite-3-8b", "smoke").replace(n_layers=3)
    eng = engines.create("l2l", cfg, ExecutionConfig(
        weight_stream=True, pack_params=pack), device="cpu")
    got = eng._relay_params(eng.init_params(torch.Generator().manual_seed(5)))
    want = eng._relay_params(eng.model.init_params(
        torch.Generator().manual_seed(5)))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))
    # the port's init keeps the reference's scales: std 1/sqrt(N) per matrix
    w = eng.model.init_params(torch.Generator().manual_seed(5))
    std = float(w["groups"][0]["mlp"]["w_in"].std())
    assert abs(std - 3 ** -0.5) < 0.02


def test_oneshot_cli_runs_in_process(capsys):
    toks = serve_cli.main(["--mode", "oneshot", "--device", "cpu",
                           "--variant", "smoke",
                           "--batch", "2", "--prompt-len", "4", "--gen", "3",
                           "--weight-stream", "--pack", "--prefetch", "1",
                           "--transport", "pallas"])
    assert toks.shape == (2, 3)
    assert "tok/s" in capsys.readouterr().out


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.create("l2l", get_config("granite-3-8b", "smoke"))


def test_sampling_greedy_first_max_and_seeded_determinism():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 1.0, 0.0]])
    assert sample_batch(logits).tolist() == [1, 0]
    big = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    a = sample_batch(big, temperature=0.8, top_k=5, seed=7, position=3)
    b = sample_batch(big, temperature=0.8, top_k=5, seed=7, position=3)
    assert torch.equal(a, b)
    for r in range(3):          # top-k keeps the draw inside the k best
        assert int(a[r]) in torch.topk(big[r], 5).indices.tolist()
    # a row's draw depends on its own (seed, position), not its batch row
    solo = sample(big[2:3], [9], [3], [0.8], [5])
    pair = sample(big[[0, 2]], [1, 9], [3, 3], [0.8, 0.8], [5, 5])
    assert int(solo[0]) == int(pair[1])


@pytest.mark.parametrize("grouped", [False, True])
def test_decode_window_ring_matches_jax_engine(grouped):
    """The ``decode_window`` ring buffer: granite smoke in f32, a window of
    8, a 6-token prompt and 14 greedy steps (the ring wraps twice), the
    port under the slice's knobs against the JAX engine: logits within
    1e-4, tokens equal; with the KV heads expanded and kept grouped."""
    W, P_LEN, N = 8, 6, 14
    jcfg = jget_config("granite-3-8b", "smoke").replace(
        dtype="float32", grouped_decode_attn=grouped)
    jeng = jengines.create("l2l", jcfg, JExec(decode_window=W), donate=False)
    params = jax.tree.map(jnp.asarray, init_numpy(jcfg, 3))
    prompt = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, size=(B, P_LEN)).astype(np.int32)
    caches, last = jeng.decode_init(params, jnp.asarray(prompt), W)
    want = [np.asarray(last)]
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    for i in range(N):
        lg, caches = jeng.decode_step(params, caches, tok,
                                      jnp.int32(P_LEN + i))
        want.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    want = np.stack(want)

    cfg = get_config("granite-3-8b", "smoke").replace(
        dtype="float32", grouped_decode_attn=grouped)
    eng = engines.create("l2l", cfg, ExecutionConfig(decode_window=W,
                                                     **SLICE), device="cpu")
    toks, logits = _greedy(eng, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params)), torch.from_numpy(prompt), N)
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(toks.numpy(), want.argmax(-1).T)
