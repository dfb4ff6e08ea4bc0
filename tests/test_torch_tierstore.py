"""The port's disk tier (repro_torch.core.tierstore) on the CPU.

Mirrors the reference's tests/test_tierstore.py and the tier tests of
tests/test_faults.py, with the reference's own fault injectors
(``repro_torch.testing.faults``, the port of ``repro.testing.faults``)
applied to the port's store:

* the SegmentStore: round trip (f32 and bf16), atomic put, torn write
  and rot caught at open and at read, transient EIO retried then
  recovered, a persistent or non-transient error raised, the rebuilder;
* its on-disk format is the reference's: a directory written by either
  package opens, verifies and reads back bit for bit in the other;
* the chain is a placement change only: ``tiers=3`` is bit for bit the
  port's own ``tiers=2`` (grads, params, Adam slots) across the
  reference's (G, prefetch, pack, K, budget) grid, on the inference
  paths, through a mid-run quarantine and rebuild, across checkpoints
  both ways, under injected latency (budget demotion, async stage-in).

The reference's own ``tiers=3`` grid and async tests are red on this
tree, so they are not the ground truth here; ``tiers=2`` is.
"""
import errno
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.testing import faults  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import engine as engines  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import relay, tierstore  # noqa: E402
from repro_torch.core.schedule import ExecutionConfig  # noqa: E402
from repro_torch.core.tierstore import (  # noqa: E402
    SegmentStore, TierIntegrityError, TierReadError, demote_plan, ring_depth)
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402


def _cfg(n_layers=5, arch="bert-large"):
    return get_config(arch, "smoke").replace(dtype="float32",
                                             n_layers=n_layers)


def _segs(n=4, w=6, seed=0):
    """An f32 and a bf16 segment as torch tensors."""
    g = torch.Generator().manual_seed(seed)
    return {"float32": torch.randn(n, w, generator=g),
            "bfloat16": torch.arange(n * 3, dtype=torch.float32)
            .reshape(n, 3).to(torch.bfloat16)}


def _bits(t):
    return t.contiguous().view(-1).view(torch.uint8).numpy()


def _same(a, b):
    return a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape) and \
        np.array_equal(_bits(a), _bits(b))


def _batch(cfg, B=4, S=16, seed=0):
    rs = np.random.RandomState(seed)
    return {"tokens": torch.from_numpy(
                rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)),
            "targets": torch.from_numpy(
                rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)),
            "mask": torch.ones(B, S)}


def _tier_exec(root, *, G=1, k=0, pk=False, K=1, budget=0, tiers=3, **kw):
    return ExecutionConfig(
        n_microbatches=2, layers_per_relay=G, prefetch_depth=k,
        pack_params=pk, stash_every=K, tiers=tiers, host_budget_bytes=budget,
        tier_dir=str(root), tier_backoff_s=0.001, **kw)


def _engine(name, cfg, exec_cfg):
    return engines.create(name, cfg, exec_cfg, optimizer=adam(lr=1e-3),
                          device="cpu")


def _leaves(state, eng):
    """(params, opt) numpy leaves of a state, staged in whole first."""
    if eng.tier is not None:
        state = eng.tier.stage_in(state)
    p, o, _, _ = bridge.train_state_to_numpy(state)
    return tree_leaves(p) + tree_leaves(o)


def _assert_bitwise(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
            f"{what}: leaf {i} differs"


def _run(eng, batch, n=2, hook=None):
    state = eng.init(torch.Generator().manual_seed(0))
    m = {}
    for i in range(n):
        if hook is not None:
            hook(i, eng, state)
        state, m = eng.train_step(state, batch)
    return float(m["loss"]), state


# ===========================================================================
# SegmentStore
# ===========================================================================
def test_store_roundtrip_all_rows_and_slices(tmp_path):
    st = SegmentStore(str(tmp_path))
    segs = _segs()
    st.put("g0_w", segs, step=7)
    assert st.step("g0_w") == 7
    for lo, hi in [(0, 4), (1, 3), (2, 2), (3, 4)]:
        out = st.read_rows("g0_w", lo, hi)
        for k, arr in segs.items():
            assert _same(out[k], arr[lo:hi]), (k, lo, hi)
        into = {k: torch.empty_like(arr[lo:hi]) for k, arr in segs.items()}
        st.read_rows_into("g0_w", lo, hi, into)
        for k, arr in segs.items():
            assert _same(into[k], arr[lo:hi]), (k, lo, hi)


def test_store_put_is_atomic_over_existing(tmp_path):
    """A re-put replaces the segment atomically; a stale staging directory
    left by a crashed writer never shadows the committed data."""
    st = SegmentStore(str(tmp_path))
    st.put("g0_w", _segs(seed=1), step=1)
    new = _segs(seed=2)
    st.put("g0_w", new, step=2)
    os.makedirs(str(tmp_path / (tierstore._TMP + "g0_w.999")))
    fresh = SegmentStore(str(tmp_path))
    assert fresh.step("g0_w") == 2
    assert _same(fresh.read_rows("g0_w", 0, 4)["float32"], new["float32"])


def test_store_open_detects_torn_write(tmp_path):
    st = SegmentStore(str(tmp_path))
    st.put("g0_w", _segs(), step=0)
    faults.corrupt_file(st.seg_path("g0_w", "float32"), mode="truncate")
    fresh = SegmentStore(str(tmp_path))
    with pytest.raises(TierIntegrityError, match="no rebuilder"):
        fresh.open("g0_w")
    assert fresh.metrics["quarantined"] == 1


@pytest.mark.parametrize("into", [False, True])
def test_store_read_detects_in_place_rot(tmp_path, into):
    """A bit flipped after open is caught by the row's crc32 at the read
    that returns it, and the segment is quarantined, not lost."""
    st = SegmentStore(str(tmp_path))
    segs = _segs()
    st.put("g0_w", segs, step=0)
    st.open("g0_w")
    faults.corrupt_segment(st, "g0_w", seg="float32", seed=3)
    with pytest.raises(TierIntegrityError, match="no rebuilder"):
        if into:
            st.read_rows_into("g0_w", 0, 4, {k: torch.empty_like(v)
                                             for k, v in segs.items()})
        else:
            st.read_rows("g0_w", 0, 4)
    assert os.listdir(str(tmp_path / tierstore.QUARANTINE))


@pytest.mark.parametrize("use_mmap", [True, False])
def test_store_transient_eio_retries_then_recovers(tmp_path, use_mmap):
    st = SegmentStore(str(tmp_path), retries=3, backoff_s=0.001,
                      use_mmap=use_mmap)
    st.put("g0_w", _segs(), step=0)
    fault = faults.inject_io_error(st, fail_reads=2, err=errno.EIO)
    out = st.read_rows("g0_w", 0, 4)
    assert _same(out["float32"], _segs()["float32"])
    assert fault.raised == 2 and st.metrics["retries"] == 2
    key = "mmap_reads" if use_mmap else "pread_reads"
    assert st.metrics[key] == 2 and st.metrics["reads"] == 2


def test_store_persistent_eio_exhausts_budget(tmp_path):
    st = SegmentStore(str(tmp_path), retries=2, backoff_s=0.001)
    st.put("g0_w", _segs(), step=0)
    faults.inject_io_error(st, persistent=True)
    with pytest.raises(TierReadError, match="3 attempt"):
        st.read_rows("g0_w", 0, 4)


def test_store_nontransient_error_is_not_retried(tmp_path):
    st = SegmentStore(str(tmp_path), retries=5, backoff_s=0.001)
    st.put("g0_w", _segs(), step=0)
    faults.inject_io_error(st, persistent=True, err=errno.ENOSPC)
    with pytest.raises(TierReadError, match="1 attempt"):
        st.read_rows("g0_w", 0, 4)
    assert st.metrics["retries"] == 0


def test_store_rebuilder_heals_rot(tmp_path):
    st = SegmentStore(str(tmp_path))
    segs = _segs()
    st.put("g0_w", segs, step=0)
    st.open("g0_w")
    faults.corrupt_segment(st, "g0_w", seg="float32", seed=5)
    st.rebuilder = lambda key: st.put(key, segs, step=0)
    into = {k: torch.empty_like(v) for k, v in segs.items()}
    st.read_rows_into("g0_w", 0, 4, into)
    assert all(_same(into[k], segs[k]) for k in segs)
    assert st.metrics["rebuilt_segments"] == 1
    assert st.metrics["quarantined"] == 1


def test_store_reads_from_many_threads_lose_no_count(tmp_path):
    """The chain's read ring reads one store from several threads: with
    more threads than cores and a short switch interval, every read is
    counted and every row is right."""
    import sys
    import threading
    st = SegmentStore(str(tmp_path))
    segs = _segs(n=8, w=64)
    st.put("g0_w", segs, step=0)
    n_threads, per = 2 * (os.cpu_count() or 1) + 2, 20
    bad = []

    def reader(i):
        for j in range(per):
            lo = (i + j) % 8
            out = {k: torch.empty_like(v[lo:lo + 1]) for k, v in segs.items()}
            st.read_rows_into("g0_w", lo, lo + 1, out)
            if not all(_same(out[k], segs[k][lo:lo + 1]) for k in segs):
                bad.append((i, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not bad
    assert st.metrics["reads"] == n_threads * per * len(segs)
    assert st.metrics["mmap_reads"] == st.metrics["reads"]


# ===========================================================================
# The on-disk format, both ways
# ===========================================================================
def test_port_segments_open_in_the_reference(tmp_path):
    from repro.core.tierstore import SegmentStore as RefStore
    SegmentStore(str(tmp_path)).put("g0_w", _segs(n=5), step=3)
    ref = RefStore(str(tmp_path))
    assert ref._verify_open("g0_w") is not None and ref.step("g0_w") == 3
    got = ref.read_rows("g0_w", 1, 5)
    for k, arr in _segs(n=5).items():
        assert str(got[k].dtype) == k
        assert np.asarray(got[k]).tobytes() == _bits(arr[1:5]).tobytes()


def test_reference_segments_open_in_the_port(tmp_path):
    import ml_dtypes
    from repro.core.tierstore import SegmentStore as RefStore
    rs = np.random.RandomState(1)
    segs = {"float32": rs.randn(4, 7).astype(np.float32),
            "bfloat16": rs.randn(4, 5).astype(ml_dtypes.bfloat16)}
    RefStore(str(tmp_path)).put("g0_opt", segs, step=2)
    st = SegmentStore(str(tmp_path))
    assert st._verify_open("g0_opt") is not None and st.step("g0_opt") == 2
    got = st.read_rows("g0_opt", 0, 4)
    assert got["bfloat16"].dtype == torch.bfloat16
    for k, arr in segs.items():
        assert _bits(got[k]).tobytes() == arr.tobytes()


# ===========================================================================
# Demotion plan, the watchdog, the chunk schedule
# ===========================================================================
def test_demote_plan_budget_edges():
    assert demote_plan([10, 10], [4, 4], 0) == [0, 0]
    assert demote_plan([10, 10], [4, 4], 1000) == [4, 4]
    assert demote_plan([10, 10], [4, 4], 45) == [4, 0]
    assert demote_plan([10, 10], [4, 4], 55) == [4, 1]
    assert demote_plan([10, 10], [4, 4], 25) == [2, 0]
    for budget in range(0, 90, 7):
        hot = demote_plan([8, 12], [5, 3], budget)
        resident = 8 * hot[0] + 12 * hot[1]
        assert resident <= max(budget, 0)
        if budget > 0 and hot != [5, 3]:
            gi = 1 if hot[1] < 3 else 0
            assert resident + [8, 12][gi] > budget


def test_ring_depth_watchdog_and_stop_bounds():
    from repro.core.relay import stop_bounds as ref_bounds
    assert ring_depth(4, 10, 1000, True) == 4
    assert ring_depth(4, 10, 25, True) == 2
    assert ring_depth(4, 10, 0, True) == 1
    assert ring_depth(4, 10, 0, False) == 4
    assert ring_depth(0, 10, 5, True) == 1
    for n, g, start in [(5, 2, 0), (5, 2, 3), (4, 4, 1), (1, 3, 0),
                        (0, 1, 2)]:
        assert relay.stop_bounds(n, g, start=start) == \
            ref_bounds(n, g, start=start)


# ===========================================================================
# The chain: tiers=3 bit for bit the port's tiers=2
# ===========================================================================
# (G, prefetch, pack, K, budget): the reference's grid; ~1.6 MB of weights
# and Adam slots a layer, so 4 MiB keeps a two-row hot prefix
GRID = [(1, 0, False, 1, 0), (3, 2, True, 1, 0), (2, 1, False, 2, 0),
        (3, 0, True, 2, 0), (1, 2, True, 1, 4 << 20),
        (2, 0, False, 1, 4 << 20)]


@pytest.mark.parametrize("name", ["l2l", "l2l-p"])
def test_tier_chain_bit_identical_across_grid(name, tmp_path):
    """Loss, the gradients of the state after 2 steps, the params and the
    Adam slots through the disk tier equal the port's two-tier run bit
    for bit at every grid point, fully streamed and with a hot prefix."""
    cfg = _cfg()
    batch = _batch(cfg)
    ref_eng = _engine(name, cfg, ExecutionConfig(n_microbatches=2))
    loss, state = _run(ref_eng, batch)
    want = _leaves(state, ref_eng)
    want_g = tree_leaves(bridge.params_to_numpy(
        ref_eng.grads(state, batch)[1]))
    for G, k, pk, K, budget in GRID:
        tag = f"{name} G={G} k={k} pack={pk} K={K} budget={budget}"
        eng = _engine(name, cfg, _tier_exec(tmp_path / tag.replace(" ", "_"),
                                            G=G, k=k, pk=pk, K=K,
                                            budget=budget))
        got_loss, got = _run(eng, batch)
        m = eng.tier.metrics
        assert m["demoted_layers"] > 0, tag
        if budget:
            assert m["demoted_layers"] < cfg.n_layers, tag
        assert all(tierstore.is_demoted(g) for g in got.params["groups"])
        assert got_loss == loss, tag
        grads = tree_leaves(bridge.params_to_numpy(eng.grads(got, batch)[1]))
        _assert_bitwise(grads, want_g, f"{tag} grads")
        _assert_bitwise(_leaves(got, eng), want, f"{tag} state")


def test_tier_baseline_and_host_optimizer_bitwise(tmp_path):
    """The baseline engine (which takes tiers=3, as the reference's does)
    and the host optimizer, each against its own two-tier run."""
    cfg = _cfg(n_layers=3)
    batch = _batch(cfg)
    for name, kw in (("baseline", {}), ("l2l-p", dict(host_optimizer=True,
                                                      pack_params=True))):
        ref_eng = _engine(name, cfg, ExecutionConfig(n_microbatches=2, **kw))
        loss, state = _run(ref_eng, batch)
        eng = _engine(name, cfg, ExecutionConfig(
            n_microbatches=2, tiers=3, tier_dir=str(tmp_path / name), **kw))
        got_loss, got = _run(eng, batch)
        assert eng.tier.metrics["demoted_layers"] == 3
        assert got_loss == loss, name
        _assert_bitwise(_leaves(got, eng), _leaves(state, ref_eng), name)


def test_tier_chain_bit_identical_with_forced_retry(tmp_path):
    """A transient EIO burst on the second step's stage-in is absorbed."""
    cfg = _cfg()
    batch = _batch(cfg)
    ref_eng = _engine("l2l-p", cfg, ExecutionConfig(n_microbatches=2))
    loss, ref = _run(ref_eng, batch)
    eng = _engine("l2l-p", cfg, _tier_exec(tmp_path, G=2, k=1, pk=True))

    def hook(i, eng, state):
        if i == 1:
            faults.inject_io_error(eng.tier.store, fail_reads=2)

    got_loss, got = _run(eng, batch, hook=hook)
    assert eng.tier.metrics["retries"] >= 2
    assert got_loss == loss
    _assert_bitwise(_leaves(got, eng), _leaves(ref, ref_eng), "retry")


def test_tier_chain_quarantine_rebuild_mid_loop(tmp_path):
    """Rot between steps is quarantined and rebuilt from the newest good
    checkpoint without aborting the step loop; the final state still
    equals the two-tier run's bit for bit."""
    cfg = _cfg(n_layers=3)
    batch = _batch(cfg)
    ref_eng = _engine("l2l-p", cfg, ExecutionConfig(n_microbatches=2))
    loss, ref = _run(ref_eng, batch, n=3)
    ckpt = str(tmp_path / "ckpt")
    eng = _engine("l2l-p", cfg, _tier_exec(tmp_path / "store", pk=True,
                                           budget=1))

    def hook(i, eng, state):
        eng.save(ckpt, state)               # a step-matched rebuild source
        if i == 2:
            faults.corrupt_segment(eng.tier.store, "g0_opt", seed=11)

    got_loss, got = _run(eng, batch, n=3, hook=hook)
    m = eng.tier.metrics
    assert m["rebuilt_segments"] >= 1 and m["quarantined"] >= 1
    assert got_loss == loss
    _assert_bitwise(_leaves(got, eng), _leaves(ref, ref_eng), "rebuild")


def test_tier_open_time_rebuild_from_checkpoint(tmp_path):
    """Weight rot that outlives the process is caught at a fresh store's
    open and rebuilt from the checkpoint: the rotten bytes are never
    served."""
    cfg = _cfg(n_layers=3)
    batch = _batch(cfg)
    ckpt = str(tmp_path / "ckpt")
    eng = _engine("l2l-p", cfg, _tier_exec(tmp_path / "store"))
    state = eng.init(torch.Generator().manual_seed(0))
    state, _ = eng.train_step(state, batch)
    eng.save(ckpt, state)
    good = eng.tier.store.read_rows("g0_w", 0, 3)
    faults.corrupt_file(eng.tier.store.seg_path("g0_w", "float32"), seed=7)

    store2 = SegmentStore(str(tmp_path / "store"))
    chain2 = tierstore.TierChain(store2)
    chain2._step = int(state.step)
    chain2.attach_checkpoints(ckpt, "ckpt", eng)
    store2.open("g0_w")
    assert store2.metrics["rebuilt_segments"] == 1
    assert _same(store2.read_rows("g0_w", 0, 3)["float32"], good["float32"])


def test_tier_inference_bit_identical(tmp_path):
    """prefill, decode_init and decode_step read the demoted rows back
    read-only (once per staged-out state) and equal the two-tier engine
    bit for bit; a continuous-batching session too."""
    cfg = _cfg(n_layers=3, arch="granite-3-8b")
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 8)).astype(np.int64))
    outs = {}
    for tiers in (2, 3):
        eng = _engine("l2l", cfg, _tier_exec(tmp_path / str(tiers), G=2, k=1,
                                             pk=True, tiers=tiers,
                                             budget=tiers - 2))
        if tiers == 3:         # counts the reads of the weights' segments
            w_reads = faults.inject_io_latency(eng.tier.store, delay_s=0.0,
                                               match="g0_w")
        state = eng.init(torch.Generator().manual_seed(0))
        logits = eng.prefill(state, {"tokens": _batch(cfg)["tokens"]})
        caches, last = eng.decode_init(state, toks, live_seq=16)
        step_logits, _ = eng.decode_step(
            state, caches, last.argmax(-1)[:, None], 8)
        srv = eng.serve_session(state, max_batch=2, page_size=4, max_seq=16,
                                n_pages=8, prefill_chunk=4)
        for row in toks.tolist():
            srv.submit(row, max_new=3)
        done = sorted((r.rid, tuple(r.generated)) for r in srv.run())
        outs[tiers] = (logits, last, step_logits, done)
        if tiers == 3:
            m = eng.tier.metrics
            # the weights' 3 demoted rows were read once, in 2 chunks of
            # G = 2 rows, and every call shared them
            assert m["demoted_layers"] == 3 and w_reads.delayed == 2
    for a, b in zip(outs[2][:3], outs[3][:3]):
        assert torch.equal(a, b)
    assert outs[2][3] == outs[3][3]


def test_tier_checkpoints_interchange_with_two_tiers(tmp_path):
    """A snapshot saved by a tiers=3 engine restores into a tiers=2 one
    and the other way, bit for bit: the tier is invisible on disk."""
    cfg = _cfg(n_layers=3)
    batch = _batch(cfg)
    tier_eng = _engine("l2l-p", cfg, _tier_exec(tmp_path / "store",
                                                pk=True))
    host_eng = _engine("l2l-p", cfg, ExecutionConfig(n_microbatches=2))
    state = tier_eng.init(torch.Generator().manual_seed(0))
    state, _ = tier_eng.train_step(state, batch)
    tier_eng.save(str(tmp_path / "a"), state)
    h_state, step = host_eng.restore(str(tmp_path / "a"))
    assert step == 1
    _assert_bitwise(_leaves(h_state, host_eng), _leaves(state, tier_eng),
                    "tiers=3 -> tiers=2")

    h_state, _ = host_eng.train_step(h_state, batch)
    host_eng.save(str(tmp_path / "b"), h_state)
    t_state, step = tier_eng.restore(str(tmp_path / "b"))
    assert step == 2 and tier_eng.tier.metrics["demoted_layers"] == 3
    assert all(tierstore.is_demoted(g) for g in t_state.opt_state["groups"])
    _assert_bitwise(_leaves(t_state, tier_eng), _leaves(h_state, host_eng),
                    "tiers=2 -> tiers=3")
    # and training goes on from it as from the two-tier state
    a, _ = tier_eng.train_step(t_state, batch)
    b, _ = host_eng.train_step(h_state, batch)
    _assert_bitwise(_leaves(a, tier_eng), _leaves(b, host_eng), "resumed")


def test_tier_budget_demotes_under_latency(tmp_path):
    """An over-subscribed budget demotes the coldest rows instead of
    holding them; latency on every disk read changes no bit.  The memory
    model plans the same demotion (``demote_plan``)."""
    cfg = _cfg(n_layers=4)
    batch = _batch(cfg)
    eng = _engine("l2l-p", cfg, _tier_exec(tmp_path / "t", k=1,
                                           budget=2 << 20))
    ref_eng = _engine("l2l-p", cfg, ExecutionConfig(n_microbatches=2))
    fault = faults.inject_io_latency(eng.tier.store, delay_s=0.002,
                                     jitter_s=0.001, seed=4)
    _, got = _run(eng, batch)
    _, want = _run(ref_eng, batch)
    m = eng.tier.metrics
    assert 0 < m["demoted_layers"] < 4 and m["reads"] > 0
    assert fault.delayed > 0
    _assert_bitwise(_leaves(got, eng), _leaves(want, ref_eng), "budget")
    rep = eng.memory_estimate(batch=4, seq=16)
    assert rep.demoted_layers == m["demoted_layers"]


def test_tier_async_stage_in_under_forced_latency(tmp_path):
    """Each stage-in starts the loads of its groups on the background lane
    at its top, so each group finds its load under way (hits, no misses)
    with latency on every read, and every bit equals a synchronous (depth
    0) tier run."""
    cfg = _cfg(n_layers=3)
    batch = _batch(cfg)
    eng = _engine("l2l-p", cfg, _tier_exec(tmp_path / "async", k=1))
    ref = _engine("l2l-p", cfg, _tier_exec(tmp_path / "sync"))
    fault = faults.inject_io_latency(eng.tier.store, delay_s=0.003,
                                     jitter_s=0.002, seed=11)
    _, s_a = _run(eng, batch, n=3)
    _, s_r = _run(ref, batch, n=3)
    m = eng.tier.metrics
    assert fault.delayed > 0
    assert m["async_stage_hits"] > 0 and m["async_stage_misses"] == 0
    assert ref.tier.metrics["async_stage_hits"] == 0
    _assert_bitwise(_leaves(s_a, eng), _leaves(s_r, ref), "async")


def test_tier_holds_only_hot_rows_between_calls(tmp_path):
    """Between calls the tier holds each demoted group's hot prefix and
    nothing more: no load in flight or done after a step, no built group
    kept.  A read-only call loads the weights alone (the optimizer slots
    stay on disk), and the next step takes those weights as built and
    loads only the slots."""
    cfg = _cfg(n_layers=4)
    batch = _batch(cfg)
    eng = _engine("l2l-p", cfg, _tier_exec(tmp_path, G=2, k=1,
                                           budget=2 << 20))
    opt_reads = faults.inject_io_latency(eng.tier.store, delay_s=0.0,
                                         match="_opt")
    state = eng.init(torch.Generator().manual_seed(0))
    for _ in range(2):
        state, _ = eng.train_step(state, batch)
        assert eng.tier._prefetched == {} and eng.tier._mat_cache is None
        for d in state.params["groups"] + state.opt_state["groups"]:
            assert tierstore.is_demoted(d) and 0 < d.hot_rows < d.n_total
            row = sum(m["shape"][1] * tierstore._itemsize(m["dtype"])
                      for m in eng.tier.store.open(
                          f"g{d.group_index}_{d.role}")["segs"].values())
            assert tierstore._nbytes(d.hot) == d.hot_rows * row, d
    before = (opt_reads.delayed, eng.tier.metrics["reads"])
    eng.grads(state, batch)
    assert opt_reads.delayed == before[0]
    assert eng.tier.metrics["reads"] > before[1]
    w_reads = eng.tier.metrics["reads"] - before[1]
    eng.train_step(state, batch)
    assert opt_reads.delayed > before[0]
    assert eng.tier.metrics["reads"] - before[1] - w_reads == \
        opt_reads.delayed - before[0]

