"""The port's own copy of the request scheduler
(``repro_torch/serve/scheduler.py``) against the reference's
(``repro/serve/scheduler.py``): the same submit / ``plan_tick`` /
``record`` sequence through both, with deadline eviction (seconds and
ticks), rejection at ``max_pending``, page exhaustion, chunked prefill
and a ``decode_window`` ring; every TickPlan array, every request's
status and tokens, and every ``stats()`` equal."""
import numpy as np
import pytest

from repro.serve.scheduler import Scheduler as JScheduler
from repro_torch.serve.scheduler import Scheduler


def _same_plan(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _req_state(r):
    return (r.rid, r.status, r.slot, r.n_cached, list(r.generated),
            r.reserved_pages, r.t_first, r.t_done)


# (scheduler knobs, submits: (tick to submit at, prompt length, max_new,
#  extra submit kwargs))
SCENARIOS = {
    # 2 slots, pages for fewer: requests wait on pages, not only slots
    "page-exhaustion": (
        dict(max_batch=2, page_size=4, n_pages=6, max_seq=16),
        [(0, 9, 4, {}), (0, 7, 5, {}), (0, 3, 2, {}), (2, 5, 3, {}),
         (3, 12, 4, {})]),
    # a bounded queue rejects; ttl in seconds and in ticks evicts pending
    # and mid-flight requests, and their slots and pages recycle
    "ttl-and-rejection": (
        dict(max_batch=2, page_size=4, n_pages=8, max_seq=16,
             max_pending=2),
        [(0, 6, 6, {}), (0, 5, 8, dict(ttl_ticks=3)), (0, 4, 3, {}),
         (0, 4, 3, dict(ttl=2.5)), (0, 3, 2, {}), (1, 5, 2, {}),
         (4, 6, 4, dict(ttl_ticks=2)), (5, 2, 3, {})]),
    # chunked prefill: prompts enter 3 tokens per tick
    "chunked-prefill": (
        dict(max_batch=3, page_size=4, n_pages=12, max_seq=16,
             prefill_chunk=3),
        [(0, 7, 3, {}), (0, 2, 4, {}), (1, 10, 2, {}), (2, 5, 0, {}),
         (2, 4, 5, {})]),
    # a decode_window ring: positions wrap, logical pages are reused
    "window-ring": (
        dict(max_batch=2, page_size=4, n_pages=6, max_seq=8, window=8,
             prefill_chunk=2),
        [(0, 5, 9, {}), (0, 3, 12, {}), (3, 6, 4, {})]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_matches_reference(name):
    knobs, submits = SCENARIOS[name]
    port, ref = Scheduler(**knobs), JScheduler(**knobs)
    reqs = []
    rng = np.random.RandomState(0)
    for tick in range(60):
        now = float(tick)
        for at, n, new, kw in submits:
            if at == tick:
                prompt = rng.randint(0, 500, size=(n,)).astype(np.int32)
                a = port.submit(prompt, new, now=now, **kw)
                b = ref.submit(prompt, new, now=now, **kw)
                assert _req_state(a) == _req_state(b)
                reqs.append((a, b))
        pa, pb = port.plan_tick(now=now), ref.plan_tick(now=now)
        _same_plan(pa, pb)
        assert [r.rid for r in port.take_evicted()] == \
            [r.rid for r in ref.take_evicted()]
        if pa is not None:
            sampled = (np.arange(knobs["max_batch"]) * 7 + tick) \
                .astype(np.int32)
            assert [r.rid for r in port.record(sampled, now=now + 0.5)] == \
                [r.rid for r in ref.record(sampled, now=now + 0.5)]
        assert port.stats() == ref.stats()
        assert port.idle == ref.idle
        for a, b in reqs:
            assert _req_state(a) == _req_state(b)
        if port.idle and tick > max(s[0] for s in submits):
            break
    assert port.idle
    st = port.stats()
    assert st["free_pages"] == knobs["n_pages"] and st["reserved_pages"] == 0
    assert st["free_slots"] == knobs["max_batch"]
    statuses = {a.status for a, _ in reqs}
    if name == "ttl-and-rejection":
        assert st["rejected"] > 0 and st["evicted"] > 0
        assert statuses == {"done", "evicted", "rejected"}
    else:
        assert statuses == {"done"}


def test_submit_refuses_a_prompt_past_capacity():
    for cls in (Scheduler, JScheduler):
        s = cls(max_batch=1, page_size=4, n_pages=4, max_seq=8)
        with pytest.raises(ValueError, match="exceeds slot capacity"):
            s.submit(np.zeros(8, np.int32), 1)
