"""Host-side request scheduler: admission, slot pool, page allocator (the
port's own copy of ``repro/serve/scheduler.py``; numpy only, the same
arithmetic line for line).

The serve tick has ONE shape per (max_batch, T, P); everything that
changes as requests come and go — which slots are live, where their pages
sit, what token each row eats next — is plain int32/bool tick INPUTS
assembled here in numpy.  Joining and leaving therefore never changes a
shape: a new request claims a free batch slot and a page reservation, a
finished one hands both back, and rows without an owner ride along as
padding (``pos = -1`` — masked by attention, writes dropped).

Admission is reservation-based: a request enters only if the free pool
can cover its whole worst-case footprint ``ceil(min(prompt + gen,
capacity) / page_size)`` pages, so an admitted request can never
deadlock mid-decode; physical pages are then claimed lazily, one at a
time, as its positions actually cross page boundaries.  Under a
``decode_window`` ring the logical pages recycle (``pos`` wraps mod the
window) and the per-slot footprint is capped at ``pages_per_slot``.

Prefill rides the same sweep as decode: a prefilling slot contributes up
to ``prefill_chunk`` prompt tokens as extra query rows of the tick while
decoding slots contribute their single next token — there is no separate
prefill pass, and a prompt's last chunk samples its first generated
token in the very tick that consumes it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One serve request plus its runtime bookkeeping."""
    rid: int
    prompt: np.ndarray                 # (L,) int32 token ids
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    # -- graceful degradation -------------------------------------------
    # a deadline from either clock evicts the request (pending or
    # mid-flight) and recycles its slot/pages; 0 = no deadline.
    ttl: float = 0.0                   # seconds since submit
    ttl_ticks: int = 0                 # scheduler ticks since submit

    # -- runtime (managed by the Scheduler) -----------------------------
    slot: int = -1
    n_cached: int = 0                  # tokens written into the cache
    generated: List[int] = dataclasses.field(default_factory=list)
    reserved_pages: int = 0            # reservation not yet claimed
    status: str = "queued"             # queued|active|done|evicted|rejected
    t_submit: float = 0.0
    tick_submit: int = 0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.t_done is not None and self.status == "done"

    @property
    def evicted(self) -> bool:
        return self.status == "evicted"


class TickPlan(NamedTuple):
    """Fixed-shape arrays for one tick (B = max_batch rows)."""
    tokens: np.ndarray      # (B, T) int32
    pos: np.ndarray         # (B, T) int32; -1 = padding row/slot
    table: np.ndarray       # (B, P) int32 physical page ids; -1 unmapped
    active: np.ndarray      # (B,)  bool — row owns live per-slot state
    last_idx: np.ndarray    # (B,)  int32 index in T of the last real token
    seeds: np.ndarray       # (B,)  int32 per-request PRNG seeds
    sample_pos: np.ndarray  # (B,)  int32 PRNG stream position
    temp: np.ndarray        # (B,)  float32
    top_k: np.ndarray       # (B,)  int32
    new_pages: np.ndarray   # (R,)  int32 pages claimed this tick (-1 pad)
    new_slots: np.ndarray   # (B,)  int32 slots claimed this tick (-1 pad)
    sample: np.ndarray      # (B,)  bool host-only: row emits a token
    n_tokens: int           # host-only: real tokens consumed this tick


class Scheduler:
    def __init__(self, *, max_batch: int, page_size: int, n_pages: int,
                 max_seq: int, prefill_chunk: int = 1, window: int = 0,
                 max_pending: int = 0):
        assert max_seq % page_size == 0, "page_size must divide max_seq"
        self.max_batch = max_batch
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_seq = max_seq          # logical positions per slot
        self.T = max(1, prefill_chunk)
        self.P = max_seq // page_size   # pages per slot
        self.window = window
        self.max_pending = max_pending  # 0 = unbounded admission queue
        # a slot can cross at most this many page boundaries per tick
        self._claim_cap = max_batch * (-(-self.T // page_size) + 1)

        self.pending: deque = deque()
        self.active: Dict[int, Request] = {}
        self.finished: Dict[int, Request] = {}
        self.free_slots: List[int] = list(range(max_batch - 1, -1, -1))
        self.free_pages: List[int] = list(range(n_pages - 1, -1, -1))
        self.reserved = 0               # pages promised but not claimed
        self.table = -np.ones((max_batch, self.P), np.int32)
        self._plan: Optional[TickPlan] = None
        self._new_slots: List[int] = []  # claimed since the last tick
        self._next_rid = 0
        self.n_ticks = 0
        self.n_rejected = 0             # admissions refused at submit
        self.n_evicted = 0              # deadline-expired (pending+active)
        self._evicted_now: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, seed: int = 0, now: float = 0.0,
               ttl: float = 0.0, ttl_ticks: int = 0) -> Request:
        """Queue a request.  ``ttl``/``ttl_ticks`` set a deadline
        (seconds / scheduler ticks since submit; 0 = none) after which
        the request is evicted wherever it is — still pending or
        mid-decode — and its slot/pages recycled.  When the admission
        queue is bounded (``max_pending``) and full, the request is
        REJECTED (``status == "rejected"``, counted in ``stats()``)
        instead of queued."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not self.window and len(prompt) + 1 > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds slot capacity "
                f"({self.max_seq}); use decode_window for longer contexts")
        req = Request(self._next_rid, prompt, max_new,
                      temperature=temperature, top_k=top_k, seed=seed,
                      ttl=ttl, ttl_ticks=ttl_ticks, t_submit=now,
                      tick_submit=self.n_ticks)
        self._next_rid += 1
        if self.max_pending and len(self.pending) >= self.max_pending:
            req.status = "rejected"
            req.t_done = now
            self.n_rejected += 1
            return req
        self.pending.append(req)
        # eager admission: claim a free slot right away so the pending
        # bound above only counts true overflow (the claimed slot's
        # reset rides the next tick's new_slots list)
        self._admit(now)
        return req

    def _need_pages(self, req: Request) -> int:
        total = len(req.prompt) + max(req.max_new - 1, 0)
        if not self.window:
            total = min(total, self.max_seq)
        return min(-(-total // self.page_size), self.P)

    def _admit(self, now: float) -> None:
        """FIFO admission; claimed slots accumulate in ``_new_slots``
        until the next planned tick resets them."""
        while (self.pending and self.free_slots
               and len(self.free_pages) - self.reserved
               >= self._need_pages(self.pending[0])):
            req = self.pending.popleft()
            req.slot = self.free_slots.pop()
            req.reserved_pages = self._need_pages(req)
            self.reserved += req.reserved_pages
            req.status = "active"
            self.active[req.slot] = req
            self._new_slots.append(req.slot)

    def _map_pages(self, req: Request, positions) -> List[int]:
        """Lazily claim physical pages for any unmapped logical page the
        given positions touch (ring pages are found already mapped after
        the first wrap and reused)."""
        claimed = []
        for p in positions:
            lp = (p % self.max_seq) // self.page_size
            if self.table[req.slot, lp] < 0:
                page = self.free_pages.pop()
                self.table[req.slot, lp] = page
                claimed.append(page)
                if req.reserved_pages > 0:
                    req.reserved_pages -= 1
                    self.reserved -= 1
        return claimed

    # -- graceful degradation: deadline eviction -----------------------
    def _expired(self, req: Request, now: float) -> bool:
        return ((req.ttl > 0 and now - req.t_submit >= req.ttl)
                or (req.ttl_ticks > 0
                    and self.n_ticks - req.tick_submit >= req.ttl_ticks))

    def _evict_expired(self, now: float) -> None:
        """Evict every pending or in-flight request past its deadline.
        An active eviction releases the slot and pages through the same
        path a normal finish does — the NEXT claimant of those pages
        resets them via the tick's claim-reset (``paged_kv.reset_claim``),
        so recycled pages are indistinguishable from fresh ones."""
        for req in [r for r in self.pending if self._expired(r, now)]:
            self.pending.remove(req)
            req.status = "evicted"
            req.t_done = now
            self.finished[req.rid] = req
            self.n_evicted += 1
            self._evicted_now.append(req)
        for req in [r for r in self.active.values()
                    if self._expired(r, now)]:
            self._release(req, now, status="evicted")
            self.n_evicted += 1
            self._evicted_now.append(req)

    def take_evicted(self) -> List[Request]:
        """Drain the requests evicted since the last call."""
        out, self._evicted_now = self._evicted_now, []
        return out

    # ------------------------------------------------------------------
    def plan_tick(self, now: float = 0.0) -> Optional[TickPlan]:
        """Assemble the next tick's inputs, or None when idle."""
        self.n_ticks += 1
        self._evict_expired(now)
        self._admit(now)
        # dedup: a slot claimed, evicted and re-claimed between ticks
        # appears once — one reset covers the current claimant
        new_slots_l = list(dict.fromkeys(self._new_slots))
        self._new_slots = []
        if not self.active:
            return None
        B, T = self.max_batch, self.T
        tokens = np.zeros((B, T), np.int32)
        pos = -np.ones((B, T), np.int32)
        active = np.zeros(B, bool)
        last_idx = np.zeros(B, np.int32)
        seeds = np.zeros(B, np.int32)
        sample_pos = np.zeros(B, np.int32)
        temp = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int32)
        sample = np.zeros(B, bool)
        new_pages_l: List[int] = []
        n_tokens = 0

        for slot, req in self.active.items():
            L = len(req.prompt)
            if req.n_cached < L:                        # prefill chunk
                t = min(T, L - req.n_cached)
                tokens[slot, :t] = req.prompt[req.n_cached:req.n_cached + t]
                pos[slot, :t] = np.arange(req.n_cached, req.n_cached + t)
                sample[slot] = (req.n_cached + t == L and req.max_new > 0)
            else:                                       # decode: one token
                t = 1
                tokens[slot, 0] = req.generated[-1]
                pos[slot, 0] = req.n_cached
                sample[slot] = True
            new_pages_l += self._map_pages(
                req, range(req.n_cached, req.n_cached + t))
            active[slot] = True
            last_idx[slot] = t - 1
            seeds[slot] = req.seed
            sample_pos[slot] = req.n_cached + t - 1
            temp[slot] = req.temperature
            top_k[slot] = req.top_k
            n_tokens += t

        new_pages = -np.ones(self._claim_cap, np.int32)
        new_pages[:len(new_pages_l)] = new_pages_l
        new_slots = -np.ones(B, np.int32)
        new_slots[:len(new_slots_l)] = new_slots_l
        self._plan = TickPlan(tokens, pos, self.table.copy(), active,
                              last_idx, seeds, sample_pos, temp, top_k,
                              new_pages, new_slots, sample, n_tokens)
        return self._plan

    # ------------------------------------------------------------------
    def record(self, sampled, now: float = 0.0) -> List[Request]:
        """Fold one tick's sampled tokens ((B,) int32) back into the
        request states; returns requests finished this tick."""
        plan, self._plan = self._plan, None
        assert plan is not None, "record() without a planned tick"
        done = []
        for slot, req in list(self.active.items()):
            if not plan.active[slot]:
                continue
            t = int(plan.last_idx[slot]) + 1
            req.n_cached += t
            if plan.sample[slot]:
                req.generated.append(int(sampled[slot]))
                if req.t_first is None:
                    req.t_first = now
                req.token_times.append(now)
            out_of_room = (not self.window
                           and req.n_cached >= self.max_seq)
            if len(req.generated) >= req.max_new or out_of_room:
                self._finish(req, now)
                done.append(req)
        return done

    def _release(self, req: Request, now: float, status: str):
        """Hand a request's slot and pages back to the pools (shared by
        normal completion and deadline eviction)."""
        req.t_done = now
        req.status = status
        del self.active[req.slot]
        self.free_slots.append(req.slot)
        for lp in range(self.P):
            page = int(self.table[req.slot, lp])
            if page >= 0:
                self.free_pages.append(page)
        self.table[req.slot] = -1
        self.reserved -= req.reserved_pages
        req.reserved_pages = 0
        self.finished[req.rid] = req
        req.slot = -1

    def _finish(self, req: Request, now: float):
        self._release(req, now, status="done")

    # ------------------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self.pending and not self.active

    def stats(self) -> dict:
        return {"pending": len(self.pending), "active": len(self.active),
                "finished": len(self.finished),
                "free_pages": len(self.free_pages),
                "reserved_pages": self.reserved,
                "free_slots": len(self.free_slots),
                "rejected": self.n_rejected,
                "evicted": self.n_evicted}
