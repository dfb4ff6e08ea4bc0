"""Deterministic fault injection for the port (the port of
``repro/testing/faults.py``).

Every injector is SEEDED and side-effect-explicit, so a chaos test can
reproduce a failure byte for byte; the seeded ones draw what the
reference's draw from the same seed:

* ``corrupt_file`` / ``corrupt_snapshot`` — truncate or bit-flip a
  checkpoint file at a seeded offset (a half-written snapshot on a
  filesystem without atomic rename, or disk rot in place).
* ``launch_train`` / ``kill_at_step`` — run the port's training driver
  (``repro_torch.launch.train``) as a subprocess and deliver
  SIGTERM/SIGKILL when a given step's log line appears (preemption
  mid-run, hard crash mid-run); ``run_train`` runs it to its end.
* ``poison_batch`` — place a NaN into a batch so every gradient of that
  step is non-finite (a corrupt data shard or an overflow), exercising
  ``ExecutionConfig.skip_nonfinite``.
* ``steal_pages`` / ``restore_pages`` — starve the serve page pool so
  admission blocks and pending deadlines fire.
* ``snapshot_checksums`` — a snapshot's per-array crc32 list; two
  training runs whose final snapshots share it are bit-identical.
* ``inject_io_error`` / ``inject_io_latency`` / ``corrupt_segment`` —
  the storage-tier chaos: seeded EIO/latency injectors installed into a
  ``core.tierstore.SegmentStore``'s read-path ``fault_hook`` and in-place
  segment bit rot (the quarantine-and-rebuild path).
"""
from __future__ import annotations

import errno
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as ckpt_io

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_STEP_RE = re.compile(r"^step\s+(\d+)")


# ===========================================================================
# Checkpoint corruption
# ===========================================================================
def corrupt_file(path: str, mode: str = "bitflip", seed: int = 0) -> None:
    """Corrupt one file in place.  ``bitflip`` flips a single bit at a
    seeded offset; ``truncate`` cuts the file to a seeded fraction of
    its length (a partial write)."""
    size = os.path.getsize(path)
    assert size > 0, f"cannot corrupt empty file {path}"
    rng = np.random.default_rng(seed)
    if mode == "bitflip":
        off = int(rng.integers(0, size))
        bit = int(rng.integers(0, 8))
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)[0]
            f.seek(off)
            f.write(bytes([byte ^ (1 << bit)]))
    elif mode == "truncate":
        keep = int(size * float(rng.uniform(0.2, 0.8)))
        with open(path, "r+b") as f:
            f.truncate(keep)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


def corrupt_snapshot(snapshot_dir: str, mode: str = "bitflip",
                     target: str = "arrays", seed: int = 0) -> str:
    """Corrupt a snapshot directory's ``arrays.npz`` (or its manifest);
    returns the path of the file that was damaged."""
    name = ckpt_io.ARRAYS if target == "arrays" else ckpt_io.MANIFEST
    path = os.path.join(snapshot_dir, name)
    corrupt_file(path, mode=mode, seed=seed)
    return path


def snapshot_checksums(directory: str, step: Optional[int] = None,
                       prefix: str = "ckpt") -> List[int]:
    """The per-array crc32 list of a snapshot (newest good one when
    ``step`` is None) — equality means bit-identical state on disk."""
    if step is None:
        step = ckpt_io.latest_good(directory, prefix)
        assert step is not None, f"no good snapshot in {directory}"
    manifest = ckpt_io.read_manifest(
        ckpt_io.snapshot_path(directory, step, prefix))
    assert manifest is not None
    return list(manifest["crc32"])


# ===========================================================================
# Storage-tier (SegmentStore) fault injection
# ===========================================================================
class _IOFault:
    """Install-state of one read-path injector (thread-safe: the store's
    prefetch ring issues reads from a pool).  ``raised``/``delayed``
    count the reads the injector actually touched."""

    def __init__(self):
        self.lock = threading.Lock()
        self.raised = 0
        self.delayed = 0
        self.seen = 0


def inject_io_error(store, *, fail_reads: int = 1,
                    err: int = errno.EIO, match: str = "",
                    persistent: bool = False) -> _IOFault:
    """Make the store's next ``fail_reads`` physical segment reads (those
    whose path contains ``match``) raise ``OSError(err)``.  EIO is in the
    store's transient set, so ``fail_reads <= retries`` exercises the
    backoff-retry-recover path and ``persistent=True`` (every matching
    read fails forever) the budget-exhausted hard ``TierReadError``.
    Chains with any previously installed hook; returns the counter."""
    fault = _IOFault()
    prev = store.fault_hook

    def hook(path: str, offset: int, length: int) -> None:
        if prev is not None:
            prev(path, offset, length)
        with fault.lock:
            if match not in path:
                return
            fault.seen += 1
            if persistent or fault.raised < fail_reads:
                fault.raised += 1
                raise OSError(err, f"injected {errno.errorcode.get(err)}")

    store.fault_hook = hook
    return fault


def inject_io_latency(store, *, delay_s: float, jitter_s: float = 0.0,
                      seed: int = 0, match: str = "") -> _IOFault:
    """Add ``delay_s`` (+ seeded uniform jitter up to ``jitter_s``) of
    sleep before every matching physical segment read — a congested or
    throttled NVMe.  Reads still succeed; this widens the window in
    which the prefetch ring, watchdog and retry paths interleave."""
    fault = _IOFault()
    rng = np.random.default_rng(seed)
    prev = store.fault_hook

    def hook(path: str, offset: int, length: int) -> None:
        if prev is not None:
            prev(path, offset, length)
        if match not in path:
            return
        with fault.lock:
            fault.delayed += 1
            extra = float(rng.uniform(0.0, jitter_s)) if jitter_s else 0.0
        time.sleep(delay_s + extra)

    store.fault_hook = hook
    return fault


def corrupt_segment(store, key: str, seg: Optional[str] = None,
                    seed: int = 0) -> str:
    """Bit-flip one seeded byte of a stored segment file IN PLACE (disk
    rot under the store's nose: the manifest stays intact, so the rot is
    only observable through crc verification — at open by a fresh store,
    or at the read that returns the rotten row).  ``seg`` defaults to
    the first segment name in the key's manifest; returns the damaged
    path."""
    manifest = store._read_manifest(key)
    assert manifest is not None, f"no manifest for segment key {key!r}"
    if seg is None:
        seg = sorted(manifest["segs"])[0]
    path = store.seg_path(key, seg)
    corrupt_file(path, mode="bitflip", seed=seed)
    return path


# ===========================================================================
# Training-subprocess preemption / crash
# ===========================================================================
def launch_train(argv: List[str],
                 env: Optional[dict] = None) -> subprocess.Popen:
    """Start ``repro_torch.launch.train`` with the given CLI args as a real
    subprocess (line-buffered stdout so the kill trigger sees step lines
    as they happen); ``env`` adds to the inherited environment."""
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = _SRC + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, env=env)


def kill_at_step(proc: subprocess.Popen, step: int,
                 sig: int = signal.SIGTERM,
                 timeout: float = 300.0) -> Tuple[int, str]:
    """Watch the subprocess's step log and deliver ``sig`` as soon as a
    ``step <n>`` line with n >= step appears; returns (returncode,
    full output).  SIGTERM exercises the graceful finish-save-exit
    path; SIGKILL a hard crash (the run must then resume from its last
    periodic snapshot)."""
    lines = []
    sent = False
    assert proc.stdout is not None
    for line in proc.stdout:
        lines.append(line)
        m = _STEP_RE.match(line)
        if not sent and m and int(m.group(1)) >= step:
            proc.send_signal(sig)
            sent = True
            if sig == signal.SIGKILL:
                break
    proc.stdout.close()
    rc = proc.wait(timeout=timeout)
    return rc, "".join(lines)


def run_train(argv: List[str], timeout: float = 600.0,
              env: Optional[dict] = None) -> str:
    """Run the training driver to completion; returns its output
    (raises on nonzero exit)."""
    proc = launch_train(argv, env)
    assert proc.stdout is not None
    out = proc.stdout.read()
    proc.stdout.close()
    rc = proc.wait(timeout=timeout)
    assert rc == 0, f"train exited {rc}:\n{out}"
    return out


# ===========================================================================
# NaN injection (bad data shard / numeric overflow)
# ===========================================================================
def poison_batch(batch: dict, key: str = "mask", seed: int = 0) -> dict:
    """A copy of ``batch`` with one NaN planted in a float field (the
    loss weight mask by default): the step's loss — and therefore every
    gradient the backward relay produces, whatever the (G, prefetch,
    pack, K) point — becomes non-finite, the exact signature of a
    corrupt data shard or activation overflow."""
    rng = np.random.default_rng(seed)
    out = dict(batch)
    arr = np.array(batch[key], copy=True)
    assert arr.dtype.kind == "f", f"{key} is not a float field"
    idx = tuple(int(rng.integers(0, s)) for s in arr.shape)
    arr[idx] = np.nan
    out[key] = arr
    return out


# ===========================================================================
# Serve page-pool starvation
# ===========================================================================
def steal_pages(scheduler, k: int) -> List[int]:
    """Remove ``k`` physical pages from the scheduler's free pool
    (simulating exhaustion/leak): admission of any request whose
    reservation no longer fits blocks until pages return — or until its
    deadline evicts it.  Returns the stolen page ids for
    ``restore_pages``."""
    assert k <= len(scheduler.free_pages), "cannot steal claimed pages"
    stolen = [scheduler.free_pages.pop() for _ in range(k)]
    return stolen


def restore_pages(scheduler, stolen: List[int]) -> None:
    """Hand stolen pages back (the leak healed)."""
    scheduler.free_pages.extend(stolen)
