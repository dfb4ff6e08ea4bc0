"""Storage-tier EPS: a verified, self-healing segment store (the port of
``repro/core/tierstore.py``).

The paper's EPS keeps the stacked layer state in host memory; this module
is the tier below it.  ``SegmentStore`` persists each layer group's packed
flat segments (``core.packing``'s ``(N, W)`` per-dtype rows, one file per
group per segment) and ``TierChain`` demotes the cold tail of the stacked
state to it under a host-byte budget, re-materializing the demoted rows
around every Engine call.

On-disk format, the reference's byte for byte: ``<root>/<key>/seg_<name>.bin``
holds the raw row-major bytes and ``<root>/<key>/manifest.json`` the
segments' dtype names (``"float32"``, ``"bfloat16"``, ...), shapes, a crc32
per row, a whole-file crc32 and the manifest's own checksum
(``checkpoint.io._manifest_crc``).  So a directory written by either
package opens and verifies in the other (tests/test_torch_tierstore.py).
bfloat16 rows are stored and read as raw 2-byte words and viewed as
``torch.bfloat16``: nothing here needs ``ml_dtypes``.

Durability and integrity, as the reference's:

* ``put`` stages the files in a ``.tmp-*`` sibling, fsyncs each, renames
  the directory into place and fsyncs the parent: a crash leaves the old
  segment or the whole new one;
* ``open`` verifies the manifest's checksum and each file's crc32;
  ``read_rows`` / ``read_rows_into`` verify every row they return;
* transient errnos (EIO, EAGAIN, EINTR, EBUSY) are retried with
  exponential backoff, up to ``retries`` times, then raise
  ``TierReadError``; others raise at once;
* a checksum failure quarantines the segment directory (moved aside,
  never overwritten) and rebuilds it through ``rebuilder`` (the newest good
  checkpoint, ``TierChain.attach_checkpoints``).

Reads go through an mmap of the segment file, ``pread`` where a map cannot
be made (``metrics["mmap_reads"]`` / ``["pread_reads"]``); ``fault_hook``
fires before every physical read on either path, so the reference's
``repro.testing.faults`` injectors work on this store unchanged.

The chain (``TierChain``) keeps, for each group with demoted rows, only
its hot row prefix in host memory (a ``Demoted`` placeholder) and writes
the cold tail ``[hot, N)`` to the store as that group's segments (the
reference writes all N rows; the tail alone is what a step must read back
and write again).  ``stage_in`` builds the full group again: a fresh
block (on CUDA pinned, a block of its own that goes back to the system
with its last view: the relay's K4 reads it in place), the hot rows
copied in and the cold rows read from the file straight into the block's
memory, in ``layers_per_relay``-row chunks with ``prefetch_depth`` reads
in flight (``ring_depth``'s watchdog shrinks that to the budget's slack).
With ``prefetch_depth >= 1`` a call starts the loads of the groups it
reads, and only those, on a one-lane pool at its top, so the next
group's reads overlap the build of this one (``async_stage_hits`` /
``_misses``); nothing is read ahead between calls, where the host holds
the hot prefixes alone.  Packing and the file round trip are lossless,
so a ``tiers=3`` run is bit for bit the ``tiers=2`` run for every (G,
prefetch, pack, K).
"""
from __future__ import annotations

import errno
import json
import os
import re
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

try:
    import mmap as _mmap
except ImportError:                                  # pragma: no cover
    _mmap = None

import numpy as np
import torch

from repro_torch.checkpoint.io import _fsync_dir, _manifest_crc
from repro_torch.core import packing
from repro_torch.core.relay import stop_bounds
from repro_torch.core.tree import tree_leaves, tree_map

MANIFEST = "manifest.json"
_TMP = ".tmp-"
QUARANTINE = "quarantine"

# errnos treated as transient (retried with backoff); anything else, and a
# retry budget spent on these, is a hard TierReadError
_TRANSIENT = {errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY}

# stored dtype name -> torch dtype; bfloat16 travels as its 2-byte words
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64}


class TierError(RuntimeError):
    """Base class for storage-tier failures."""


class TierReadError(TierError):
    """A segment read failed past the retry budget."""


class TierIntegrityError(TierError):
    """A segment failed verification and could not be rebuilt."""


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=_TORCH[name]).element_size()


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def _bytes_view(t: torch.Tensor) -> np.ndarray:
    """A contiguous CPU tensor's memory as a uint8 numpy array (no copy):
    what the store writes, and what a read fills."""
    return t.view(-1).view(torch.uint8).numpy()


def fresh_metrics() -> Dict[str, Any]:
    """The reference's counts, and seconds spent in crc32s (``crc_s``),
    in writes and fsyncs (``write_s``) and in reads (``read_s``)."""
    return {"reads": 0, "read_bytes": 0, "writes": 0, "write_bytes": 0,
            "mmap_reads": 0, "pread_reads": 0,
            "retries": 0, "rebuilt_segments": 0, "quarantined": 0,
            "prefetch_shrinks": 0, "effective_depth": 0,
            "async_stage_hits": 0, "async_stage_misses": 0,
            "crc_s": 0.0, "write_s": 0.0, "read_s": 0.0}


# ===========================================================================
# SegmentStore: one directory per key, one .bin per flat segment
# ===========================================================================
class SegmentStore:
    """Packed flat segments on disk, verified at open and on every read.

    ``key`` names one layer group's role (``g0_w``, ``g0_opt``); segment
    names are the dtype keys (weights) or ``<slot>:<dtype>`` (optimizer).
    ``rebuilder(key)`` (installed by ``TierChain.attach_checkpoints``) must
    re-``put`` a segment that failed verification, or raise.
    ``fault_hook(path, offset, length)`` is called before every physical
    read (the fault injectors' seam).  Reads may run on several threads
    (the chain's read ring): the counts and the map cache are taken under
    a lock."""

    def __init__(self, root: str, *, retries: int = 3,
                 backoff_s: float = 0.01,
                 use_mmap: Optional[bool] = None):
        self.root = root
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.rebuilder: Optional[Callable[[str], None]] = None
        self.fault_hook: Optional[Callable[[str, int, int], None]] = None
        self.use_mmap = (_mmap is not None) if use_mmap is None \
            else bool(use_mmap)
        self._mmaps: Dict[str, Any] = {}        # path -> live mmap
        self.metrics = fresh_metrics()
        self._manifests: Dict[str, dict] = {}   # verified-at-open cache
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def _add(self, **counts) -> None:
        with self._lock:
            for k, v in counts.items():
                self.metrics[k] += v

    def _crcs(self, rows) -> Tuple[List[int], int]:
        """zlib.crc32 of each row, and of the rows laid end to end."""
        t0 = time.perf_counter()
        out, whole = [], 0
        for r in rows:
            out.append(zlib.crc32(r))
            whole = zlib.crc32(r, whole)
        self._add(crc_s=time.perf_counter() - t0)
        return out, whole

    # -- paths -------------------------------------------------------------
    def key_dir(self, key: str) -> str:
        return os.path.join(self.root, _safe(key))

    def seg_path(self, key: str, seg: str) -> str:
        return os.path.join(self.key_dir(key), f"seg_{_safe(seg)}.bin")

    # -- write path --------------------------------------------------------
    def put(self, key: str, segs: Dict[str, Any], step: int) -> None:
        """Atomically (re)write one key's segments (``(N, W)`` CPU tensors
        or numpy arrays): staged, fsynced, renamed, with per-row and
        whole-file crc32s in the manifest."""
        final = self.key_dir(key)
        tmp = os.path.join(self.root, _TMP + _safe(key) + f".{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest: dict = {"version": 1, "key": key, "step": int(step),
                          "segs": {}}
        try:
            for name, arr in segs.items():
                if isinstance(arr, torch.Tensor):
                    dtype = packing.dtype_key(arr.dtype)
                    t = arr.detach().cpu().contiguous()
                    shape = list(t.shape)
                    raw = _bytes_view(t)
                else:
                    arr = np.ascontiguousarray(arr)
                    dtype, shape = str(arr.dtype), list(arr.shape)
                    raw = arr.reshape(-1).view(np.uint8)
                assert len(shape) == 2, \
                    f"segment {name!r} must be stacked (N, W), got {shape}"
                row_crcs, file_crc = self._crcs(raw.reshape(shape[0], -1))
                t0 = time.perf_counter()
                path = os.path.join(tmp, f"seg_{_safe(name)}.bin")
                with open(path, "wb") as f:
                    f.write(memoryview(raw))
                    f.flush()
                    os.fsync(f.fileno())
                manifest["segs"][name] = {
                    "dtype": dtype, "shape": shape,
                    "file": f"seg_{_safe(name)}.bin",
                    "row_crc32": row_crcs, "file_crc32": file_crc}
                self._add(writes=1, write_bytes=raw.nbytes,
                          write_s=time.perf_counter() - t0)
            manifest["manifest_crc32"] = _manifest_crc(manifest)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            self._drop_mmaps(key)              # maps hold the OLD inode
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)              # the commit point
            _fsync_dir(self.root)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._manifests[key] = manifest

    # -- verification ------------------------------------------------------
    def _read_manifest(self, key: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.key_dir(key), MANIFEST)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _verify_open(self, key: str) -> Optional[dict]:
        """The manifest's checksum and every segment file's crc32 (a torn
        or truncated file shows here, before any row is trusted)."""
        manifest = self._read_manifest(key)
        if manifest is None or "segs" not in manifest:
            return None
        if manifest.get("manifest_crc32") != _manifest_crc(manifest):
            return None
        for name, meta in manifest["segs"].items():
            try:
                with open(self.seg_path(key, name), "rb") as f:
                    crc = 0
                    while True:
                        chunk = f.read(16 << 20)
                        if not chunk:
                            break
                        crc = zlib.crc32(chunk, crc)
            except OSError:
                return None
            if crc != meta["file_crc32"]:
                return None
        return manifest

    def open(self, key: str) -> dict:
        """Verified manifest for ``key`` (cached until ``put`` or a heal);
        a failing segment is quarantined and rebuilt."""
        cached = self._manifests.get(key)
        if cached is not None:
            return cached
        manifest = self._verify_open(key)
        if manifest is None:
            self._heal(key, f"segment {key!r} failed open-time verification")
            manifest = self._verify_open(key)
            if manifest is None:
                raise TierIntegrityError(
                    f"segment {key!r} still fails verification after rebuild")
        self._manifests[key] = manifest
        return manifest

    def step(self, key: str) -> int:
        return int(self.open(key)["step"])

    # -- healing -----------------------------------------------------------
    def _heal(self, key: str, reason: str) -> None:
        """Quarantine the damaged directory and rebuild it from the
        authoritative source."""
        self._manifests.pop(key, None)
        self._drop_mmaps(key)
        kdir = self.key_dir(key)
        if os.path.isdir(kdir):
            qroot = os.path.join(self.root, QUARANTINE)
            os.makedirs(qroot, exist_ok=True)
            dest = os.path.join(
                qroot, f"{_safe(key)}.{self.metrics['quarantined']}")
            shutil.rmtree(dest, ignore_errors=True)
            os.rename(kdir, dest)
            self._add(quarantined=1)
        if self.rebuilder is None:
            raise TierIntegrityError(
                f"{reason} and no rebuilder is attached "
                f"(no checkpoint source: cannot self-heal)")
        self.rebuilder(key)
        self._add(rebuilt_segments=1)

    # -- read path ---------------------------------------------------------
    def _pread_into(self, path: str, offset: int, out: np.ndarray):
        """``pread`` of ``out.nbytes`` bytes straight into ``out``."""
        if self.fault_hook is not None:
            self.fault_hook(path, offset, out.nbytes)
        got = 0
        view = memoryview(out)
        with open(path, "rb", buffering=0) as f:
            f.seek(offset)
            while got < out.nbytes:
                n = f.readinto(view[got:])
                if not n:
                    break
                got += n
        if got != out.nbytes:
            raise OSError(errno.EIO, f"short read: {got}/{out.nbytes} at "
                                     f"{path}:{offset}")
        return out

    def _ensure_mmap(self, path: str):
        with self._lock:
            m = self._mmaps.get(path)
            if m is None:
                with open(path, "rb") as f:
                    m = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
                self._mmaps[path] = m
        return m

    def _mread(self, path: str, offset: int, length: int):
        """A span of the mapped file (no userspace buffer)."""
        if self.fault_hook is not None:
            self.fault_hook(path, offset, length)
        m = self._ensure_mmap(path)
        if offset + length > len(m):
            raise OSError(errno.EIO,
                          f"short map: {len(m)}/{offset + length} at {path}")
        return memoryview(m)[offset:offset + length]

    def _drop_mmaps(self, key: str) -> None:
        """Forget the maps under a key's directory (``put`` and ``_heal``
        rename it, so a cached map holds the old inode); a map that an
        exported view still holds is dropped without closing."""
        prefix = self.key_dir(key) + os.sep
        with self._lock:
            gone = [self._mmaps.pop(p) for p in list(self._mmaps)
                    if p.startswith(prefix)]
        for m in gone:
            try:
                m.close()
            except BufferError:
                pass

    def _retry(self, reader, path: str, offset: int, length):
        """Bounded retry with exponential backoff on transient errnos;
        others, and a spent budget, raise TierReadError."""
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                return reader(path, offset, length)
            except OSError as e:
                if e.errno not in _TRANSIENT or attempt == self.retries:
                    n = getattr(length, "nbytes", length)
                    raise TierReadError(
                        f"read of {path}:{offset}+{n} failed after "
                        f"{attempt + 1} attempt(s): {e}") from e
                self._add(retries=1)
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")

    def _mapped(self, path: str) -> bool:
        if not self.use_mmap:
            return False
        try:
            self._ensure_mmap(path)
        except (OSError, ValueError):
            return False        # no map for this file: pread the span
        return True

    def _read_span_into(self, path: str, offset: int, out: np.ndarray):
        """One span into ``out`` (uint8): copied from the map where
        available, ``readinto`` else."""
        if self._mapped(path):
            view = self._retry(self._mread, path, offset, out.nbytes)
            out[:] = np.frombuffer(view, dtype=np.uint8)
            del view
            self._add(mmap_reads=1)
        else:
            self._retry(self._pread_into, path, offset, out)
            self._add(pread_reads=1)

    def _check_rows(self, key, name, meta, data, lo, n, row_bytes,
                    healed: bool) -> bool:
        """Each row's crc32 against the manifest; on a mismatch heal the
        key (False: read again) or, after a heal, raise."""
        view = memoryview(data)
        crcs, _ = self._crcs([view[r * row_bytes:(r + 1) * row_bytes]
                              for r in range(n)])
        del view
        for r, crc in enumerate(crcs):
            if crc != meta["row_crc32"][lo + r]:
                if healed:
                    raise TierIntegrityError(
                        f"segment {key}/{name} row {lo + r} still corrupt "
                        f"after rebuild")
                self._heal(key, f"segment {key}/{name} row {lo + r} failed "
                                f"its crc32 at read time")
                return False
        return True

    def read_rows(self, key: str, lo: int,
                  hi: int) -> Dict[str, torch.Tensor]:
        """Rows ``[lo, hi)`` of every segment of ``key`` as new CPU tensors
        of the stored dtype (``read_rows_into``)."""
        out = {name: torch.empty((hi - lo, meta["shape"][1]),
                                 dtype=_TORCH[meta["dtype"]])
               for name, meta in self.open(key)["segs"].items()}
        self.read_rows_into(key, lo, hi, out)
        return out

    def read_rows_into(self, key: str, lo: int, hi: int,
                       out: Dict[str, torch.Tensor], *,
                       _healed: bool = False) -> None:
        """Rows ``[lo, hi)`` of every segment of ``key`` read straight into
        ``out[name]`` (contiguous ``(hi - lo, W)`` CPU tensors, pinned or
        not, of the stored dtype), one span a segment, each row's crc32
        verified before it is trusted.  A checksum failure quarantines and
        rebuilds the segment and reads once more."""
        manifest = self.open(key)
        for name, meta in manifest["segs"].items():
            n, w = meta["shape"]
            assert 0 <= lo <= hi <= n, f"rows [{lo}, {hi}) out of (0, {n})"
            dst = out[name]
            assert dst.dtype == _TORCH[meta["dtype"]] and \
                tuple(dst.shape) == (hi - lo, w) and dst.is_contiguous(), \
                (name, tuple(dst.shape), dst.dtype)
            if hi == lo:
                continue
            row_bytes = w * _itemsize(meta["dtype"])
            raw = _bytes_view(dst)
            t0 = time.perf_counter()
            self._read_span_into(self.seg_path(key, name), lo * row_bytes,
                                 raw)
            self._add(reads=1, read_bytes=raw.nbytes,
                      read_s=time.perf_counter() - t0)
            if not self._check_rows(key, name, meta, raw, lo, hi - lo,
                                    row_bytes, _healed):
                return self.read_rows_into(key, lo, hi, out, _healed=True)


# ===========================================================================
# Demotion planning (shared with core.memory_model's tier accounting)
# ===========================================================================
def demote_plan(per_layer_bytes: List[int], n_layers: List[int],
                host_budget: int) -> List[int]:
    """Hot (host-resident) row count per group under ``host_budget``.

    Rows are demoted coldest-first: last group's last rows first, walking
    toward group 0, until the resident stacked state fits the budget.
    ``host_budget <= 0`` demotes everything (the fully-streamed mode); a
    budget larger than the total demotes nothing.  ``TierChain`` executes
    this plan and ``memory_model.estimate`` accounts it."""
    assert len(per_layer_bytes) == len(n_layers)
    if host_budget <= 0:
        return [0] * len(n_layers)
    hot = list(n_layers)
    resident = sum(b * n for b, n in zip(per_layer_bytes, n_layers))
    for gi in range(len(n_layers) - 1, -1, -1):
        if resident <= host_budget:
            break
        over = resident - host_budget
        drop = min(hot[gi], -(-over // max(per_layer_bytes[gi], 1)))
        hot[gi] -= drop
        resident -= drop * per_layer_bytes[gi]
    return hot


def ring_depth(prefetch_depth: int, chunk_bytes: int, slack: int,
               bounded: bool) -> int:
    """Effective read-ahead depth of the disk prefetch ring: the
    configured ``prefetch_depth``, shrunk so the in-flight chunks fit the
    host-budget ``slack`` when the budget is ``bounded`` (never below 1
    in-flight read)."""
    k = max(1, int(prefetch_depth))
    if not bounded or chunk_bytes <= 0:
        return k
    return max(1, min(k, slack // chunk_bytes))


# ===========================================================================
# Demoted placeholder: what a staged-out group looks like between calls
# ===========================================================================
class Demoted:
    """A layer group (weights or optimizer slots) whose cold row tail
    lives on disk.  ``hot`` holds the ``hot_rows`` resident rows as the
    group's segments (``{name: (hot_rows, W)}``, the store's names), or
    None.  A plain class: the ``core.tree`` helpers see it as a leaf, and
    every Engine entry point re-materializes it before a relay or a
    checkpoint could meet it."""
    __slots__ = ("hot", "group_index", "role", "n_total", "hot_rows")

    def __init__(self, hot: Any, group_index: int, role: str,
                 n_total: int, hot_rows: int):
        self.hot = hot
        self.group_index = group_index
        self.role = role
        self.n_total = n_total
        self.hot_rows = hot_rows

    def __repr__(self):
        return (f"Demoted(g{self.group_index}_{self.role}, "
                f"{self.hot_rows}/{self.n_total} rows hot)")


def is_demoted(x) -> bool:
    return isinstance(x, Demoted)


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree))


# ===========================================================================
# TierChain: HBM <- pinned host <- SegmentStore, around each Engine call
# ===========================================================================
class TierChain:
    """Demote and re-materialize the stacked EPS state through a
    ``SegmentStore``.  Between Engine calls the cold row tail of each layer
    group (weights and optimizer slots) lives only in the store and the
    hot prefix in pageable host memory; ``stage_in`` reads the tail back
    before a call and ``stage_out`` writes it after one.  ``pin``: build
    re-materialized groups in pinned host memory of their own
    (``kernels.host_alloc``, on CUDA, where K4 reads them in place), which
    goes back to the system when the call drops them, not into PyTorch's
    pinned cache.

    ``metrics`` adds to the store's counts ``demoted_layers``,
    ``resident_bytes`` and seconds: ``stage_in_s`` (the caller's wait for
    the demoted rows), ``stage_out_s`` (writing them back), ``load_s``
    (re-materializing them, on the background lane with ``prefetch_depth
    >= 1``) and ``pin_s`` (allocating the blocks)."""

    def __init__(self, store: SegmentStore, *, host_budget: int = 0,
                 layers_per_relay: int = 1, prefetch_depth: int = 0,
                 pin: bool = False):
        self.store = store
        self.host_budget = int(host_budget)
        self.group = max(1, int(layers_per_relay))
        self.depth = max(0, int(prefetch_depth))
        self.pin = bool(pin)
        self._wspecs: Dict[int, packing.PackSpec] = {}
        self._packed_groups = False
        self._hot: Dict[int, int] = {}
        self._step = 0
        self._ckpt: Optional[Tuple[str, str, Any]] = None  # (dir, prefix, eng)
        self._mat_cache: Optional[Tuple[Any, Any]] = None
        self._demoted_layers = 0
        self._resident_bytes = 0
        self.times = {"stage_in_s": 0.0, "stage_out_s": 0.0, "load_s": 0.0,
                      "pin_s": 0.0}
        self._lock = threading.Lock()       # times: main and stage threads
        self._async_pool: Optional[ThreadPoolExecutor] = None
        self._prefetched: Dict[Tuple[str, int], Any] = {}

    # -- metrics ------------------------------------------------------------
    @property
    def metrics(self) -> Dict[str, Any]:
        return {**self.store.metrics,
                "demoted_layers": self._demoted_layers,
                "resident_bytes": self._resident_bytes, **self.times}

    def _time(self, key: str, t0: float) -> None:
        with self._lock:
            self.times[key] += time.perf_counter() - t0

    # -- host memory ----------------------------------------------------------
    def _sync(self) -> None:
        # pinned rows are written by kernels the host allocator does not
        # see: wait for the card before the host reads them
        if self.pin and torch.cuda.is_available():
            torch.cuda.synchronize()

    def _empty(self, shape, dtype) -> torch.Tensor:
        t0 = time.perf_counter()
        if self.pin:
            from repro_torch.core.eps import pinned_empty
            out = pinned_empty(shape, dtype, owned=True)
        else:
            out = torch.empty(shape, dtype=dtype)
        self._time("pin_s", t0)
        return out

    def _host(self, tree):
        """A tree's tensors as host tensors (device ones copied down)."""
        return tree_map(lambda a: a.detach().cpu() if a.is_cuda else a,
                        tree)

    @staticmethod
    def _hot_copy(tree, hot: int):
        """Rows ``[0, hot)`` of each leaf in a block of their own, pageable
        (only the host copies them: into the next full block), or None for
        no rows; the group's own block is freed with it."""
        if hot == 0:
            return None
        return tree_map(lambda a: torch.empty(
            (hot,) + tuple(a.shape[1:]), dtype=a.dtype).copy_(a[:hot]), tree)

    # -- layout helpers ------------------------------------------------------
    @staticmethod
    def _key(gi: int, role: str) -> str:
        return f"g{gi}_{role}"

    def _group_segments(self, gi: int, group) -> Dict[str, torch.Tensor]:
        """A params group (tree or Packed) -> its ``(N, W)`` segments;
        records the PackSpec that lays the rows out."""
        if packing.is_packed(group):
            self._packed_groups = True
            self._wspecs[gi] = group.spec
            return dict(group.segs)
        packed = packing.pack(group)
        self._wspecs[gi] = packed.spec
        return dict(packed.segs)

    def _opt_segments(self, gi: int, g_opt) -> Dict[str, torch.Tensor]:
        """An opt group ({leaf: {m, v}} or {slot: Packed}) -> segments
        named ``<slot>:<dtype>``; no slots -> {}."""
        if not packing.opt_is_packed(g_opt):
            g_opt = packing.pack_opt(self._wspecs[gi], g_opt)
        return {f"{s}:{k}": v for s, p in sorted(g_opt.items())
                for k, v in p.segs.items()}

    def _to_group(self, gi: int, role: str, segs: Dict[str, torch.Tensor]):
        """Full ``(N, W)`` segments -> the group's layout; an unpacked
        group's leaves are copied into blocks of their own (the relay
        moves contiguous ``(N, ...)`` leaves)."""
        spec = self._wspecs[gi]
        if role == "w":
            packed = packing.Packed(segs, spec)
            if self._packed_groups:
                return packed
            tree = packing.unpack(packed)
        else:
            slots: Dict[str, dict] = {}
            for name, arr in segs.items():
                slot, seg_key = name.split(":", 1)
                slots.setdefault(slot, {})[seg_key] = arr
            packed = {s: packing.Packed(d, spec)
                      for s, d in sorted(slots.items())}
            if self._packed_groups:
                return packed
            tree = packing.unpack_opt(spec, packed)
        return tree_map(lambda a: self._empty(a.shape, a.dtype).copy_(a),
                        tree)

    def _cold(self, segs: Dict[str, torch.Tensor], hot: int):
        return {k: v[hot:] for k, v in segs.items()}

    # -- adoption: write the cold tails, keep the hot prefixes ---------------
    def adopt(self, state, step: Optional[int] = None):
        """Bring a fully materialized TrainState under tier management:
        the demote plan over the budget, each demoted group's cold tail
        written to the store, its hot prefix kept in a block of its own
        (the full group is freed with the state it came from)."""
        t0 = time.perf_counter()
        self._sync()
        params, opt = state.params, state.opt_state
        self._step = int(state.step if step is None else step)
        groups = params["groups"]
        n_layers, per_layer = [], []
        for g_w, g_o in zip(groups, opt["groups"]):
            assert not (is_demoted(g_w) or is_demoted(g_o)), \
                "adopt/stage_out need a fully materialized state"
            n = int(tree_leaves(g_w)[0].shape[0])
            n_layers.append(n)
            per_layer.append((_nbytes(g_w) + _nbytes(g_o)) // max(n, 1))
        hot = demote_plan(per_layer, n_layers, self.host_budget)
        new_w, new_o = [], []
        for gi, (g_w, g_o) in enumerate(zip(groups, opt["groups"])):
            if hot[gi] >= n_layers[gi]:
                new_w.append(g_w)
                new_o.append(g_o)
                continue
            g_w, g_o = self._host(g_w), self._host(g_o)
            w_segs = self._group_segments(gi, g_w)
            o_segs = self._opt_segments(gi, g_o)
            h = hot[gi]
            self._hot[gi] = h
            self.store.put(self._key(gi, "w"), self._cold(w_segs, h),
                           self._step)
            if o_segs:
                self.store.put(self._key(gi, "opt"), self._cold(o_segs, h),
                               self._step)
            new_w.append(Demoted(self._hot_copy(w_segs, h), gi, "w",
                                 n_layers[gi], h))
            new_o.append(Demoted(self._hot_copy(o_segs, h), gi, "opt",
                                 n_layers[gi], h) if o_segs else g_o)
        self._mat_cache = None
        self._cancel_async()
        self._demoted_layers = sum(n - h for n, h in zip(n_layers, hot))
        self._resident_bytes = sum(b * h for b, h in zip(per_layer, hot))
        self._time("stage_out_s", t0)
        return state.replace(
            params={**params, "groups": tuple(new_w)},
            opt_state={**opt, "groups": tuple(new_o)})

    # -- stage in: disk -> host ----------------------------------------------
    def _fetch_cold(self, d: Demoted, out: Dict[str, torch.Tensor]) -> None:
        """Read a placeholder's cold rows into ``out[name][hot:]``, chunk
        by chunk (``layers_per_relay`` rows: the relay's own stops), up to
        the effective depth of reads in flight; the watchdog shrinks the
        depth when the budget's slack cannot hold the chunks."""
        key = self._key(d.group_index, d.role)
        manifest = self.store.open(key)
        n_cold = d.n_total - d.hot_rows
        bounds = stop_bounds(n_cold, self.group)
        row_bytes = sum(m["shape"][1] * _itemsize(m["dtype"])
                        for m in manifest["segs"].values())
        chunk_bytes = self.group * row_bytes
        slack = max(self.host_budget - (_nbytes(d.hot) if d.hot_rows else 0),
                    0)
        eff = ring_depth(self.depth, chunk_bytes, slack,
                         bounded=self.host_budget > 0)
        if self.depth >= 1 and eff < self.depth:
            self.store._add(prefetch_shrinks=1)
        self.store.metrics["effective_depth"] = eff

        def read(lo, hi):
            self.store.read_rows_into(
                key, lo, hi, {k: out[k][d.hot_rows + lo:d.hot_rows + hi]
                              for k in manifest["segs"]})

        if self.depth == 0 or len(bounds) <= 1:
            for lo, hi in bounds:
                read(lo, hi)
        else:
            with ThreadPoolExecutor(max_workers=eff) as pool:
                for f in [pool.submit(read, lo, hi) for lo, hi in bounds]:
                    f.result()

    def _load(self, d: Demoted) -> Dict[str, torch.Tensor]:
        """The full ``(N, W)`` segments of a placeholder: fresh blocks
        (pinned blocks of their own when ``pin``: no kernel can still use
        one), the hot rows copied in, the cold rows read from the store
        into the rest."""
        t0 = time.perf_counter()
        manifest = self.store.open(self._key(d.group_index, d.role))
        out = {name: self._empty((d.n_total, meta["shape"][1]),
                                 _TORCH[meta["dtype"]])
               for name, meta in manifest["segs"].items()}
        if d.hot_rows:
            for name, h in d.hot.items():
                out[name][:d.hot_rows].copy_(h)
        self._fetch_cold(d, out)
        self._time("load_s", t0)
        return out

    # -- async read-ahead: the call's own groups, started at its top -------
    def _pool(self) -> ThreadPoolExecutor:
        if self._async_pool is None:
            # one background lane: _fetch_cold runs its own ring of reads
            self._async_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tier-stage")
        return self._async_pool

    def _cancel_async(self) -> None:
        for fut in self._prefetched.values():
            fut.cancel()
        self._prefetched = {}

    def _schedule_async(self, groups) -> None:
        """Start the loads of the demoted ``groups`` that a call is about
        to read, in the order it reads them, on the background lane
        (``prefetch_depth >= 1``): while the caller builds one group the
        lane reads the next.  Called at the top of a call, never after
        one, so between calls nothing but the hot prefixes is held."""
        if self.depth < 1:
            return
        for d in groups:
            key = (self._key(d.group_index, d.role), self._step) \
                if is_demoted(d) else None
            if key and d.hot_rows < d.n_total and key not in self._prefetched:
                self._prefetched[key] = self._pool().submit(self._load, d)

    def _materialize_group(self, d: Demoted):
        fut = self._prefetched.pop(
            (self._key(d.group_index, d.role), self._step), None)
        if fut is not None:
            segs = fut.result()
            self.store._add(async_stage_hits=1)
        else:
            if self.depth >= 1:
                self.store._add(async_stage_misses=1)
            segs = self._load(d)
        return self._to_group(d.group_index, d.role, segs)

    def _materialize_groups(self, groups):
        return tuple(self._materialize_group(g) if is_demoted(g) else g
                     for g in groups)

    def materialize_params(self, params):
        """Params with every Demoted group re-materialized (read-only:
        nothing is written back; the optimizer slots are not read).
        Cached by the groups tuple's identity, so a serving loop reads the
        tier once per staged-out state."""
        groups = params["groups"]
        if not any(is_demoted(g) for g in groups):
            return params
        if self._mat_cache is not None and self._mat_cache[0] is groups:
            return self._mat_cache[1]
        t0 = time.perf_counter()
        self._schedule_async(groups)
        out = {**params, "groups": self._materialize_groups(groups)}
        self._mat_cache = (groups, out)
        self._time("stage_in_s", t0)
        return out

    def stage_in(self, state):
        """Every demoted group (weights and optimizer slots) read back:
        the disk -> host move before each step.  The weights a read-only
        call of the same state already built are taken as they are."""
        t0 = time.perf_counter()
        p_groups, opt = state.params["groups"], state.opt_state
        built = self._mat_cache is not None and self._mat_cache[0] is p_groups
        self._schedule_async(opt["groups"] if built
                             else p_groups + opt["groups"])
        params = self._mat_cache[1] if built else {
            **state.params, "groups": self._materialize_groups(p_groups)}
        o_groups = self._materialize_groups(opt["groups"])
        self._time("stage_in_s", t0)
        return state.replace(params=params,
                             opt_state={**opt, "groups": o_groups})

    # -- stage out: host -> disk ---------------------------------------------
    def stage_out(self, state):
        """Write the demoted groups' updated rows back to the store
        (verified, crash-consistent) and drop them from host memory; the
        store's step advances with the state, so a ``save`` at that step
        is a valid rebuild source.  Reads the rows after a sync: K4's
        write-backs land there."""
        return self.adopt(state)

    # -- checkpoint-backed self-healing --------------------------------------
    def attach_checkpoints(self, directory: str, prefix: str,
                           engine) -> None:
        """Install the quarantine-rebuild source: the newest good snapshot
        in ``directory``, whose step must match the store's."""
        self._ckpt = (directory, prefix, engine)
        self.store.rebuilder = self._rebuild

    def _rebuild(self, key: str) -> None:
        from repro_torch.checkpoint import io as ckpt_io
        assert self._ckpt is not None
        directory, prefix, engine = self._ckpt
        m = re.fullmatch(r"g(\d+)_(w|opt)", key)
        assert m, f"unrecognized segment key {key!r}"
        gi, role = int(m.group(1)), m.group(2)
        fp = engine.state_fingerprint()
        step = ckpt_io.latest_good(directory, prefix, fingerprint=fp)
        if step is None:
            raise TierIntegrityError(
                f"cannot rebuild {key!r}: no good checkpoint in {directory}")
        if step != self._step:
            raise TierIntegrityError(
                f"cannot rebuild {key!r}: newest good checkpoint is step "
                f"{step} but the store holds step {self._step} bytes")
        like_p, like_o = engine._snapshot_like()
        params, opt, _ = ckpt_io.restore_train_state(
            directory, like_p, like_o, step=step, prefix=prefix,
            fingerprint=fp)
        if self._packed_groups:
            params = packing.pack_params(params)
            opt = packing.pack_opt_state(opt, params)
        # weights first even for an opt rebuild: _opt_segments needs the
        # group's PackSpec, which _group_segments records
        segs = self._group_segments(gi, params["groups"][gi])
        if role != "w":
            segs = self._opt_segments(gi, opt["groups"][gi])
        self.store.put(key, self._cold(segs, self._hot.get(gi, 0)), step)
