"""Crash-consistent checkpointing: tensor tree <-> snapshot directory (the
port's own copy of ``repro/checkpoint/io.py``, with the same on-disk
contract, so either package restores the other's snapshots).

* **One snapshot = one directory** (``ckpt_<step>/``) holding
  ``arrays.npz`` (members ``a0..aN``, one per leaf) and
  ``manifest.json``: ``version`` 2, the leaves' key paths, dtypes and
  shapes, a crc32 per stored array, ``step``, ``fingerprint`` (binds the
  snapshot to a model/optimizer layout), ``file_crc32`` (the whole
  ``arrays.npz``) and ``manifest_crc32`` (the manifest's own checksum over
  ``json.dumps(..., sort_keys=True)`` of every other field).
* **Key paths** are joined with ``/`` in the order JAX's
  ``tree_flatten_with_path`` gives: dicts in sorted key order, tuples and
  lists by index, ``None`` subtrees skipped
  (``core.tree.tree_leaves_with_path``).
* **bfloat16** leaves are stored as their bits in a ``uint16`` array with
  the manifest dtype ``"bfloat16"``, as the reference stores ml_dtypes
  leaves (it re-views only an unsigned member as bf16).
* **Stored, not deflated**: the members are written with ``np.savez``
  (ZIP_STORED), not ``savez_compressed``.  Deflating random f32 weights
  saves about 7% at about 16.5 MB/s on one CPU core (12.1 s for 200 MB of
  N(0, 0.02) f32), which would make a snapshot of bert-large's 4.4 GB of
  params and Adam slots take minutes.  ``np.load`` reads both kinds, so
  the reference reads these snapshots and this module reads its.
* **Write-to-temp + fsync + atomic rename**: staged in a ``.tmp-*``
  sibling, every file fsynced, renamed into place, the parent fsynced.  A
  crash at any point leaves the previous snapshots plus ignorable debris,
  or the whole new snapshot — never a half-written one under its name.
* **Verification** (``verify``): the whole-file crc32 (read in chunks,
  so a multi-GB snapshot is never held whole), every array's shape and
  crc32, the manifest's self-checksum and the fingerprint; the byte pass
  is memoized on both files' mtime and size.  ``latest_good`` walks the
  snapshots newest first and returns the first that verifies, so a
  corrupt or partial newest snapshot falls back to the previous one.
* **Retention**: ``prune`` keeps the newest N and sweeps ``.tmp-*``.

The caller gives host-readable leaves: CPU tensors (pinned rows only
after ``torch.cuda.synchronize()``: kernels write them), numpy arrays or
scalars.  ``restore`` returns CPU tensors in the dtypes of ``like``
(tensors or ``device="meta"`` tensors: shapes and dtypes only).
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves_with_path, tree_unflatten_like

ARRAYS = "arrays.npz"
MANIFEST = "manifest.json"
_TMP = ".tmp-"
_CHUNK = 16 << 20


def _to_numpy(leaf):
    """(stored array, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1))


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _manifest_crc(manifest: dict) -> int:
    """Self-checksum over every manifest field but itself (canonical
    serialization, so load-recompute matches save-compute)."""
    payload = {k: v for k, v in manifest.items() if k != "manifest_crc32"}
    return zlib.crc32(json.dumps(payload, sort_keys=True).encode())


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # makes the rename (the commit point) durable; some filesystems refuse
    # a directory fsync: best effort there
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(path: str, tree: Any, step: Optional[int] = None,
         fingerprint: Optional[str] = None) -> str:
    """Atomically write ``tree`` as the snapshot directory ``path``;
    returns ``path``."""
    path = path.rstrip("/")
    arrays = {}
    manifest = {"version": 2, "keys": [], "dtypes": [], "shapes": [],
                "crc32": [], "step": step, "fingerprint": fingerprint}
    for i, (key, leaf) in enumerate(tree_leaves_with_path(tree)):
        arr, dtype = _to_numpy(leaf)
        arrays[f"a{i}"] = arr
        manifest["keys"].append(key)
        manifest["dtypes"].append(dtype)
        manifest["shapes"].append(list(arr.shape))
        manifest["crc32"].append(_crc(arr))

    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, _TMP + os.path.basename(path) +
                       f".{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        np.savez(os.path.join(tmp, ARRAYS), **arrays)
        _fsync_file(os.path.join(tmp, ARRAYS))
        # per-array checksums cannot see damage to the zip container's own
        # bytes; the whole-file checksum can
        manifest["file_crc32"] = _file_crc(os.path.join(tmp, ARRAYS))
        manifest["manifest_crc32"] = _manifest_crc(manifest)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(path):        # an overwrite is atomic too
            shutil.rmtree(path)
        os.rename(tmp, path)            # the commit point
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def read_manifest(path: str) -> Optional[dict]:
    """The snapshot's manifest, or None when absent or unparseable."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# The byte pass's verdicts, keyed by both files' (mtime_ns, size): damage
# to arrays.npz in place leaves the manifest untouched, so a key without
# the arrays file would vouch for rotten bytes.  The cheap structural
# checks (manifest self-checksum, fingerprint) are not cached.
_VERIFY_CACHE: dict = {}
_VERIFY_CACHE_MAX = 256


def _verify_cache_key(path: str):
    try:
        man = os.stat(os.path.join(path, MANIFEST))
        arr = os.stat(os.path.join(path, ARRAYS))
    except OSError:
        return None
    return (os.path.abspath(path), man.st_mtime_ns, man.st_size,
            arr.st_mtime_ns, arr.st_size)


def _verify_bytes(path: str, manifest: dict) -> bool:
    """The whole-file crc32 and every array's shape and crc32."""
    try:
        if _file_crc(os.path.join(path, ARRAYS)) != manifest.get("file_crc32"):
            return False
        with np.load(os.path.join(path, ARRAYS)) as data:
            if len(data.files) != len(manifest["keys"]):
                return False
            for i, (crc, shape) in enumerate(zip(manifest["crc32"],
                                                 manifest["shapes"])):
                arr = data[f"a{i}"]
                if list(arr.shape) != list(shape) or _crc(arr) != crc:
                    return False
    except Exception:
        # a truncated zip, flipped bits, a missing file: corrupt either way
        return False
    return True


def verify(path: str, fingerprint: Optional[str] = None) -> bool:
    """True iff the snapshot at ``path`` is complete and uncorrupted and
    (when both sides carry one) its fingerprint is the caller's."""
    manifest = read_manifest(path)
    if manifest is None or "crc32" not in manifest:
        return False
    if manifest.get("manifest_crc32") != _manifest_crc(manifest):
        return False
    if (fingerprint is not None
            and manifest.get("fingerprint") is not None
            and manifest["fingerprint"] != fingerprint):
        return False
    key = _verify_cache_key(path)
    if key is not None and key in _VERIFY_CACHE:
        return _VERIFY_CACHE[key]
    ok = _verify_bytes(path, manifest)
    if key is not None:
        if len(_VERIFY_CACHE) >= _VERIFY_CACHE_MAX:
            _VERIFY_CACHE.clear()
        _VERIFY_CACHE[key] = ok
    return ok


def _to_tensor(arr: np.ndarray, saved_dtype: str) -> torch.Tensor:
    if saved_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like: Any, check: bool = True,
            fingerprint: Optional[str] = None) -> Any:
    """The snapshot in the structure of ``like`` (tensors, or ``meta``
    tensors), as CPU tensors in its leaves' dtypes; verified first unless
    ``check=False``."""
    if check:
        assert verify(path, fingerprint=fingerprint), \
            f"checkpoint {path} failed integrity verification " \
            f"(truncated, bit-flipped, or fingerprint mismatch)"
    manifest = read_manifest(path)
    assert manifest is not None, f"no manifest in {path}"
    leaves = tree_leaves_with_path(like)
    assert len(leaves) == len(manifest["keys"]), \
        f"checkpoint has {len(manifest['keys'])} leaves, " \
        f"structure needs {len(leaves)}"
    out = []
    with np.load(os.path.join(path, ARRAYS)) as data:
        for i, (key, ref) in enumerate(leaves):
            assert manifest["keys"][i] == key, \
                f"leaf order mismatch: {manifest['keys'][i]} vs {key}"
            t = _to_tensor(data[f"a{i}"], manifest["dtypes"][i])
            assert tuple(t.shape) == tuple(ref.shape), \
                f"{key}: shape {tuple(t.shape)} vs {tuple(ref.shape)}"
            out.append(t.to(ref.dtype))
    return tree_unflatten_like(like, out)


# ---------------------------------------------------------------------------
# Snapshot discovery and retention over a checkpoint directory
# ---------------------------------------------------------------------------
def _snapshot_steps(directory: str, prefix: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for f in os.listdir(directory):
        if f.startswith(prefix + "_") and \
                os.path.isdir(os.path.join(directory, f)):
            try:
                steps.append(int(f[len(prefix) + 1:]))
            except ValueError:
                pass
    return sorted(steps)


def snapshot_path(directory: str, step: int, prefix: str = "ckpt") -> str:
    return os.path.join(directory, f"{prefix}_{step}")


def latest_step(directory: str, prefix: str = "ckpt") -> Optional[int]:
    """Newest snapshot by step number (existence only)."""
    steps = _snapshot_steps(directory, prefix)
    return steps[-1] if steps else None


def latest_good(directory: str, prefix: str = "ckpt",
                fingerprint: Optional[str] = None) -> Optional[int]:
    """Newest snapshot that passes ``verify``; None when none does."""
    for step in reversed(_snapshot_steps(directory, prefix)):
        if verify(snapshot_path(directory, step, prefix),
                  fingerprint=fingerprint):
            return step
    return None


def prune(directory: str, keep_last: int, prefix: str = "ckpt") -> List[int]:
    """Delete all but the newest ``keep_last`` snapshots (``<= 0`` keeps
    them all) and every ``.tmp-*`` staging leftover; returns the pruned
    steps."""
    removed = []
    if os.path.isdir(directory):
        for f in os.listdir(directory):
            if f.startswith(_TMP):
                shutil.rmtree(os.path.join(directory, f),
                              ignore_errors=True)
    if keep_last <= 0:
        return removed
    for step in _snapshot_steps(directory, prefix)[:-keep_last]:
        shutil.rmtree(snapshot_path(directory, step, prefix),
                      ignore_errors=True)
        removed.append(step)
    return removed


# ---------------------------------------------------------------------------
# Train-state wrappers (what Engine.save / restore call)
# ---------------------------------------------------------------------------
def save_train_state(directory: str, params, opt_state, step: int,
                     prefix: str = "ckpt", keep_last: int = 0,
                     fingerprint: Optional[str] = None) -> str:
    path = save(snapshot_path(directory, step, prefix),
                {"params": params, "opt": opt_state}, step=step,
                fingerprint=fingerprint)
    prune(directory, keep_last, prefix)
    return path


def restore_train_state(directory: str, params_like, opt_like,
                        step: Optional[int] = None, prefix: str = "ckpt",
                        fingerprint: Optional[str] = None):
    """(params, opt, step) of the newest good snapshot (or ``step``'s)."""
    if step is None:
        step = latest_good(directory, prefix, fingerprint=fingerprint)
    assert step is not None, \
        f"no verifiable checkpoint in {directory} (prefix={prefix})"
    tree = restore(snapshot_path(directory, step, prefix),
                   {"params": params_like, "opt": opt_like},
                   fingerprint=fingerprint)
    return tree["params"], tree["opt"], step
