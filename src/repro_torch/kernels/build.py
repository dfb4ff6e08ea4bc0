"""Build the CUDA C++ kernels into one shared library and load it.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so ``nvcc`` takes seconds.  Each source is compiled by its own ``nvcc``
process, all started together, then linked into
``build/libl2l_kernels_<hash>.so`` at the repository root; the hash covers
the sources, the shared header and the flags, so a changed source rebuilds
and an unchanged one is loaded as it is.  ``ptxas`` reports (registers,
spills, wgmma warnings) are kept beside the library in
``build/*.ptxas.log``; ``kernel_report`` reads them back per kernel with
the count of tensor-core (``HGMMA``) instructions in each kernel's SASS.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("relay_copy.cu", "rmsnorm.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "flash_attention_sm90.cu",
           "flash_attention_dq_sm90.cu", "flash_attention_bwd_sm90.cu")
HEADERS = ("sm90.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C entry points and their argument types (every pointer and stream is
# c_void_p: ctypes would otherwise pass a 32-bit int and cut the pointer)
SIGNATURES = {
    "rc_copy_spans": (_P, _P, ctypes.POINTER(_I64), _I32,  # src dst spans n
                      _I32, _I32, _I32, _I32, _I32, _P),
    # method tile stages blocks span stream
    "rc_host_alloc": (_I64, ctypes.c_uint, ctypes.POINTER(_P)),
    "rc_host_free": (_P,),
    "rc_host_register": (_P, _I64, ctypes.c_uint),
    "rc_host_unregister": (_P,),
    "rc_chase": (_P, _I64, _P, _P),               # chain steps out stream
    "fa_fwd": (_P, _P, _P, _P, _P,                       # q k v o lse
               _I32, _I32, _I32, _I32, _I32, _I32,       # B H Hkv Sq Sk D
               ctypes.POINTER(_I64),                     # 12 strides
               _F32, _I32, _I32, _F32, _I32, _P),        # scale causal
    # window cap bf16 stream
    "fa_bwd_dq": (_P, _P, _P, _P, _P, _P, _P,           # q k v do lse dl dq
                  _I32, _I32, _I32, _I32, _I32, _I32,   # B H Hkv Sq Sk D
                  ctypes.POINTER(_I64),                 # 21 strides
                  _F32, _I32, _I32, _I32, _P),          # scale causal
    "fa_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P,      # ... dk dv
                   _I32, _I32, _I32, _I32, _I32, _I32,
                   ctypes.POINTER(_I64),
                   _F32, _I32, _I32, _I32, _P),         # window bf16 stream
    # the bf16 wgmma kernels: the same arguments without the dtype flag
    "fa_fwd_sm90": (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                    ctypes.POINTER(_I64), _F32, _I32, _I32, _F32, _P),
    "fa_bwd_dq_sm90": (_P, _P, _P, _P, _P, _P, _P,
                       _I32, _I32, _I32, _I32, _I32, _I32,
                       ctypes.POINTER(_I64), _F32, _I32, _I32, _P),
    "fa_bwd_dkv_sm90": (_P, _P, _P, _P, _P, _P, _P, _P,
                        _I32, _I32, _I32, _I32, _I32, _I32,
                        ctypes.POINTER(_I64), _F32, _I32, _I32, _P),
    # dynamic shared memory of the wgmma kernels, by head dim
    "fa_fwd_sm90_smem": (_I32,),
    "fa_bwd_dq_sm90_smem": (_I32,),
    "fa_bwd_dkv_sm90_smem": (_I32,),
    "rmsnorm_fwd": (_P, _P, _P, _I32, _I32, _I64,  # x scale out R d xs
                    _F32, _I32, _I32, _P),      # eps x_dtype s_dtype stream
}
# a C entry point's return value from here up is ENCODE_ERROR + the CUresult
# of cuTensorMapEncodeTiled (csrc/sm90.cuh)
ENCODE_ERROR = 10000


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home})")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            procs.append((name, obj, subprocess.Popen(
                [cc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, _, p in procs:
            log = p.communicate()[0]
            (BUILD_DIR / f"{name}.ptxas.log").write_text(log)
            if p.returncode:
                failed.append(f"--- {name} ---\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / out.name
        link = subprocess.run(
            [cc, "-shared", "-o", str(so), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(so, out)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the sources changed."""
    out = BUILD_DIR / f"libl2l_kernels_{_digest()}.so"
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` (or tensor-map encoding error)
    returned by a C entry point."""
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled returned "
                           f"CUresult {err - ENCODE_ERROR}")
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _ptxas_entries(log: str) -> dict:
    """``ptxas -v`` output -> {mangled kernel: {registers, spill bytes,
    stack, warnings}}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {"warnings": []})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        if "arning" in line or "wgmma" in line:
            cur["warnings"].append(line.strip())
    return out


def _sass_counts(so: Path, opcode: str) -> dict:
    """{mangled kernel: instructions whose opcode starts with ``opcode``} in
    the library's SASS (``cuobjdump -sass``)."""
    tool = Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : ([A-Za-z0-9_]+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.search(rf"\b{opcode}", line):
            counts[cur] += 1
    return counts


# the wgmma kernels' entry points (each with a ``<entry>_smem``) and names
_SM90_KINDS = {"fa_fwd_sm90": "flash_attention_fwd",
               "fa_bwd_dq_sm90": "flash_attention_bwd_dq",
               "fa_bwd_dkv_sm90": "flash_attention_bwd_dkv"}


def kernel_report(pattern: str = "sm90") -> dict:
    """Per kernel whose mangled name contains ``pattern``: ptxas's
    registers, spill and stack bytes and warnings, the dynamic shared
    memory it launches with, and its HGMMA (wgmma) instruction count."""
    lib = library()
    so = BUILD_DIR / f"libl2l_kernels_{_digest()}.so"
    hgmma = _sass_counts(so, "HGMMA")
    report = {}
    for log in sorted(BUILD_DIR.glob("*.ptxas.log")):
        for name, info in _ptxas_entries(log.read_text()).items():
            if pattern not in name:
                continue
            d = int(re.search(r"ILi(\d+)E", name).group(1))
            kind = next(k for k in _SM90_KINDS if k in name)
            smem = getattr(lib, kind + "_smem")(d)
            report[f"{_SM90_KINDS[kind]}[D={d}]"] = {
                **info, "dynamic_smem_bytes": smem,
                "hgmma": hgmma.get(name, 0), "symbol": name}
    return report
