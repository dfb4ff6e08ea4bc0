"""PyTorch / CUDA port of the L2L system, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``core``, ``models``, ``kernels``, ``engine``,
``serve``, ``launch``) so each module's counterpart is found by its path.
It imports ``torch``, numpy and the standard library only — never JAX and
nothing of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise.  On a CUDA tensor every kernel wrapper
launches its hand-written Hopper kernel; the plain PyTorch versions run
only for CPU tensors (the CPU tests) and in ``chip_smoke.py``'s
comparisons.
"""
