"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Each module holds the wrapper (same signature as its ``repro.kernels``
counterpart), the plain PyTorch version (``kernels.ref``), a launch
counter on the wrapper, and a note on what bounds the kernel on an H100.
CUDA C++ sources live in ``csrc/`` and are built at first use by
``kernels.build``; Triton kernels are compiled by Triton at first launch.
"""
