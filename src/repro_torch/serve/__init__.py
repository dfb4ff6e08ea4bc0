"""Layer-major continuous-batching serve (the port of ``repro/serve``).

Every in-flight sequence is pushed through each layer stop of ONE
weight-relay sweep per decode tick, so the per-layer fetch from the EPS
is paid once per tick for the whole in-flight set instead of once per
request.

* ``paged_kv``  — fixed-size KV pages from a shared pool on the device,
  per-slot page tables, gather/scatter between the pool and the
  contiguous per-slot views the decode blocks consume.
* ``scheduler`` — host-side admission queue, slot pool and page
  allocator (numpy): requests join and leave mid-flight.
* ``sampling``  — greedy / temperature / top-k sampling with a seeded
  stream per request.
* ``engine``    — the tick: one ``relay_scan`` sweep per decode step for
  all active slots, exposed through the Engine facade as
  ``Engine.serve_session``.
"""
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: F401
from repro_torch.serve.scheduler import Request, Scheduler     # noqa: F401
