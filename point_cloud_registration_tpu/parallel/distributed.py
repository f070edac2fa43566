"""Multi-host runtime initialization.

The reference is single-process (SURVEY §2.3: deps are numpy + pykdtree,
no comm backend). This framework scales across hosts with the standard JAX
multi-controller runtime: every host runs the same program,
``jax.distributed.initialize`` wires the processes together, and the
existing ``shard_map`` aligners then see the global device set —
per-iteration traffic stays the ~40-float GN psum (SURVEY §5 "distributed
communication backend").

Typical entrypoint::

    from point_cloud_registration_tpu.parallel import distributed, make_mesh

    distributed.initialize("localhost:12345", num_processes=2, process_id=i)
    mesh = make_mesh(batch=jax.process_count(), data=...)
    ...

Pass the coordinator address, process count and process id explicitly
unless the cluster environment lets ``jax.distributed.initialize`` discover
them.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               **kwargs) -> None:
    """Idempotent ``jax.distributed.initialize`` wrapper.

    Safe to call when the runtime is already initialized (no-op) or
    single-process (no-op when no coordinator can be inferred).
    """
    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except (ValueError, RuntimeError):
        # single-process environment with nothing to discover: run locally
        if num_processes not in (None, 1):
            raise


def process_info() -> dict:
    """Host/device topology summary for logs and diagnostics."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": [str(d) for d in jax.local_devices()],
        "global_device_count": jax.device_count(),
    }
