"""Multi-host initialization helpers.

The solver is host-count agnostic: meshes built over all devices span
hosts automatically (NVLink within a host, the network across hosts). This module
only wraps the standard bootstrap; there is nothing NCCL/MPI-like to port
from the reference (it is single-device; SURVEY.md 2.8).

Typical multi-host usage::

    from totsu_tpu.parallel import multihost, make_mesh, solve_batch
    multihost.init("10.0.0.1:1234", num_processes=2, process_id=rank)
    mesh = make_mesh(batch=jax.device_count() // 2, row=2)
    res = solve_batch(c, a, b, cone, param, mesh=mesh)

Each process feeds its local shard of the batch (use
``jax.make_array_from_process_local_data`` for host-sharded inputs).

Exercised for real (not just as a wrapper) by tests/test_multihost.py: a
2-process jax.distributed job over gloo CPU collectives, 4 virtual
devices per process, batch-sharded lockstep solve on the 8-device global
mesh with exact per-shard parity against a single-device reference.
"""

from typing import Optional


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed (no-op if already initialized).

    On GPU clusters pass all three arguments: ``coordinator_address`` as
    ``host:port`` of process 0, the process count, and this process's
    rank. Left at None, JAX falls back to its own cluster auto-detection
    (SLURM, Open MPI, ...), which fails where no cluster manager is
    present."""
    import jax
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def is_multihost() -> bool:
    import jax
    return jax.process_count() > 1
