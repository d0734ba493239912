"""Multi-host initialization (SURVEY.md §2.3 / §5).

The reference is single-process; this build scales across hosts
with `jax.distributed` + the same row-sharded mesh.  Failure semantics
are fail-stop (a lost host aborts the job — solver runs are
seconds-to-minutes, re-running beats elastic machinery; documented
design decision, SURVEY.md §5).

Typical multi-host driver:

    import fasta_tpu.distributed as dist
    dist.initialize()                      # once per process, all hosts
    mesh = dist.global_mesh()              # 1-D mesh over ALL devices
    sprob = sharding.shard_problem(problem, mesh)
    result = sprob.solve(...)              # identical on every host

Every stepsize/stopping scalar inside the solve is a deterministic
collective, so all hosts take identical branches — no host-side
synchronization is ever needed beyond the collectives themselves.
"""

from __future__ import annotations

from typing import Optional

import jax

from .sharding import make_mesh

__all__ = ["initialize", "global_mesh", "is_distributed"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize `jax.distributed` (no-op if single-process or already
    initialized).  Pass the coordinator address, process count and
    process id explicitly: nothing in a plain GPU or CPU host tells
    JAX of a cluster."""
    global _initialized
    if _initialized:
        return
    if num_processes is not None and num_processes <= 1:
        _initialized = True
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True


def is_distributed() -> bool:
    return jax.process_count() > 1


def global_mesh(axis_name: str = "rows"):
    """1-D mesh spanning every device of every host."""
    return make_mesh(axis_name=axis_name)
