"""Multi-host initialization for runs that span several GPU hosts.

The reference is single-host only (joblib process pool,
reference pmcmc.py:8, 201-220).  Scaling the chain axis across hosts needs
exactly one extra step: ``jax.distributed.initialize`` BEFORE any other JAX
call, after which ``jax.devices()`` spans every host and the usual
``epitpu.dist.make_mesh`` / ``sharded_pmmh`` path shards chains over the
global device set.  XLA's collectives go over NCCL: NVLink between the GPUs
of one host, the network between hosts, so keep particle shards (which
communicate every filter step) within a host and spread chain shards
(which communicate only for pooled adaptation) across hosts.

Launch recipe (one process per host):

    EPITPU_COORDINATOR=host0:8476 EPITPU_NUM_PROCESSES=4 EPITPU_PROCESS_ID=$i \\
        python -m epitpu.cli.run --preset ... --multihost

Under SLURM or Open MPI the three values are auto-detected and
``initialize_multihost()`` needs no arguments at all.  Artifacts/checkpoints
are written by process 0 only (see ``is_primary_host``).
"""
from __future__ import annotations

import os
from typing import Optional


def multihost_env_spec():
    """Read the EPITPU_COORDINATOR / EPITPU_NUM_PROCESSES /
    EPITPU_PROCESS_ID env triple; None when unset (single-host run)."""
    addr = os.environ.get("EPITPU_COORDINATOR")
    if not addr:
        return None
    return {
        "coordinator_address": addr,
        "num_processes": int(os.environ["EPITPU_NUM_PROCESSES"]),
        "process_id": int(os.environ["EPITPU_PROCESS_ID"]),
    }


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or form) the multi-host JAX runtime.  MUST run before any other
    JAX API touches a backend.  With no arguments: use the env triple when
    present, else fall back to JAX's cloud auto-detection; on a plain
    single-host machine with neither, this is a no-op returning False.

    Returns True when a multi-process runtime was initialized.
    """
    import jax

    if coordinator_address is None:
        spec = multihost_env_spec()
        if spec is not None:
            coordinator_address = spec["coordinator_address"]
            num_processes = spec["num_processes"]
            process_id = spec["process_id"]
        elif not _cloud_autodetectable():
            return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def _cloud_autodetectable() -> bool:
    """True when jax.distributed.initialize can self-configure (SLURM /
    Open MPI environments)."""
    return any(
        k in os.environ for k in ("SLURM_JOB_ID", "OMPI_MCA_orte_hnp_uri")
    )


def is_primary_host() -> bool:
    """True on the process that should write artifacts and checkpoints."""
    import jax

    return jax.process_index() == 0
