"""Multi-host (multi-process) runtime: distributed mesh construction and
restart-from-checkpoint of sharded solves.

The reference is strictly single-node — no MPI/NCCL/Gloo anywhere (SURVEY §5
"distributed communication backend: none") — so this is the framework's
own multi-host story: one JAX process per host, a global 1-D mesh over all
devices, and the same per-variable psum consensus that ShardedUniformSolver
already uses (the delta payload is 2*(V+1) floats per half-sweep,
independent of BDD count).

CPU dry-runs (CI, no hardware): 2+ processes x N virtual CPU devices with
Gloo collectives — exercised by tests/test_multihost.py, which kills a
2-process run mid-solve and resumes it from the checkpoint with bounds
identical to an uninterrupted single-process run.
"""
from __future__ import annotations

import pickle
from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    platform: Optional[str] = None,
    local_device_count: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for a multi-process run.

    Pass the coordinator address (``localhost:<port>`` on one machine), the
    process count and this process's id: a GPU machine tells JAX of no
    cluster. For CPU dry-runs also pass ``platform="cpu"``;
    ``local_device_count`` forces N virtual CPU devices per process (must be
    set before the first jax import in fresh processes; here it is applied
    via XLA_FLAGS when possible).
    """
    import os

    if local_device_count is not None and "jax" not in globals():
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    import jax

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        try:
            # cross-process collectives on the CPU backend
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # older jaxlib: gloo is the default already
            pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis_name: str = "b"):
    """1-D mesh over ALL devices of the distributed run (every process must
    call with the same axis name)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))


def process_index() -> int:
    import jax

    return jax.process_index()


def _solver_sharding(solver):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(solver.mesh, P(solver._axis))


def save_sharded(solver, path: str) -> None:
    """Checkpoint a ShardedUniformSolver's dual state from a multi-process
    run: allgather the global state, write on process 0 (same blob format as
    extras.save_state, so single-process extras.load_state also reads it)."""
    import jax
    from jax.experimental import multihost_utils

    state = solver.state_stacked
    if jax.process_count() > 1:
        arrays = [
            np.asarray(multihost_utils.process_allgather(x, tiled=True))
            for x in jax.tree.leaves(state)
        ]
    else:
        arrays = [np.asarray(x) for x in jax.tree.leaves(state)]
    if jax.process_index() == 0:
        with open(path, "wb") as fh:
            pickle.dump(
                {"kind": type(solver).__name__, "state": arrays}, fh
            )
    # all processes wait for the file before anyone may proceed to read it
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices("bdd_tpu_save_sharded")


def load_sharded(solver, path: str) -> None:
    """Restore a sharded dual state in a (possibly multi-process) run: every
    process reads the blob and device_puts its addressable shards."""
    import jax

    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    template = solver.state_stacked
    arrays = blob["state"]
    leaves = jax.tree.leaves(template)
    if len(arrays) != len(leaves) or any(
        np.asarray(a).shape != t.shape for a, t in zip(arrays, leaves)
    ):
        raise ValueError(
            "checkpoint does not match the solver's state structure — "
            "geometry/backend mismatch"
        )
    sharding = _solver_sharding(solver)
    solver.state_stacked = jax.tree.unflatten(
        jax.tree.structure(template),
        [
            jax.device_put(np.asarray(a, dtype=t.dtype), sharding)
            for a, t in zip(arrays, leaves)
        ],
    )
