"""The communication layer: named-axis collectives over a device mesh.

The reference has *no* distributed backend — its "communication" is shared
memory behind locks (``Arc<RwLock<SimpleNeuralNet>>`` at
``streamz-rs/src/main.rs:710``, a mutex'd loss accumulator at ``:713``, atomic
counters at ``:714``; see SURVEY.md §2.4).  In the SPMD rebuild those all
become collectives over a mesh axis:

- the lock-serialized gradient application → ``psum`` gradient allreduce
  (NCCL over NVLink between the GPUs of one host);
- the shared loss accumulator / file counter → ``psum`` scalars;
- the snapshot-then-compute centroid reads → ``all_gather``.

Multi-host jobs bootstrap with ``jax.distributed.initialize``; inside one
host the same named-axis code runs unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# Canonical mesh axis names.
DATA_AXIS = "data"      # files/windows sharded across chips (the rayon-pool analogue)
WINDOW_AXIS = "window"  # long-clip window-axis sharding (the CP analogue)


def psum(x, axis: str = DATA_AXIS):
    return jax.lax.psum(x, axis_name=axis)


def pmean(x, axis: str = DATA_AXIS):
    return jax.lax.pmean(x, axis_name=axis)


def all_gather(x, axis: str = DATA_AXIS, *, tiled: bool = False):
    return jax.lax.all_gather(x, axis_name=axis, tiled=tiled)


def axis_index(axis: str = DATA_AXIS):
    return jax.lax.axis_index(axis)


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Mesh:
    """A 1-D device mesh over the first ``n_devices`` local devices."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            # Silent truncation would hand back a smaller mesh than the
            # caller's sharding/throughput math assumes (and let a typo
            # like n_devices=80 'succeed').
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are available"
            )
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh, axis=DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dimension across the mesh axis.

    ``axis`` may be one axis name or a tuple of names — a tuple shards the
    leading dimension over those axes jointly (e.g. every axis of a
    multi-axis mesh)."""
    return NamedSharding(mesh, P(axis))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bootstrap (``jax.distributed.initialize``).

    No-op when the job is single-process (the common case in tests and on
    a single host).  Multi-host launchers pass all three coordinator/
    process flags; on a managed cluster whose environment jax can
    auto-detect (SLURM, GKE and similar), set
    ``STREAMZ_DIST_AUTO=1`` to opt into ``jax.distributed.initialize()``
    with no args instead — auto-detection is NOT attempted by default
    because probing cluster metadata on every plain single-host CLI run
    costs startup time and can hang on half-configured environments.
    """
    import os

    given = {
        "--coordinator": coordinator_address,
        "--num-processes": num_processes,
        "--process-id": process_id,
    }
    missing = [k for k, v in given.items() if v is None]
    if len(missing) == 3:
        if os.environ.get("STREAMZ_DIST_AUTO", "0") == "1":
            # Explicit opt-in: let jax detect the cluster environment.
            # Failure here is a misconfigured cluster, not a single-
            # process job — surfacing it beats every host silently
            # training its own divergent model over local chips only.
            jax.distributed.initialize()
        return  # single-process job: the common case
    if missing:
        # ANY partial config is a misconfigured launcher, not a
        # single-process job: silently skipping (or handing jax a
        # half-specified config) would leave every host running its own
        # psum over local devices only, or die in an obscure jax-internal
        # error instead of this contract's message.
        present = [k for k, v in given.items() if v is not None]
        raise ValueError(
            f"{'/'.join(present)} given without {'/'.join(missing)}; "
            "pass all three (or STREAMZ_DIST_AUTO=1 with none, for "
            "cluster auto-detection via jax.distributed.initialize())"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
