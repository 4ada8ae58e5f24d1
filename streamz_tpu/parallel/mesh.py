"""Process-global device mesh used by the *application* (CLI) paths.

This module wires the parallel library into the CLI: the CLI calls
:func:`auto_mesh` once at startup — when more than one device is visible, a
1-D ``"data"`` mesh over all local devices is built and every batched
application stage (ingest frontend, initial corpus training, eval embedding
batches, long-clip identification) runs sharded over it.  This is the
application-level analogue of the reference binary being rayon-parallel
end-to-end (``streamz-rs/src/main.rs:490-508``, ``:750-835``).

Library functions take an explicit ``mesh`` argument; only the CLI consults
the process-global here, so tests stay in control of sharding.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from streamz_tpu.parallel import comm

_UNSET = object()  # distinct from None: "no mesh" is a cachable decision
_ACTIVE: list = [_UNSET]


def auto_mesh() -> Optional[Mesh]:
    """Build (once) and return the data mesh over all local devices, or
    ``None`` single-device.  ``STREAMZ_TPU_MESH=0`` disables it; a prior
    ``set_active_mesh(None)`` stays pinned (a bare-None sentinel used to
    read as "never built" and silently rebuilt a mesh over it), and the
    env kill-switch is consulted on EVERY call so setting it mid-process
    wins over an already-built mesh."""
    if os.environ.get("STREAMZ_TPU_MESH", "1") == "0":
        return None
    if _ACTIVE[0] is not _UNSET:
        return _ACTIVE[0]
    try:
        devs = jax.devices()
    except Exception:
        return None
    if len(devs) < 2:
        return None
    _ACTIVE[0] = comm.make_mesh(axis=comm.DATA_AXIS)
    return _ACTIVE[0]


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    _ACTIVE[0] = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE[0]


def pad_rows_to_mesh(
    mesh: Mesh, *arrays: np.ndarray
) -> Tuple[int, tuple]:
    """Zero-pad each array's leading axis to a multiple of the mesh size.

    Returns ``(original_rows, padded_arrays)``.  Padding rows are zeros, so
    downstream masking (length-0 clips / weight-0 windows) drops them.
    """
    n_dev = mesh.devices.size
    n = arrays[0].shape[0]
    n_pad = -(-max(n, 1) // n_dev) * n_dev
    if n_pad == n:
        return n, arrays
    out = []
    for a in arrays:
        padded = np.zeros((n_pad,) + a.shape[1:], a.dtype)
        if n:
            padded[:n] = a
        out.append(padded)
    return n, tuple(out)


def fetch(x) -> np.ndarray:
    """Host copy of a device array, multi-host-safe.

    ``np.asarray`` when the array is fully addressable (single process, or
    replicated outputs); otherwise the shards are gathered across processes
    first (``process_allgather``) — fetching a multi-host-sharded array
    directly raises in JAX.
    """
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def put_batch_sharded(mesh: Mesh, *arrays):
    """device_put arrays with the leading axis sharded over the mesh's axis
    (everything else replicated) — pjit compiles the downstream jitted
    function SPMD from these input shardings alone."""
    out = []
    axis = mesh.axis_names[0]
    for a in arrays:
        spec = P(axis, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)
