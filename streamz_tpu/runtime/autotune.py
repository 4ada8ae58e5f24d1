"""Measured backend selection, cached per device kind.

When two formulations of a hot stage exist (for example the single-device
and the SPMD discovery scans), the default is chosen **by measurement on the
current device**, not hardcoded: the winner depends on the device and the
interconnect.  Decisions are cached in-process and on disk keyed by
``device_kind`` so later processes skip the probe.  Probes run only on the
GPU; on the CPU, where the test suite runs, every stage takes its static
default.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

def _default_cache_path() -> str:
    """Per-user cache location.

    A fixed world-shared ``/tmp/streamz_autotune.json`` breaks on
    multi-user machines: the second user's lockfile/cache writes fail with
    ``PermissionError`` (silently swallowed in ``_disk_put``, so their
    multi-minute probe results never persist) while reads trust another
    user's file.  Suffix the path with the uid; ``STREAMZ_AUTOTUNE_CACHE``
    still overrides for teams that deliberately share one."""
    try:
        uid = f"-{os.getuid()}"
    except AttributeError:  # non-POSIX
        uid = ""
    import tempfile

    return os.path.join(tempfile.gettempdir(), f"streamz_autotune{uid}.json")


_CACHE_PATH = os.environ.get("STREAMZ_AUTOTUNE_CACHE", _default_cache_path())
_memory: Dict[str, str] = {}


def _cache_path() -> str:
    """Resolve the cache path PER CALL: STREAMZ_AUTOTUNE_CACHE set after
    import (a test isolating its probes, an app embedding the library)
    must win over the value captured at import time."""
    return os.environ.get("STREAMZ_AUTOTUNE_CACHE") or _CACHE_PATH


def _disk_get(key: str) -> Optional[str]:
    """Return the cached choice for ``key`` (a ``{"choice", "candidates"}``
    entry), or None."""
    entry = _disk_get_entry(key)
    return entry.get("choice") if isinstance(entry, dict) else None


def _disk_get_entry(key: str):
    try:
        with open(_cache_path()) as f:
            return json.load(f).get(key)
    except Exception:
        return None


def _disk_put(key: str, value) -> None:
    """Merge ``key: value`` into the shared cache file atomically.

    Concurrent cold processes probe different stages at once, so the
    read-modify-write holds an exclusive lock on a sidecar lockfile (two
    writers must not drop each other's multi-minute probe results) and
    publishes via temp-file + ``os.replace`` (readers never observe torn
    JSON — ``_disk_get`` would silently fall back to the static default)."""
    try:
        path = _cache_path()
        lock_path = path + ".lock"
        with open(lock_path, "w") as lock_f:
            try:
                import fcntl

                fcntl.flock(lock_f, fcntl.LOCK_EX)
            except Exception:
                pass  # no flock on this platform: still atomic via replace
            cached = {}
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        cached = json.load(f)
                    if not isinstance(cached, dict):
                        cached = {}
                except Exception:
                    # A corrupt cache (user edit, older crash) must not
                    # permanently disable persistence: every write would
                    # raise here BEFORE the dump, silently re-running the
                    # multi-minute probe suite in every new process
                    # forever.  Heal it with a fresh dict instead.
                    cached = {}
            cached[key] = value
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(cached, f)
            os.replace(tmp, path)
    except Exception:
        pass


def on_gpu() -> bool:
    """True on the GPU.  Elsewhere a probe would time the CPU backend,
    which no deployment runs."""
    import jax

    return jax.default_backend() == "gpu"


def probing_disabled() -> bool:
    """``STREAMZ_NO_AUTOTUNE=1`` (or the CLI's ``--no-autotune``) skips every
    measurement probe: cached decisions are still honored, but a cold cache
    resolves to the static per-stage default with zero probe cost."""
    return os.environ.get("STREAMZ_NO_AUTOTUNE", "0") == "1"


def median_time(fn: Callable[[], None], reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return sorted(times)[len(times) // 2]


def measured_choice(
    stage: str,
    candidates: Dict[str, Callable[[], float]],
    default: str,
) -> str:
    """Return the name of the fastest candidate for this device.

    ``candidates`` maps name -> zero-arg callable returning a measured time
    (lower is better); each callable is responsible for its own warmup.
    Off the GPU the ``default`` is returned without probing.  A probe that raises is an error, not a silent loss to the
    default: the exception propagates and nothing is cached.
    """
    import jax

    key = f"{stage}:{jax.devices()[0].device_kind}"
    if jax.process_count() > 1:
        # Multi-host: never probe, read caches, or persist — hosts may hold
        # different caches, and every host must resolve the SAME backend or
        # the traced SPMD programs diverge.
        return default
    if key in _memory:
        return _memory[key]
    if not on_gpu():
        _memory[key] = default
        return default
    entry = _disk_get_entry(key)
    if isinstance(entry, dict):
        cached = entry.get("choice")
        # A stored decision is only valid for the candidate set it was
        # measured against: adding (or retiring) a candidate invalidates
        # old entries so every device re-probes with the full field
        # instead of keeping a stale winner forever.
        if cached in candidates and (
            entry.get("candidates") == sorted(candidates)
            # With probing disabled there will be no re-measure: a
            # still-valid winner from an older candidate set beats
            # falling back to the static default.
            or probing_disabled()
        ):
            _memory[key] = cached
            return cached
    if probing_disabled():
        # No probe and no valid pin: take the static default, memoized so
        # repeated calls do not re-read the JSON cache, but never persisted
        # (the next probing-enabled process should measure).
        _memory[key] = default
        return default

    times = {name: probe() for name, probe in candidates.items()}
    best_name = min(times, key=times.get)
    _memory[key] = best_name
    _disk_put(key, {"choice": best_name, "candidates": sorted(candidates)})
    return best_name


def reset(stage: Optional[str] = None) -> None:
    """Drop in-process decisions (tests)."""
    if stage is None:
        _memory.clear()
    else:
        for k in [k for k in _memory if k.startswith(f"{stage}:")]:
            del _memory[k]
