"""Tracing and per-phase timing.

The reference has no profiling at all (SURVEY.md §5.1; its only observability
is indicatif progress bars).  This module provides:

- :class:`PhaseTimer` — wall-clock per-phase timing with a printed summary
  (ingest / features / train / eval phases of the CLI);
- :func:`trace` — a context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable device trace when a trace dir is given.

Enable from the CLI with ``--profile [dir]``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = ["Phase timing:"]
        for name, secs in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * secs / total if total else 0.0
            lines.append(f"  {name:<20} {secs:8.3f}s  {pct:5.1f}%")
        lines.append(f"  {'total':<20} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler device trace when ``trace_dir`` is set; no-op otherwise."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
