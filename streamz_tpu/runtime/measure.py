"""Shared measurement utilities for the benchmark harnesses.

- :func:`chain_timer` — per-iteration time of a device function, its
  iterations chained through a data dependency inside one jitted scan, so
  a single dispatch carries many calls and ``block_until_ready`` ends it;
- :func:`card_name_and_power_limit` — the GPU's name and power limit as
  ``nvidia-smi`` reports them, to print beside every number.
"""

from __future__ import annotations

import subprocess
import time


def chain_timer(fn, *args, iters: int = 8, repeats: int = 3,
                best: bool = False) -> float:
    """Per-iteration wall time of ``fn(*args)`` on device.

    Iterations are chained through a data dependency inside ONE jitted
    scan and timed to ``block_until_ready``.  Two collapse fences:

    - the carry is added to the first operand WITHOUT dtype promotion
      (adding an f32 carry to a bf16 operand would silently upcast the
      GEMM);
    - the consumer keeps every output element live via a full ``sum`` — a
      sliced consumer (``sum(r[:1, :1])``) lets XLA's slice-of-dot rewrite
      shrink the whole GEMM to a 1x1 dot, and the probe then times
      dispatch latency.

    Returns the median of ``repeats`` runs (or the min with ``best=True``
    — the right statistic for a *peak* probe)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(*a):
        def body(c, _):
            r = fn(*(x + c.astype(x.dtype) if i == 0 else x
                     for i, x in enumerate(a)))
            return jnp.sum(r).astype(jnp.float32) * 1e-20, None
        c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=iters)
        return c

    jax.block_until_ready(chained(*args))  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(*args))
        times.append(time.perf_counter() - t0)
    # (len-1)//2: the true lower-median — len//2 picks the WORSE of
    # two runs for even repeat counts.
    picked = min(times) if best else sorted(times)[(len(times) - 1) // 2]
    return picked / iters


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every visible card,
    one line each (a card may be capped below its maximum and then runs
    slower under load).  Raises when ``nvidia-smi`` fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
