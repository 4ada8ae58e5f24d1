"""Multi-host serving harness: one :class:`SpeakerServer` per host, a
round-robin client in front.

:class:`~streamz_tpu.app.serve.MultiStreamIdentifier` is single-process by
design — its feeds and verdicts are host-local operations on addressable
devices, and *sharing* stream state across hosts would put a network
round trip inside every 100 ms tick for zero compute benefit (one device
serves many streams, ``benchmarks/serve_bench.py``).  The
multi-host serving story is therefore *horizontal*: each host runs one
:class:`~streamz_tpu.app.server.SpeakerServer` on its local devices, and
clients spread streams across the hosts.  Verdicts are trivially
identical to a single big fleet because streams are independent — the
per-stream computation does not depend on which host's slot it lands in
(pinned by ``tests/test_fleet.py``).

Three pieces:

- ``python -m streamz_tpu.app.fleet --checkpoint m.npz --port 0`` — one
  serving process.  Prints ``FLEET_READY host=... port=...`` once bound
  (machine-parseable; ``--port 0`` binds an ephemeral port), then serves
  until SIGTERM/^C.
- :class:`LocalFleet` — a launcher that spawns N such processes (one per
  host in production via your process manager; N local processes for
  tests/single-machine scale-out) and collects their endpoints.
- :class:`FleetClient` — round-robin stream placement over
  :class:`~streamz_tpu.app.server.StreamClient` connections: each
  ``open()`` claims a slot on the next healthy server (dead endpoints
  are skipped), ``reopen()`` migrates a stream whose home died, and the
  per-stream API (``feed``/``current``/``finalize``/``close``) is
  unchanged.

The reference's serving story is a stub (``streamz-rs/examples/
live_stream.rs:1-9``); this completes the distribution story of the
serving stack that already exceeds it.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from streamz_tpu import config

READY_TAG = "FLEET_READY"


class _ChildDrain:
    """Continuously drain one child's merged stdout on a daemon thread.

    One thread owning ALL reads solves two launcher hazards at once:
    (a) READY detection cannot be select()-gated on the raw fd — a
    readline() may slurp READY into the TextIO buffer together with an
    earlier log line (e.g. a JAX warning), leaving the fd silent while
    the line sits in Python memory and the launcher times out on a
    healthy server; (b) after READY the server keeps logging (tick
    errors, hot-swap notices), and an undrained 64 KB pipe would
    eventually block the server's print() — freezing its ticker thread
    and every stream on it.  The thread parses READY, keeps a bounded
    tail for error reports, and drains until EOF.
    """

    def __init__(self, p: subprocess.Popen):
        self.proc = p
        self.tail: deque = deque(maxlen=50)
        self.ready = threading.Event()
        self.endpoint: Optional[Tuple[str, int]] = None
        self.error: Optional[str] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        try:
            for line in self.proc.stdout:
                self.tail.append(line)
                if not self.ready.is_set() and line.startswith(READY_TAG):
                    kv = dict(
                        tok.split("=", 1)
                        for tok in line.split()[1:] if "=" in tok
                    )
                    try:
                        self.endpoint = (kv["host"], int(kv["port"]))
                    except (KeyError, ValueError) as e:
                        self.error = f"malformed READY line {line!r} ({e})"
                    self.ready.set()
        except (OSError, ValueError):
            pass  # pipe torn down during stop()
        finally:
            self.ready.set()  # EOF pre-READY: wake the waiter to report

    def tail_text(self) -> str:
        return "".join(list(self.tail)[-20:])


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def _visible_cards(env: Dict[str, str]) -> List[str]:
    """GPU ids the children may use, read without starting JAX in this
    process: ``CUDA_VISIBLE_DEVICES`` when set, else what ``nvidia-smi``
    lists (none when it is absent)."""
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    return out.stdout.split() if out.returncode == 0 else []


def _per_card_envs(env: Dict[str, str], n: int) -> List[Dict[str, str]]:
    """One environment per child: CPU-pinned children share ``env``;
    otherwise child ``i`` sees only card ``i`` of the visible cards."""
    if env.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return [env] * n
    cards = _visible_cards(env)
    if len(cards) < n:
        raise RuntimeError(
            f"{n} fleet servers need one GPU each but {len(cards)} are "
            "visible; use fewer servers, or set JAX_PLATFORMS=cpu to "
            "serve on the CPU"
        )
    return [dict(env, CUDA_VISIBLE_DEVICES=cards[i]) for i in range(n)]


class LocalFleet:
    """Spawn ``n_servers`` serving processes on this machine.

    Each child is a fresh Python process (its own JAX runtime and device
    client — exactly the per-host layout of a production fleet) running
    ``python -m streamz_tpu.app.fleet`` with the given checkpoint.  A JAX
    process reserves most of a GPU's memory, so child ``i`` gets its own
    card (``CUDA_VISIBLE_DEVICES``) and a fleet larger than the visible
    cards is refused.  Use ``env`` to pin the platform (e.g.
    ``{"JAX_PLATFORMS": "cpu"}`` in tests, which any number of children
    share); children inherit the parent environment otherwise.

    >>> fleet = LocalFleet("model.npz", n_servers=2, n_streams=16)
    >>> endpoints = fleet.start()          # [(host, port), ...]
    >>> client = FleetClient(endpoints)
    >>> ...
    >>> fleet.stop()
    """

    def __init__(
        self,
        checkpoint: str,
        n_servers: int,
        host: str = "127.0.0.1",
        n_streams: int = 64,
        threshold: float = config.DEFAULT_CONF_THRESHOLD,
        tick_interval: float = 0.02,
        env: Optional[Dict[str, str]] = None,
        watch_model: bool = False,
    ):
        if n_servers < 1:
            raise ValueError("n_servers must be >= 1")
        self.checkpoint = str(checkpoint)
        self.n_servers = int(n_servers)
        self.host = host
        self.n_streams = int(n_streams)
        self.threshold = float(threshold)
        self.tick_interval = float(tick_interval)
        self.env = dict(env) if env else None
        self.watch_model = bool(watch_model)
        self._procs: List[subprocess.Popen] = []
        self._drains: List[_ChildDrain] = []
        self.endpoints: List[Tuple[str, int]] = []

    def start(self, timeout: float = 180.0) -> List[Tuple[str, int]]:
        """Launch the servers; block until every one prints its READY line
        (or raise, killing any partial fleet)."""
        if self._procs:
            raise RuntimeError("fleet already started")
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        child_envs = _per_card_envs(env, self.n_servers)
        argv = [
            sys.executable, "-m", "streamz_tpu.app.fleet",
            "--checkpoint", self.checkpoint,
            "--host", self.host,
            "--port", "0",
            "--n-streams", str(self.n_streams),
            "--threshold", repr(self.threshold),
            "--tick-interval", repr(self.tick_interval),
        ]
        if self.watch_model:
            argv += ["--watch-model"]
        try:
            for child_env in child_envs:
                p = subprocess.Popen(
                    argv, env=child_env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True,
                )
                self._procs.append(p)
                self._drains.append(_ChildDrain(p))
            deadline = time.monotonic() + timeout
            for p, d in zip(self._procs, self._drains):
                self.endpoints.append(self._read_ready(p, d, deadline))
        except Exception:
            self.stop()
            raise
        return list(self.endpoints)

    @staticmethod
    def _read_ready(
        p: subprocess.Popen, drain: _ChildDrain, deadline: float
    ) -> Tuple[str, int]:
        while time.monotonic() < deadline:
            wait = min(1.0, max(0.0, deadline - time.monotonic()))
            if not drain.ready.wait(timeout=wait):
                continue  # still silent; re-check the deadline
            if drain.endpoint is not None:
                return drain.endpoint
            if drain.error is not None and p.poll() is None:
                raise RuntimeError(
                    f"fleet server {drain.error}:\n" + drain.tail_text()
                )
            # EOF before READY: the child is gone.  Reap briefly so the
            # error carries a real exit code instead of rc=None.
            try:
                rc = p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                rc = p.poll()
            raise RuntimeError(
                f"fleet server exited rc={rc} before READY:\n"
                + drain.tail_text()
            )
        raise TimeoutError(
            "fleet server did not become ready:\n" + drain.tail_text()
        )

    def stop_server(self, i: int) -> None:
        """Terminate server ``i`` only (fault injection, rolling restart).
        Its endpoint stays listed; :class:`FleetClient` skips it while
        down and :meth:`FleetClient.reopen` migrates its streams."""
        p = self._procs[i]
        if p.poll() is None:
            p.terminate()
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)

    def stop(self) -> None:
        """Terminate every server process (SIGTERM → graceful stop)."""
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        self._procs = []
        self._drains = []  # threads exit on their own at pipe EOF
        self.endpoints = []

    def __enter__(self) -> "LocalFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Round-robin client
# ---------------------------------------------------------------------------


class FleetClient:
    """Round-robin stream placement over a fleet of speaker servers.

    Stream ids are fleet-level handles; each ``open()`` connects one
    :class:`~streamz_tpu.app.server.StreamClient` to the next endpoint in
    round-robin order (a connection IS a slot claim, so balancing happens
    at stream granularity).  Per-stream results are independent of
    placement, so a fleet of N servers is verdict-identical to one big
    server (``tests/test_fleet.py``) — which is also what makes failover
    sound: ``open()`` skips dead endpoints, and ``reopen()`` + a client
    re-feed reproduces a dead home's verdict anywhere else.
    """

    def __init__(self, endpoints: Sequence[Tuple[str, int]], timeout: float = 30.0):
        if not endpoints:
            raise ValueError("need at least one endpoint")
        self.endpoints = [(h, int(p)) for h, p in endpoints]
        self.timeout = float(timeout)
        self._next = 0
        self._streams: Dict[int, object] = {}  # fid -> StreamClient
        self._homes: Dict[int, Tuple[str, int]] = {}
        self._fid = 0

    def _claim(self) -> Tuple[object, Tuple[str, int]]:
        """Connect to the next HEALTHY endpoint (round-robin): a dead
        server (connection refused/reset at connect) is skipped and the
        next one tried, up to one full cycle.  A FULL server still raises
        on first use — capacity is a policy decision, not a failure."""
        from streamz_tpu.app.server import StreamClient

        last: Optional[BaseException] = None
        for _ in range(len(self.endpoints)):
            ep = self.endpoints[self._next % len(self.endpoints)]
            self._next += 1
            try:
                return StreamClient(ep[0], ep[1], timeout=self.timeout), ep
            except OSError as e:
                last = e
        raise ConnectionError(
            f"no healthy endpoint among {len(self.endpoints)}: {last}"
        )

    def open(self) -> int:
        """Claim a stream on the next healthy server (round-robin; dead
        endpoints are skipped — see :meth:`_claim`)."""
        c, ep = self._claim()
        fid = self._fid
        self._fid += 1
        self._streams[fid] = c
        self._homes[fid] = ep
        return fid

    def reopen(self, fid: int) -> Tuple[str, int]:
        """Migrate stream ``fid`` to the next healthy server after its
        home died mid-stream; returns the new (host, port) home.  The
        fleet-level handle survives, but the stream STATE does not — the
        verdict accumulator lived on the dead host — so the caller
        re-feeds the audio from its own buffer (feeds are per-tick
        appends; replaying them reproduces the verdict, which is what
        per-stream placement-independence guarantees)."""
        if fid not in self._homes:
            raise KeyError(f"stream {fid} is not open")
        old = self._streams.pop(fid, None)
        self._homes.pop(fid)
        if old is not None:
            old.close()
        c, ep = self._claim()
        self._streams[fid] = c
        self._homes[fid] = ep
        return ep

    def home(self, fid: int) -> Tuple[str, int]:
        """The (host, port) endpoint serving stream ``fid``."""
        return self._homes[fid]

    def _client(self, fid: int):
        c = self._streams.get(fid)
        if c is None:
            raise KeyError(f"stream {fid} is not open")
        return c

    def feed(self, fid: int, pcm, wire: Optional[str] = None) -> None:
        self._client(fid).feed(pcm, wire=wire)

    def current(self, fid: int):
        return self._client(fid).current()

    def finalize(self, fid: int):
        return self._client(fid).finalize()

    def close(self, fid: int) -> None:
        c = self._streams.pop(fid, None)
        self._homes.pop(fid, None)
        if c is not None:
            c.close()

    def stats(self) -> List[Dict[str, object]]:
        """Per-server stats.  A connection IS a slot claim, so an endpoint
        with one of our streams open answers over that stream's connection
        (STATS is stateless w.r.t. the slot); only endpoints where we hold
        no stream get a transient connection — which can fail on a FULL
        server (reported as {"error": ...} rather than raising, since a
        full server is exactly when you want the other stats)."""
        from streamz_tpu.app.server import StreamClient

        by_ep: Dict[Tuple[str, int], object] = {}
        for fid, ep in self._homes.items():
            by_ep.setdefault(ep, self._streams[fid])
        out = []
        for ep in self.endpoints:
            h, p = ep
            try:
                c = by_ep.get(ep)
                if c is not None:
                    s = c.stats()
                else:
                    with StreamClient(h, p, timeout=self.timeout) as tc:
                        s = tc.stats()
            except (RuntimeError, OSError, ConnectionError) as e:
                s = {"error": str(e)}
            s["endpoint"] = f"{h}:{p}"
            out.append(s)
        return out

    def close_all(self) -> None:
        for fid in list(self._streams):
            self.close(fid)

    def __enter__(self) -> "FleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close_all()


# ---------------------------------------------------------------------------
# Per-process server entry
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m streamz_tpu.app.fleet",
        description="Run ONE speaker-serving process (one per host).",
    )
    ap.add_argument("--checkpoint", required=True, help="model .npz to serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed on READY)")
    ap.add_argument("--n-streams", type=int, default=64)
    ap.add_argument("--threshold", type=float,
                    default=config.DEFAULT_CONF_THRESHOLD)
    ap.add_argument("--tick-interval", type=float, default=0.02)
    ap.add_argument("--block-batch", type=int, default=16)
    ap.add_argument("--idle-timeout", type=float, default=0.0,
                    help="drop a connection (releasing its slot) after this "
                         "many seconds without a frame; <=0 disables")
    ap.add_argument("--watch-model", action="store_true",
                    help="hot-reload the checkpoint on change")
    args = ap.parse_args(argv)

    from streamz_tpu.app.server import SpeakerServer
    from streamz_tpu.nn import checkpoint
    from streamz_tpu.runtime.compile_cache import enable_compile_cache

    # Fleet children are fresh processes: the persistent cache lets the
    # whole fleet share one compile of the streaming programs.
    enable_compile_cache()
    net = checkpoint.load(args.checkpoint)
    srv = SpeakerServer(
        net,
        host=args.host,
        port=args.port,
        n_streams=args.n_streams,
        threshold=args.threshold,
        block_batch=args.block_batch,
        tick_interval=args.tick_interval,
        watch_model=args.checkpoint if args.watch_model else None,
        idle_timeout=args.idle_timeout if args.idle_timeout > 0 else None,
    )
    srv.start()
    print(f"{READY_TAG} host={args.host} port={srv.port} "
          f"pid={os.getpid()} n_streams={args.n_streams}", flush=True)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
