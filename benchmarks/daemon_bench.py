"""Deployable serving surface: the TCP daemon end-to-end, with tail latency.

Every earlier serving row drove the in-process
:class:`~streamz_tpu.app.serve.MultiStreamIdentifier` — the batched-kernel
economics.  What ``--serve`` actually deploys is
:class:`~streamz_tpu.app.server.SpeakerServer`: socket transport,
per-connection reader threads, a ticker thread, and a lock between them.
This harness measures THAT surface:

- the SERVER runs in its own process (``python -m streamz_tpu.app.fleet`` —
  the one-per-host production serving process) and owns the device; the
  checkpoint it loads is written by a throwaway CPU-pinned subprocess so
  the bench process itself never initializes a device backend;
- the BENCH process runs only socket clients: N streams, each looping
  ``feeds_per_probe`` 100 ms FEED frames (pre-packed wire bytes — the
  client loop is sendall + one CURRENT round trip) and recording the
  CURRENT wall time as a per-verdict latency sample.  A cycle's audio is
  only counted once its verdict round trip completed.

Wire phases are interleaved i16/u8 (rep-wise), so a slow phase of the host
cannot land on one wire and masquerade as a wire effect — the same
methodology `serve_bench.bench_slots_interleaved` uses in-process.

Reported per wire: aggregate real-time factor (verdict-acknowledged
audio-seconds per wall second across the fleet) + client-observed
per-verdict p50/p95/p99; plus the server's working-tick p50/p95/p99 from
STATS (``app/server.py`` records them) and its overflow/reject counters.

``bench_fleet`` runs the same client harness against a 2-process
:class:`~streamz_tpu.app.fleet.LocalFleet` (CPU-pinned children — the
multi-host layout on one machine) through the round-robin
:class:`~streamz_tpu.app.fleet.FleetClient` placement.

Ref: the subsystem this finishes the measurement story for exceeds the
reference's stub ``streamz-rs/examples/live_stream.rs:1-9``.

Usage: python benchmarks/daemon_bench.py [--daemon-streams N] [--fleet]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from streamz_tpu.app.server import _HDR, OP_FEED, StreamClient  # noqa: E402
from streamz_tpu.io import g711  # noqa: E402

WIRES = ("i16", "ulaw")


def _child_env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    if extra:
        env.update(extra)
    return env


def make_checkpoint(path: str, classes: int = 5) -> None:
    """Write the serving checkpoint from a CPU-pinned subprocess, keeping
    the bench process free of any device backend (the server child must be
    the only process on the GPU: a JAX process reserves most of its
    memory)."""
    src = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from streamz_tpu.nn.model import SpeakerNet\n"
        "from streamz_tpu.nn import checkpoint\n"
        f"net = SpeakerNet.new(output={classes}, seed=0)\n"
        f"checkpoint.save(net, {path!r})\n"
    )
    subprocess.run(
        [sys.executable, "-c", src], check=True, capture_output=True,
        timeout=300, env=_child_env({"JAX_PLATFORMS": "cpu"}),
    )


def _feed_frames(chunk_ms: float = 100.0, seed: int = 0) -> dict:
    """Pre-packed FEED frame bytes per wire (one 100 ms chunk each)."""
    rng = np.random.default_rng(seed)
    n = int(44100 * chunk_ms / 1000.0)
    pcm = rng.normal(0, 3000, size=n).astype(np.int16)
    payloads = {
        "i16": bytes([StreamClient.WIRE["i16"]]) + pcm.astype("<i2").tobytes(),
        "ulaw": bytes([StreamClient.WIRE["ulaw"]])
        + g711.ulaw_encode(pcm).tobytes(),
    }
    return {w: _HDR.pack(OP_FEED, len(p)) + p for w, p in payloads.items()}


def _run_phase(clients, frames: dict, wire: str, duration_s: float,
               feeds_per_probe: int, chunk_ms: float):
    """One timed phase: every stream loops F feeds + 1 CURRENT round trip.

    Returns (verdict-acknowledged audio seconds, latency samples, wall s,
    client error count).  A sticky FEED error (e.g. backlog overflow)
    must not silently kill a worker — a wire losing workers mid-phase
    would reintroduce exactly the asymmetric-degradation artifact the
    interleaved methodology exists to prevent — so errors are counted,
    surfaced in the row, and the stream keeps going (a dead transport
    retires only its own worker).
    """
    lat = [[] for _ in clients]
    fed = [0] * len(clients)
    errs = [0] * len(clients)
    frame = frames[wire]
    start = time.perf_counter()
    stop_at = start + duration_s

    def work(i):
        c = clients[i]
        while time.perf_counter() < stop_at:
            try:
                for _ in range(feeds_per_probe):
                    c.sock.sendall(frame)
                t0 = time.perf_counter()
                c.current()
                lat[i].append(time.perf_counter() - t0)
                fed[i] += feeds_per_probe  # counted after the round trip
            except (ConnectionError, OSError):
                errs[i] += 1
                return  # transport gone: only this worker retires
            except RuntimeError:
                errs[i] += 1  # sticky FEED error; the stream stays usable

    threads = [
        threading.Thread(target=work, args=(i,)) for i in range(len(clients))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - start
    audio_s = sum(fed) * chunk_ms / 1000.0
    return audio_s, [x for run in lat for x in run], wall, sum(errs)


def _pcts(samples):
    p50, p95, p99 = np.percentile(np.asarray(samples) * 1e3, (50, 95, 99))
    return round(float(p50), 2), round(float(p95), 2), round(float(p99), 2)


def _wire_rows(prefix: str, agg: dict, out: dict) -> None:
    for w, a in agg.items():
        rtf = a["audio"] / a["wall"] if a["wall"] else 0.0
        out[f"{prefix}_{w}_aggregate_rtf"] = round(rtf, 1)
        if a["lat"]:
            p50, p95, p99 = _pcts(a["lat"])
            out[f"{prefix}_{w}_verdict_ms_p50"] = p50
            out[f"{prefix}_{w}_verdict_ms_p95"] = p95
            out[f"{prefix}_{w}_verdict_ms_p99"] = p99
        if a.get("errors"):
            # Nonzero means this wire's row is suspect (lost workers /
            # backlog overflows) — never silently folded into the RTF.
            out[f"{prefix}_{w}_client_errors"] = a["errors"]


def bench_daemon(n_streams: int = 64, phase_s: float = 6.0, reps: int = 2,
                 feeds_per_probe: int = 5, chunk_ms: float = 100.0,
                 env=None, warm_s: float = 2.0) -> dict:
    from streamz_tpu.app.fleet import LocalFleet

    tmp = tempfile.mkdtemp(prefix="streamz_daemon_bench_")
    ckpt = os.path.join(tmp, "model.npz")
    make_checkpoint(ckpt)
    fleet = LocalFleet(
        ckpt, n_servers=1, n_streams=n_streams, threshold=0.0,
        env=dict(_child_env(env or None)),
    )
    [(host, port)] = fleet.start()
    clients = []
    frames = _feed_frames(chunk_ms)
    out = {}
    try:
        clients = [
            StreamClient(host, port, timeout=600.0) for _ in range(n_streams)
        ]
        # Warm both wires' dispatch shapes (first feeds compile server-side;
        # the persistent compile cache makes repeats cheap), then reset the
        # server's tick-latency window so compile-length warm ticks cannot
        # contaminate the steady-state p95/p99 this row reports.
        for w in WIRES:
            _run_phase(clients, frames, w, warm_s, feeds_per_probe, chunk_ms)
        clients[0].stats(reset_ticks=True)
        agg = {
            w: {"audio": 0.0, "wall": 0.0, "lat": [], "errors": 0}
            for w in WIRES
        }
        for _ in range(reps):
            for w in WIRES:  # interleaved: both wires see the same phases
                audio, lat, wall, errors = _run_phase(
                    clients, frames, w, phase_s, feeds_per_probe, chunk_ms
                )
                agg[w]["audio"] += audio
                agg[w]["wall"] += wall
                agg[w]["lat"] += lat
                agg[w]["errors"] += errors
        _wire_rows(f"daemon{n_streams}", agg, out)
        stats = clients[0].stats()
        for k in ("tick_ms_p50", "tick_ms_p95", "tick_ms_p99",
                  "ticks_measured", "overflows", "rejected"):
            if k in stats:
                out[f"daemon{n_streams}_{k}"] = stats[k]
        # Exact-parity spot check: a stream fed real audio must finalize.
        assert clients[0].finalize() is not None
    finally:
        for c in clients:
            c.close()
        fleet.stop()
    return out


def bench_fleet(n_servers: int = 2, n_streams: int = 8, phase_s: float = 4.0,
                reps: int = 2, feeds_per_probe: int = 5,
                chunk_ms: float = 100.0) -> dict:
    """The 2-process LocalFleet through round-robin FleetClient placement.

    CPU-pinned children: the row measures the fleet TRANSPORT + placement
    overhead, comparable against the single-daemon CPU row, not against
    device rows.  (On a GPU host LocalFleet would give each child a card of
    its own: a JAX process reserves most of one.)
    """
    from streamz_tpu.app.fleet import FleetClient, LocalFleet

    tmp = tempfile.mkdtemp(prefix="streamz_fleet_bench_")
    ckpt = os.path.join(tmp, "model.npz")
    make_checkpoint(ckpt)
    fleet = LocalFleet(
        ckpt, n_servers=n_servers, n_streams=n_streams, threshold=0.0,
        env=dict(_child_env({"JAX_PLATFORMS": "cpu"})),
    )
    endpoints = fleet.start()
    frames = _feed_frames(chunk_ms)
    out = {}
    fc = None
    try:
        fc = FleetClient(endpoints, timeout=600.0)
        fids = [fc.open() for _ in range(n_streams)]
        # Round-robin placement must actually spread streams.
        assert len({fc.home(f) for f in fids}) == n_servers
        clients = [fc._client(f) for f in fids]
        for w in WIRES:
            _run_phase(clients, frames, w, 1.0, feeds_per_probe, chunk_ms)
        agg = {
            w: {"audio": 0.0, "wall": 0.0, "lat": [], "errors": 0}
            for w in WIRES
        }
        for _ in range(reps):
            for w in WIRES:
                audio, lat, wall, errors = _run_phase(
                    clients, frames, w, phase_s, feeds_per_probe, chunk_ms
                )
                agg[w]["audio"] += audio
                agg[w]["wall"] += wall
                agg[w]["lat"] += lat
                agg[w]["errors"] += errors
        _wire_rows(f"fleet{n_servers}x{n_streams}", agg, out)
        assert fc.finalize(fids[0]) is not None
    finally:
        if fc is not None:
            fc.close_all()
        fleet.stop()
    return out


def _proc_rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def bench_soak(duration_s: float = 60.0, n_streams: int = 6,
               churn_threads: int = 4, env=None) -> dict:
    """Sustained churn against the real daemon subprocess.

    Open/close churn at capacity for ``duration_s`` with a mid-soak
    hot-reload; reports the sustained churn rate, the server process's RSS
    growth between the first-quarter mark and the end (a leak fence), and
    the verdict p99 for the pre-reload vs post-reload halves.
    """
    from streamz_tpu.app.fleet import LocalFleet

    tmp = tempfile.mkdtemp(prefix="streamz_soak_bench_")
    ckpt = os.path.join(tmp, "model.npz")
    make_checkpoint(ckpt)
    fleet = LocalFleet(
        ckpt, n_servers=1, n_streams=n_streams, threshold=0.0,
        env=dict(_child_env(env or None)), watch_model=True,
    )
    [(host, port)] = fleet.start()
    pid = fleet._procs[0].pid
    frames = _feed_frames()
    t_end = time.monotonic() + duration_s
    opens = [0]
    lat = {"pre": [], "post": []}
    stop = threading.Event()

    def churn(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set() and time.monotonic() < t_end:
            try:
                c = StreamClient(host, port, timeout=60)
                try:
                    opens[0] += 1
                    for _ in range(int(rng.integers(2, 6))):
                        c.sock.sendall(frames["i16"])
                    t0 = time.perf_counter()
                    c.current()
                    dt = time.perf_counter() - t0
                    half = ("pre" if time.monotonic() < t_end - duration_s / 2
                            else "post")
                    lat[half].append(dt)
                    if rng.random() < 0.5:
                        c.finalize()
                finally:
                    c.close()
            except Exception:
                pass  # capacity rejection / close races: churn continues

    threads = [
        threading.Thread(target=churn, args=(s,))
        for s in range(churn_threads)
    ]
    for t in threads:
        t.start()
    rss_quarter = 0.0
    reloaded = False
    out = {}
    try:
        while time.monotonic() < t_end:
            elapsed = duration_s - (t_end - time.monotonic())
            if not rss_quarter and elapsed > duration_s / 4:
                rss_quarter = _proc_rss_mb(pid)
            if not reloaded and elapsed > duration_s / 2:
                make_checkpoint(ckpt, classes=6)  # hot-reload mid-soak
                reloaded = True
            time.sleep(0.25)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    try:
        with StreamClient(host, port, timeout=60) as c:
            stats = c.stats()
        rss_end = _proc_rss_mb(pid)
        out = {
            "soak_seconds": round(duration_s, 1),
            "soak_opens_per_sec": round(opens[0] / duration_s, 1),
            "soak_model_reloads": stats.get("model_reloads", 0),
            "soak_rss_quarter_mb": round(rss_quarter, 1),
            "soak_rss_end_mb": round(rss_end, 1),
        }
        for half in ("pre", "post"):
            if lat[half]:
                out[f"soak_verdict_ms_p99_{half}"] = round(
                    float(np.percentile(np.asarray(lat[half]) * 1e3, 99)), 2
                )
    finally:
        fleet.stop()
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    n = 64
    do_fleet = False
    while argv:
        a = argv.pop(0)
        if a == "--daemon-streams":
            n = int(argv.pop(0))
        elif a == "--fleet":
            do_fleet = True
        else:
            raise SystemExit(f"unknown flag {a!r}")
    rows = bench_daemon(n_streams=n)
    if do_fleet:
        rows.update(bench_fleet())
    print(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
