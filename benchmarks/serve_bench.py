"""Multi-stream serving throughput: aggregate real-time factor vs slots.

Each tick feeds every open stream one ``chunk_ms`` chunk of PCM and issues
ONE batched device dispatch (`app/serve.py`); a slot's audio advances
``chunk_ms`` per tick, so

    aggregate_rtf = n_streams * chunk_ms/1000 * ticks_per_second.

The host loop (chunk buffering, padding, device transfer) is deliberately
inside the measurement — this is the serving number, not a kernel number.
Timing ends each measurement with a one-scalar readback, which waits for
the last tick's device work.

Usage: python benchmarks/serve_bench.py [slots ...]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _encode_wire(chunks_i16: np.ndarray, wire: str):
    """(encoded chunk array, feed encoding tag) for one wire format."""
    if wire == "i16":
        return chunks_i16, None
    if wire == "f32":
        return chunks_i16.astype(np.float32) / 32767.0, None
    if wire in ("ulaw", "alaw"):
        # The telephony wire: G.711 bytes shipped raw, expanded on device —
        # half the i16 transfer (the measured serving bottleneck).
        from streamz_tpu.io import g711

        enc = g711.ulaw_encode if wire == "ulaw" else g711.alaw_encode
        return np.stack([enc(c) for c in chunks_i16]), wire
    raise ValueError(f"unknown wire {wire!r}")


def _make_fleet(n_streams: int, chunk_ms: float, wires):
    from streamz_tpu.app.serve import MultiStreamIdentifier
    from streamz_tpu.nn.model import SpeakerNet

    net = SpeakerNet.new(output=5, seed=0)
    srv = MultiStreamIdentifier(net, n_streams=n_streams, threshold=0.0)
    sids = [srv.open() for _ in range(n_streams)]

    rng = np.random.default_rng(0)
    chunk_len = int(44100 * chunk_ms / 1000.0)
    chunks_i16 = rng.normal(0, 3000, size=(n_streams, chunk_len)).astype(np.int16)
    per_wire = {w: _encode_wire(chunks_i16, w) for w in wires}

    def one_tick(wire: str):
        chunks, enc = per_wire[wire]
        for sid in sids:
            srv.feed(sid, chunks[sid], encoding=enc)
        srv.tick()

    def fence():
        # Read back one scalar to wait for the device work: the last
        # carry element is the per-slot window count ([S] int32) — indexed
        # from the end so inserting new per-slot state (e.g. the Kahan
        # compensation array) does not silently break the fence.
        float(np.asarray(srv._carry[-1][0]))

    return one_tick, fence


def _row(n_streams: int, chunk_ms: float, wire: str, tick_s: float):
    rtf = n_streams * (chunk_ms / 1000.0) / tick_s
    return {
        "streams": n_streams,
        "wire": wire,
        "tick_ms": round(tick_s * 1e3, 2),
        "aggregate_rtf": round(rtf, 1),
        "rtf_per_stream": round(rtf / n_streams, 2),
    }


def bench_slots(n_streams: int, chunk_ms: float = 100.0, ticks: int = 30,
                wire: str = "i16"):
    one_tick, fence = _make_fleet(n_streams, chunk_ms, (wire,))

    for _ in range(3):  # warm: compile + autotune settle
        one_tick(wire)
    fence()

    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        for _ in range(ticks):
            one_tick(wire)
        fence()
        best = min(best, (time.perf_counter() - start) / ticks)
    return _row(n_streams, chunk_ms, wire, best)


def bench_slots_interleaved(n_streams: int, chunk_ms: float = 100.0,
                            ticks: int = 10, reps: int = 3,
                            wires=("i16", "ulaw")):
    """All wires on ONE fleet, measurement batches interleaved wire-wise.

    Sequential per-wire sweeps let a slow phase of the host land entirely on
    one wire and masquerade as a wire effect.  Here every rep times a short
    batch of ticks for wire A, then wire B, then back: both wires sample the
    same phases, so only the genuine wire cost separates them.

    Returns {wire: row} with the same row shape as :func:`bench_slots`.
    """
    one_tick, fence = _make_fleet(n_streams, chunk_ms, wires)

    for w in wires:  # warm every wire's dispatch shape before any timing
        for _ in range(3):
            one_tick(w)
    fence()

    best = {w: float("inf") for w in wires}
    for _ in range(reps):
        for w in wires:
            start = time.perf_counter()
            for _ in range(ticks):
                one_tick(w)
            fence()
            best[w] = min(best[w], (time.perf_counter() - start) / ticks)
    return {w: _row(n_streams, chunk_ms, w, best[w]) for w in wires}


def main():
    args = sys.argv[1:]
    wire = None
    wires = None
    interleave = False
    while args and args[0].startswith("--"):
        if args[0].startswith("--wire="):
            wire = args.pop(0).split("=", 1)[1]
        elif args[0].startswith("--wires="):
            wires = tuple(args.pop(0).split("=", 1)[1].split(","))
        elif args[0] == "--interleaved":
            interleave = True
            args.pop(0)
        else:
            raise SystemExit(f"unknown flag {args[0]!r}")
    if interleave and wire is not None:
        # Refusing beats silently measuring the default pair under the
        # user's requested-wire label.
        raise SystemExit("--interleaved takes --wires=a,b (not --wire=)")
    if not interleave and wires is not None:
        raise SystemExit("--wires= only applies with --interleaved")
    slot_counts = [int(a) for a in args] or [16, 64, 256]
    for s in slot_counts:
        if interleave:
            rows = bench_slots_interleaved(
                s, **({"wires": wires} if wires else {})
            )
            for row in rows.values():
                print(row)
        else:
            print(bench_slots(s, wire=wire or "i16"))


if __name__ == "__main__":
    main()
