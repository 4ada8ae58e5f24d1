"""TCP serving daemon (app/server.py).

The network layer must be a transparent transport over
:class:`MultiStreamIdentifier`: every verdict delivered over a socket must
equal the in-process streaming result on the same PCM, slots must recycle
on disconnect, at-capacity connects must be rejected with an ERROR frame,
and the model hot-reload watcher must swap checkpoints without dropping a
connection.
"""

import os
import threading
import time

import numpy as np
import pytest

from streamz_tpu.app.server import (
    OP_ERROR,
    SpeakerServer,
    StreamClient,
    recv_frame,
)
from streamz_tpu.app.stream import StreamingIdentifier
from streamz_tpu.nn import checkpoint
from streamz_tpu.nn.model import SpeakerNet


@pytest.fixture(scope="module")
def net():
    return SpeakerNet.new(output=5, seed=0)


@pytest.fixture()
def server(net):
    srv = SpeakerServer(
        net, port=0, n_streams=4, threshold=0.0, tick_interval=0.005
    )
    srv.start()
    yield srv
    srv.stop()


def _clip(seed=0, seconds=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3000, size=int(44100 * seconds)).astype(np.int16)


def _offline(net, clip, **kw):
    ref = StreamingIdentifier(net, threshold=0.0)
    ref.feed(clip, **kw)
    return ref.finalize()


def _assert_verdict_close(got, ref):
    if ref is None:
        assert got is None
        return
    assert got is not None and got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


def test_round_trip_matches_offline(net, server):
    clip = _clip(seed=1)
    with StreamClient("127.0.0.1", server.port) as c:
        for i in range(0, len(clip), 4096):
            c.feed(clip[i : i + 4096])
        _assert_verdict_close(c.finalize(), _offline(net, clip))


def test_concurrent_clients_are_independent(net, server):
    clips = [_clip(seed=s) for s in range(3)]
    results = {}

    def run(idx):
        with StreamClient("127.0.0.1", server.port) as c:
            clip = clips[idx]
            for i in range(0, len(clip), 2048):
                c.feed(clip[i : i + 2048])
            results[idx] = c.finalize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i, clip in enumerate(clips):
        _assert_verdict_close(results[i], _offline(net, clip))


def test_rolling_current_and_wire_tags(net, server):
    from streamz_tpu.io import g711

    clip = _clip(seed=7)
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(clip[:8192])
        deadline = time.monotonic() + 10
        while c.current() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert c.current() is not None  # rolling verdict before finalize
        c.feed(clip[8192:])
        got = c.finalize()
    # G.711 wire: companded bytes over the socket == host-decoded i16.
    codes = g711.ulaw_encode(clip)
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(codes.tobytes(), wire="ulaw")
        got_u8 = c.finalize()
    ref = _offline(net, g711.decode(codes, "ulaw"))
    _assert_verdict_close(got_u8, ref)
    _assert_verdict_close(got, _offline(net, clip))


def test_slot_recycled_after_disconnect(net):
    srv = SpeakerServer(net, port=0, n_streams=1, tick_interval=0.005)
    srv.start()
    try:
        with StreamClient("127.0.0.1", srv.port) as c:
            c.feed(_clip(seed=2)[:4096])
            c.finalize()
        # The slot frees on disconnect; poll until the server notices.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                with StreamClient("127.0.0.1", srv.port) as c:
                    if c.current() is None:  # fresh slot: no votes
                        return
            except RuntimeError:
                time.sleep(0.02)  # still at capacity: retry
        pytest.fail("slot was not recycled after disconnect")
    finally:
        srv.stop()


def test_at_capacity_connect_rejected(net):
    srv = SpeakerServer(net, port=0, n_streams=1, tick_interval=0.005)
    srv.start()
    try:
        c1 = StreamClient("127.0.0.1", srv.port)
        c1.feed(_clip(seed=3)[:2048])
        c2 = StreamClient("127.0.0.1", srv.port)
        frame = recv_frame(c2.sock)  # server sends ERROR then closes
        assert frame is not None and frame[0] == OP_ERROR
        assert b"slots in use" in frame[1]
        c2.close()
        c1.close()
    finally:
        srv.stop()


def test_stats_frame(net, server):
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(_clip(seed=4)[:4096])
        c.finalize()
        s = c.stats()
    assert s["connections"] >= 1
    assert s["accepted"] >= 1
    assert s["n_slots"] == 4
    assert s["dispatches"] >= 1
    assert set(s["wire_dispatches"]) == {"u8", "i16", "f32"}


def test_bad_feed_keeps_connection(net, server):
    clip = _clip(seed=5)
    with StreamClient("127.0.0.1", server.port) as c:
        c.feed(clip[:4096])
        assert c.finalize() is not None
        # Feeding a finalized stream is a per-message error: the server
        # reports it and the connection survives.
        c.feed(clip[:400])
        with pytest.raises(RuntimeError, match="finalized"):
            c.current()
        # The socket is still usable for stats.
        assert c.stats()["accepted"] >= 1


def test_backpressure_cap(net):
    """A client flooding PCM past ``max_buffered_samples`` gets the
    overflow reported (sticky ERROR on the next verdict request), the
    chunk is dropped, and the stream keeps serving afterwards."""
    srv = SpeakerServer(
        net,
        port=0,
        n_streams=2,
        threshold=0.0,
        tick_interval=10.0,  # ticker effectively idle: backlog builds
        max_buffered_samples=10_000,
    )
    srv.start()
    try:
        with StreamClient("127.0.0.1", srv.port) as c:
            c.feed(_clip(seed=8)[:8000])
            c.feed(_clip(seed=8)[:8000])  # 16000 > cap: dropped
            with pytest.raises(RuntimeError, match="max_buffered_samples"):
                c.current()
            assert c.stats()["overflows"] == 1
            # The stream survives: the within-cap audio still finalizes.
            assert c.finalize() is not None
    finally:
        srv.stop()


def test_cli_serve_mode(net, tmp_path):
    """``--serve`` end-to-end: the CLI loads model.npz, prints the bound
    port, and serves the same verdicts as in-process streaming."""
    import subprocess
    import sys as _sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkpoint.save(net, str(tmp_path / "model.npz"))
    runner = (
        "import os, sys\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"sys.path.insert(0, {repo!r})\n"
        "from streamz_tpu.cli import main\n"
        "sys.exit(main(['--serve', '0', '--serve-streams', '4',"
        " '--threshold', '0']))\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [_sys.executable, "-u", "-c", runner],
        cwd=str(tmp_path),
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        port = None
        deadline = time.monotonic() + 180
        lines = []
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("Serving"):
                port = int(line.split("127.0.0.1:")[1].split()[0])
                break
        assert port is not None, "".join(lines)[-3000:]
        clip = _clip(seed=9)
        with StreamClient("127.0.0.1", port, timeout=120.0) as c:
            for i in range(0, len(clip), 8192):
                c.feed(clip[i : i + 8192])
            got = c.finalize()
        _assert_verdict_close(got, _offline(net, clip))
        # SIGTERM (what orchestrators send) triggers a graceful stop:
        # the daemon exits 0, not killed-by-signal.
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


def test_model_hot_reload(net, tmp_path):
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    srv = SpeakerServer(
        net,
        port=0,
        n_streams=2,
        threshold=0.0,
        tick_interval=0.005,
        watch_model=path,
        watch_interval=0.02,
    )
    srv.start()
    try:
        with StreamClient("127.0.0.1", srv.port) as c:
            clip = _clip(seed=6)
            c.feed(clip[: len(clip) // 2])
            # Grow the model and save; the watcher should hot-swap without
            # dropping the live connection.
            grown = SpeakerNet.new(output=5, seed=0)
            for _ in range(4):
                grown.add_output_class()
            time.sleep(0.05)  # ensure a strictly newer mtime
            checkpoint.save(grown, path)
            os.utime(path)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if c.stats().get("model_reloads", 0) >= 1:
                    break
                time.sleep(0.02)
            assert c.stats()["model_reloads"] >= 1
            assert srv.ident.net.num_speakers == grown.num_speakers
            # The live stream keeps working across the swap and its verdict
            # matches offline streaming with the same mid-stream swap.
            c.feed(clip[len(clip) // 2 :])
            got = c.finalize()
        ref = StreamingIdentifier(net, threshold=0.0)
        ref.feed(clip[: len(clip) // 2])
        ref.update_model(srv.ident.net)
        ref.feed(clip[len(clip) // 2 :])
        _assert_verdict_close(got, ref.finalize())
    finally:
        srv.stop()


def test_ticker_survives_device_errors(net, monkeypatch):
    """An exception escaping a batched tick (a transient device error, OOM) must not
    kill the ticker thread — the daemon would otherwise look alive while
    serving nothing.  The failed tick retries and the stream completes."""
    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0,
                        tick_interval=0.005)
    fails = {"n": 2}
    real_tick = srv.ident.tick

    def flaky_tick(*a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("injected device failure")
        return real_tick(*a, **kw)

    monkeypatch.setattr(srv.ident, "tick", flaky_tick)
    srv.start()
    try:
        clip = _clip(seed=11)
        with StreamClient("127.0.0.1", srv.port) as c:
            c.feed(clip)
            deadline = time.time() + 30
            while fails["n"] > 0 and time.time() < deadline:
                time.sleep(0.01)
            assert fails["n"] == 0, "ticker died before retrying"
            _assert_verdict_close(c.finalize(), _offline(net, clip))
    finally:
        srv.stop()


def test_at_capacity_reject_always_closes(net, monkeypatch):
    """A failed ERROR send to an at-capacity client must still close the
    accepted socket (fd-leak guard)."""
    import streamz_tpu.app.server as server_mod

    srv = SpeakerServer(net, port=0, n_streams=1, threshold=0.0,
                        tick_interval=0.05)
    real_send = server_mod.send_frame

    def failing_send(sock, opcode, payload=b""):
        if opcode == OP_ERROR:
            raise BrokenPipeError("client already gone")
        return real_send(sock, opcode, payload)

    monkeypatch.setattr(server_mod, "send_frame", failing_send)
    srv.start()
    try:
        c1 = StreamClient("127.0.0.1", srv.port)  # claims the only slot
        time.sleep(0.05)
        c2 = StreamClient("127.0.0.1", srv.port)  # rejected; send fails
        deadline = time.time() + 10
        while srv.stats()["rejected"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert srv.stats()["rejected"] == 1
        # The reject socket was closed server-side despite the send error.
        c2.sock.settimeout(5.0)
        assert c2.sock.recv(1) == b""  # EOF, not a hang
        c2.close()
        c1.close()
    finally:
        srv.stop()


def test_c_client_end_to_end(net, tmp_path):
    """The bundled C client (examples/client.c) — no Python on the client
    side — feeds i16 PCM over the wire and reads back the same verdict as
    in-process streaming, substantiating the any-language protocol claim."""
    import shutil
    import subprocess

    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        pytest.skip("no C compiler")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, "examples", "client.c")
    exe = str(tmp_path / "client")
    subprocess.run([cc, "-O2", "-o", exe, src], check=True)

    srv = SpeakerServer(net, port=0, n_streams=2, threshold=0.0,
                        tick_interval=0.005)
    srv.start()
    try:
        clip = _clip(seed=13)
        out = subprocess.run(
            [exe, "127.0.0.1", str(srv.port)],
            input=clip.astype("<i2").tobytes(),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            timeout=120,
        )
        assert out.returncode == 0, out.stderr.decode()
        text = out.stdout.decode().strip()
        ref = _offline(net, clip)
        if ref is None:
            assert text == "none"
        else:
            parts = text.split()
            assert parts[0] == "speaker" and int(parts[1]) == ref[0]
            np.testing.assert_allclose(float(parts[3]), ref[1], rtol=1e-4)
    finally:
        srv.stop()


def test_protocol_fuzz_server_stays_healthy(net):
    """Garbage frames (random opcodes, oversized lengths, truncated
    headers, raw junk bytes) must only ever cost the offending connection
    — the listener, the ticker, and well-behaved clients keep working."""
    import socket as _socket
    import struct as _struct

    srv = SpeakerServer(net, port=0, n_streams=4, threshold=0.0,
                        tick_interval=0.005)
    srv.start()
    try:
        rng = np.random.default_rng(99)
        for trial in range(20):
            s = _socket.create_connection(("127.0.0.1", srv.port), timeout=10)
            try:
                kind = trial % 4
                if kind == 0:  # random opcode + small random payload
                    op = int(rng.integers(0x05, 0x7F))
                    payload = rng.bytes(int(rng.integers(0, 64)))
                    s.sendall(_struct.pack("<BI", op, len(payload)) + payload)
                elif kind == 1:  # oversized declared length
                    s.sendall(_struct.pack("<BI", 0x01, (1 << 24) + 1))
                elif kind == 2:  # truncated header
                    s.sendall(b"\x01\x02")
                    s.shutdown(_socket.SHUT_WR)
                else:  # pure junk
                    s.sendall(rng.bytes(int(rng.integers(1, 256))))
                s.settimeout(5)
                try:
                    while s.recv(4096):
                        pass  # drain until server closes (or timeout)
                except OSError:
                    pass
            finally:
                s.close()
        # Server is still fully functional for a legitimate client.
        clip = _clip(seed=21)
        with StreamClient("127.0.0.1", srv.port) as c:
            for i in range(0, len(clip), 8192):
                c.feed(clip[i : i + 8192])
            _assert_verdict_close(c.finalize(), _offline(net, clip))
    finally:
        srv.stop()


def test_model_rollback_hot_reload(net, tmp_path):
    """A rollback that lands with an OLDER mtime (mv/rsync -t preserve
    timestamps) must still hot-load: change detection is the stat
    signature (mtime_ns, size, inode), not a monotone mtime compare."""
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    srv = SpeakerServer(
        net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005,
        watch_model=path, watch_interval=0.02,
    )
    srv.start()
    try:
        grown = SpeakerNet.new(output=5, seed=0)
        for _ in range(4):
            grown.add_output_class()
        time.sleep(0.05)
        checkpoint.save(grown, path)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if srv.stats().get("model_reloads", 0) >= 1:
                break
            time.sleep(0.02)
        assert srv.stats()["model_reloads"] >= 1

        # Roll back to an equal-capacity earlier version, mimicking
        # `mv model.bak model.npz`: new inode, strictly OLDER mtime.
        rolled = SpeakerNet.new(output=5, seed=1)
        for _ in range(4):
            rolled.add_output_class()
        bak = str(tmp_path / "model.bak")
        checkpoint.save(rolled, bak)
        old = time.time() - 3600
        os.utime(bak, (old, old))
        os.replace(bak, path)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if srv.stats().get("model_reloads", 0) >= 2:
                break
            time.sleep(0.02)
        assert srv.stats()["model_reloads"] >= 2
        np.testing.assert_array_equal(
            np.asarray(srv.ident.net.params["w1"]),
            np.asarray(rolled.params["w1"]),
        )
    finally:
        srv.stop()


def test_idle_timeout_reaps_slot(net):
    """A silent connection past idle_timeout is dropped and its slot
    released — an idle peer cannot park the fleet at capacity forever."""
    srv = SpeakerServer(
        net, port=0, n_streams=1, threshold=0.0, tick_interval=0.005,
        idle_timeout=0.5,
    )
    srv.start()
    try:
        c = StreamClient("127.0.0.1", srv.port)
        c.feed(_clip(seed=1, seconds=0.2))
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            s = srv.stats()
            if s["open_slots"] == 0 and s["idle_dropped"] >= 1:
                break
            time.sleep(0.05)
        s = srv.stats()
        assert s["open_slots"] == 0 and s["idle_dropped"] >= 1
        c.close()
        # the reaped slot is reusable
        with StreamClient("127.0.0.1", srv.port) as c2:
            c2.feed(_clip(seed=2, seconds=0.3))
            assert c2.finalize() is not None or True  # protocol round-trips
    finally:
        srv.stop()


def test_client_converts_linear_pcm_onto_narrow_wires(net, server):
    """Floats forced onto the i16 / G.711 wires must SCALE, not truncate:
    feeding clip/32767 as floats with wire='i16' is bit-identical to
    feeding the i16 clip (round-trip exact), and wire='ulaw' from floats
    equals client-side companding of the same i16 samples."""
    from streamz_tpu.io import g711

    clip = _clip(seed=9, seconds=0.6)
    fclip = clip.astype(np.float32) / 32767.0

    with StreamClient("127.0.0.1", server.port) as a, \
         StreamClient("127.0.0.1", server.port) as b:
        a.feed(clip)                      # native i16 wire
        b.feed(fclip, wire="i16")        # floats scaled onto the i16 wire
        ra, rb = a.finalize(), b.finalize()
    assert rb == ra  # exact: round(f * 32767) round-trips every i16

    with StreamClient("127.0.0.1", server.port) as a, \
         StreamClient("127.0.0.1", server.port) as b:
        a.feed(g711.ulaw_encode(clip).tobytes(), wire="ulaw")
        b.feed(fclip, wire="ulaw")       # floats companded client-side
        ra, rb = a.finalize(), b.finalize()
    assert rb == ra

    # unit-level: the scale helper clips, never wraps
    lin = StreamClient._linear_i16(np.array([2.0, -2.0, 0.5], np.float32))
    assert lin.tolist() == [32767, -32768, 16384]
    lin = StreamClient._linear_i16(np.array([70000, -70000], np.int32))
    assert lin.tolist() == [32767, -32768]


def test_stats_report_tick_latency_percentiles(net, server):
    """The serving tail-latency ledger: after working
    ticks, STATS carries p50/p95/p99 of working-tick wall time; idle ticks
    are excluded (the count tracks dispatches, not wall-clock polls)."""
    with StreamClient("127.0.0.1", server.port) as c:
        for seed in range(3):
            c.feed(_clip(seed=seed, seconds=0.3))
            c.current()
        # The ticker runs on its own thread: under a contended CPU the
        # first WORKING tick may land after our feeds return, so poll.
        deadline = time.monotonic() + 30
        s = c.stats()
        while "ticks_measured" not in s and time.monotonic() < deadline:
            time.sleep(0.05)
            s = c.stats()
    assert s["ticks_measured"] >= 1, s
    assert 0 < s["tick_ms_p50"] <= s["tick_ms_p95"] <= s["tick_ms_p99"]
    # Bounded memory: the deque caps the sample window.
    assert s["ticks_measured"] <= 4096


def test_corrupt_checkpoint_dropin_never_takes_down_serving(net, tmp_path):
    """Watcher half: hostile/corrupt files dropped over the
    watched checkpoint while streams are live must be skipped cleanly —
    the daemon keeps serving on the old model, and a subsequent GOOD
    checkpoint still hot-swaps."""
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    srv = SpeakerServer(
        net, port=0, n_streams=2, threshold=0.0, tick_interval=0.005,
        watch_model=path, watch_interval=0.02,
    )
    srv.start()
    try:
        with StreamClient("127.0.0.1", srv.port) as c:
            clip = _clip(seed=9)
            c.feed(clip[: len(clip) // 3])
            with open(path, "rb") as f:
                good_blob = f.read()
            rng = np.random.default_rng(3)
            corruptions = [
                good_blob[: len(good_blob) // 2],        # truncated zip
                b"\x00" * 1024,                           # not a zip at all
                bytes(
                    b ^ (1 << int(rng.integers(0, 8)))
                    if i in set(rng.integers(0, len(good_blob), 40)) else b
                    for i, b in enumerate(good_blob)
                ),                                        # bit-flipped
            ]
            for i, blob in enumerate(corruptions):
                time.sleep(0.05)
                with open(path, "wb") as f:
                    f.write(blob)
                os.utime(path)
                time.sleep(0.15)  # several watch polls see the bad file
                # Still serving on the OLD model: feeds and verdicts work
                # (threshold=0 and the stream has processed audio, so a
                # live verdict must exist — None here would mean the
                # corrupt drop-in actually broke serving).
                c.feed(clip[len(clip) // 3 :][: 4410])
                assert c.current() is not None, f"corruption {i}"
                assert c.stats()["model_reloads"] == 0, f"corruption {i}"
            # A good checkpoint afterwards still swaps in.
            grown = SpeakerNet.new(output=5, seed=0)
            grown.add_output_class()
            time.sleep(0.05)
            checkpoint.save(grown, path)
            os.utime(path)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if c.stats().get("model_reloads", 0) >= 1:
                    break
                time.sleep(0.02)
            assert c.stats()["model_reloads"] >= 1
            assert c.finalize() is not None
    finally:
        srv.stop()


def _vm_rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return 0.0


@pytest.mark.slow
def test_daemon_soak_churn_reaping_reload_rollback(net, tmp_path):
    """Serving soak under churn — the serving analogue of
    the corpus soak in test_scale.py: ~90 s of open/close churn at
    capacity with idle reaping active, one mid-soak hot-reload and one
    rollback, asserting zero slot leakage, bounded RSS growth, and a
    verdict-latency p99 that stays in band across the reloads."""
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    with open(path, "rb") as f:
        original_blob = f.read()
    srv = SpeakerServer(
        net, port=0, n_streams=6, threshold=0.0, tick_interval=0.005,
        watch_model=path, watch_interval=0.05, idle_timeout=0.5,
    )
    srv.start()
    duration = 90.0
    t_end = time.monotonic() + duration
    opens = [0]
    lat_pre, lat_post = [], []
    errors = []
    stop = threading.Event()

    def churn(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set() and time.monotonic() < t_end:
            try:
                with StreamClient("127.0.0.1", srv.port, timeout=60) as c:
                    opens[0] += 1
                    clip = rng.normal(
                        0, 3000, size=int(44100 * rng.uniform(0.2, 0.6))
                    ).astype(np.int16)
                    c.feed(clip)
                    t0 = time.perf_counter()
                    c.current()
                    dt = time.perf_counter() - t0
                    (lat_pre if time.monotonic() < t_end - duration / 2
                     else lat_post).append(dt)
                    if rng.random() < 0.5:
                        c.finalize()
            except (RuntimeError, BrokenPipeError, ConnectionError, OSError):
                # Expected churn outcomes: at-capacity rejection (ERROR
                # frame, or the server already closed the socket so the
                # next write breaks the pipe) and idle-reap racing a feed.
                pass
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    def idler():
        # Silent connections: idle_timeout must reap them, releasing slots.
        while not stop.is_set() and time.monotonic() < t_end:
            try:
                c = StreamClient("127.0.0.1", srv.port, timeout=60)
                time.sleep(1.2)  # > idle_timeout: server reaps
                c.close()
            except Exception:
                time.sleep(0.2)

    threads = [
        threading.Thread(target=churn, args=(s,)) for s in range(4)
    ] + [threading.Thread(target=idler)]
    for t in threads:
        t.start()
    rss_quarter = None
    reloaded = rolled_back = False
    try:
        while time.monotonic() < t_end:
            elapsed = duration - (t_end - time.monotonic())
            if rss_quarter is None and elapsed > duration / 4:
                rss_quarter = _vm_rss_mb()
            if not reloaded and elapsed > duration / 3:
                grown = SpeakerNet.new(output=5, seed=0)
                grown.add_output_class()
                checkpoint.save(grown, path)
                os.utime(path)
                reloaded = True
            if not rolled_back and elapsed > 2 * duration / 3:
                # Rollback: an mv-style drop-in of the ORIGINAL bytes (the
                # stat-signature watcher must catch the inode change).
                tmp2 = path + ".roll"
                with open(tmp2, "wb") as f:
                    f.write(original_blob)
                os.replace(tmp2, path)
                rolled_back = True
            time.sleep(0.25)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    try:
        s = srv.stats()
        assert not errors, errors[:5]
        assert opens[0] > 50, f"churn too slow to be a soak: {opens[0]} opens"
        assert s["idle_dropped"] >= 1, s
        assert s["model_reloads"] >= 2, s  # the grow AND the rollback
        # Zero slot leakage: with every client gone, all slots free again.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(srv.ident._open):
            time.sleep(0.1)
        assert not any(srv.ident._open), srv.ident._open
        assert srv.stats()["connections"] == 0
        # Bounded RSS: no monotone leak across ~thousands of slot cycles.
        rss_end = _vm_rss_mb()
        assert rss_end < rss_quarter * 1.3 + 200, (rss_quarter, rss_end)
        # p99 stability across the reload+rollback (generous band: this
        # box has one contended CPU).
        p99_pre = float(np.percentile(lat_pre, 99))
        p99_post = float(np.percentile(lat_post, 99))
        assert p99_post < 10 * p99_pre + 0.25, (p99_pre, p99_post)
    finally:
        srv.stop()
