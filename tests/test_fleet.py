"""Multi-host serving harness (app/fleet.py).

`MultiStreamIdentifier` is single-process by design; the multi-host story
is one `SpeakerServer` per host behind round-robin placement.  These tests
launch a REAL two-process fleet (each server its own Python/JAX process —
the per-host layout) and pin the contract that makes horizontal serving
sound: per-stream verdicts are identical to a single-host fleet because
streams are independent of slot placement.
"""

import os
import sys

import numpy as np
import pytest

from streamz_tpu.app.fleet import FleetClient, LocalFleet
from streamz_tpu.app.serve import MultiStreamIdentifier
from streamz_tpu.nn import checkpoint
from streamz_tpu.nn.model import SpeakerNet

_CHILD_ENV = {
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    # The children import streamz_tpu from the repo, not an install.
    "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    + os.pathsep + os.environ.get("PYTHONPATH", ""),
}


def _clip(seed, seconds=0.6):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3000, size=int(44100 * seconds)).astype(np.int16)


@pytest.mark.slow
def test_two_process_fleet_matches_single_host(tmp_path):
    """4 streams round-robined over 2 server processes: every verdict equals
    the single-host batched fleet on the same PCM, and placement actually
    spread the streams across both servers."""
    net = SpeakerNet.new(output=5, seed=0)
    ckpt = str(tmp_path / "model.npz")
    checkpoint.save(net, ckpt)

    clips = [_clip(s) for s in range(4)]

    # Single-host reference: one in-process fleet, same threshold.
    ident = MultiStreamIdentifier(net, n_streams=4, threshold=0.0)
    ref = []
    for c in clips:
        sid = ident.open()
        ident.feed(sid, c)
        ref.append(ident.finalize(sid))
        ident.close(sid)

    with LocalFleet(
        ckpt, n_servers=2, n_streams=2, threshold=0.0,
        tick_interval=0.005, env=_CHILD_ENV,
    ) as fleet:
        endpoints = fleet.start(timeout=300)
        assert len(endpoints) == 2
        # Generous socket timeout: each server child compiles its streaming
        # programs on first use, and this box runs them all on one CPU.
        with FleetClient(endpoints, timeout=600.0) as client:
            fids = [client.open() for _ in clips]
            # Round-robin: both servers got streams.
            assert {client.home(f) for f in fids} == set(endpoints)
            for fid, c in zip(fids, clips):
                for i in range(0, len(c), 4096):
                    client.feed(fid, c[i : i + 4096])
            got = [client.finalize(f) for f in fids]
            stats = client.stats()

    assert len(stats) == 2
    assert all(s["dispatches"] > 0 for s in stats)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            assert g is not None and g[0] == r[0]
            np.testing.assert_allclose(g[1], r[1], rtol=1e-5)


def test_fleet_client_round_robin_and_errors():
    with pytest.raises(ValueError):
        FleetClient([])
    with pytest.raises(ValueError):
        LocalFleet("x.npz", n_servers=0)


@pytest.mark.slow
def test_fleet_server_exits_cleanly_on_bad_checkpoint(tmp_path):
    """A server child that cannot load its checkpoint dies before READY;
    the launcher surfaces that instead of hanging."""
    bad = str(tmp_path / "missing.npz")
    fleet = LocalFleet(bad, n_servers=1, env=_CHILD_ENV)
    with pytest.raises(RuntimeError, match="before READY"):
        fleet.start(timeout=120)
    fleet.stop()


def test_ready_parsed_when_child_logs_before_and_after(monkeypatch):
    """Launcher hazards the drain thread exists for: (a) a log line printed
    immediately before READY must not strand READY in the TextIO buffer
    (a select()-gated readline would time out on this healthy child);
    (b) a child that keeps logging after READY must never block on a full
    stdout pipe — the launcher keeps draining for the fleet's lifetime."""
    import subprocess as sp
    import sys as _sys
    import time as _time

    from streamz_tpu.app.fleet import LocalFleet, _ChildDrain

    # One write() carrying noise + READY + ~200 KB of post-READY logging:
    # the noise and READY land in the same OS read (the buffered-slurp
    # case), and the tail overflows an undrained 64 KB pipe.
    child = (
        "import sys\n"
        "sys.stdout.write('absl WARNING: noisy library\\n'\n"
        "                 'FLEET_READY host=127.0.0.9 port=7777\\n')\n"
        "sys.stdout.flush()\n"
        "for i in range(4000):\n"
        "    print('[serve] tick failed, retrying next tick: e%d' % i)\n"
        "print('DRAINED_OK')\n"
    )
    p = sp.Popen([_sys.executable, "-c", child], stdout=sp.PIPE,
                 stderr=sp.STDOUT, text=True)
    try:
        d = _ChildDrain(p)
        ep = LocalFleet._read_ready(p, d, _time.monotonic() + 60)
        assert ep == ("127.0.0.9", 7777)
        # (b): the child can only finish its 4000 lines if someone drains.
        assert p.wait(timeout=60) == 0
        deadline = _time.monotonic() + 10
        while _time.monotonic() < deadline:
            if any("DRAINED_OK" in ln for ln in d.tail):
                break
            _time.sleep(0.05)
        assert any("DRAINED_OK" in ln for ln in d.tail)
    finally:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)


def test_ready_timeout_on_silent_child():
    """A child that hangs without printing anything trips the deadline
    (bounded by the timeout= budget, not a blocked readline)."""
    import subprocess as sp
    import sys as _sys
    import time as _time

    from streamz_tpu.app.fleet import LocalFleet, _ChildDrain

    p = sp.Popen([_sys.executable, "-c", "import time; time.sleep(600)"],
                 stdout=sp.PIPE, stderr=sp.STDOUT, text=True)
    try:
        d = _ChildDrain(p)
        t0 = _time.monotonic()
        with pytest.raises(TimeoutError, match="did not become ready"):
            LocalFleet._read_ready(p, d, _time.monotonic() + 3)
        assert _time.monotonic() - t0 < 30
    finally:
        p.kill()
        p.wait(timeout=10)


@pytest.mark.slow
def test_fleet_failover_skips_dead_server_and_migrates(tmp_path):
    """Kill one of two servers mid-session: open() skips the dead endpoint
    (lands every new stream on the survivor), reopen() migrates a dead
    stream's handle, and a client-side re-feed reproduces the verdict the
    dead home would have returned (placement independence is exactly what
    makes the failover sound)."""
    net = SpeakerNet.new(output=5, seed=0)
    ckpt = str(tmp_path / "model.npz")
    checkpoint.save(net, ckpt)
    clip = _clip(7)

    with LocalFleet(
        ckpt, n_servers=2, n_streams=4, threshold=0.0,
        tick_interval=0.005, env=_CHILD_ENV,
    ) as fleet:
        endpoints = fleet.start(timeout=300)
        with FleetClient(endpoints, timeout=600.0) as client:
            # Stream 0 lands on server 0; get its reference verdict while
            # both servers are healthy.
            fid = client.open()
            home0 = client.home(fid)
            i0 = endpoints.index(home0)
            client.feed(fid, clip)
            ref = client.finalize(fid)
            assert ref is not None

            fleet.stop_server(i0)
            healthy = endpoints[1 - i0]

            # New streams skip the dead endpoint even when the round-robin
            # cursor points at it.
            f2 = client.open()
            f3 = client.open()
            assert client.home(f2) == client.home(f3) == healthy

            # The dead stream's handle migrates; re-feeding the audio
            # reproduces the reference verdict on the new home.
            new_home = client.reopen(fid)
            assert new_home == healthy
            client.feed(fid, clip)
            got = client.finalize(fid)
            assert got is not None and got[0] == ref[0]
            np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)

            client.close(f2)
            client.close(f3)

            # Every endpoint dead -> a clear ConnectionError from open().
            fleet.stop_server(1 - i0)
            with pytest.raises(ConnectionError, match="no healthy endpoint"):
                client.open()


def test_fleet_children_get_one_card_each(monkeypatch):
    """On a GPU host child i sees only card i of the visible cards, so no
    two children reserve memory on the same card."""
    from streamz_tpu.app import fleet

    envs = fleet._per_card_envs({"CUDA_VISIBLE_DEVICES": "0,1,2,3"}, 3)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2"]
    # The visible-card list is honored as given (a restricted set).
    envs = fleet._per_card_envs({"CUDA_VISIBLE_DEVICES": "5, 7"}, 2)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["5", "7"]
    # Without the variable the cards come from nvidia-smi.
    monkeypatch.setattr(fleet, "_visible_cards", lambda env: ["0", "1"])
    envs = fleet._per_card_envs({}, 2)
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1"]


def test_fleet_refuses_more_children_than_cards(monkeypatch):
    from streamz_tpu.app import fleet

    with pytest.raises(RuntimeError, match="need one GPU each"):
        fleet._per_card_envs({"CUDA_VISIBLE_DEVICES": "0"}, 2)
    monkeypatch.setattr(fleet, "_visible_cards", lambda env: [])
    with pytest.raises(RuntimeError, match="0 are visible"):
        fleet._per_card_envs({}, 1)
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        LocalFleet("x.npz", n_servers=2, env={"JAX_PLATFORMS": "",
                                              "CUDA_VISIBLE_DEVICES": "0"}
                   ).start()


def test_cpu_pinned_fleet_children_share_the_host():
    """JAX_PLATFORMS=cpu (the tests' pin) lets any number of children run,
    and their environment is left as given."""
    from streamz_tpu.app import fleet

    env = {"JAX_PLATFORMS": "cpu", "X": "1"}
    envs = fleet._per_card_envs(env, 3)
    assert envs == [env] * 3
    assert all("CUDA_VISIBLE_DEVICES" not in e for e in envs)


def test_visible_cards_without_nvidia_smi(monkeypatch):
    """No nvidia-smi (a CPU host) means no visible cards, not a crash."""
    from streamz_tpu.app import fleet

    monkeypatch.setenv("PATH", "/nonexistent")
    assert fleet._visible_cards({}) == []
