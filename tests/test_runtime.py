"""Runtime utilities: phase timer, trace no-op, watchdog."""

import os
import time

from streamz_tpu.runtime.profiler import PhaseTimer, trace
from streamz_tpu.runtime.watchdog import watchdog


def test_phase_timer_accumulates():
    t = PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("b"):
        pass
    assert t.phases["a"] >= 0.02
    rep = t.report()
    assert "a" in rep and "b" in rep and "total" in rep


def test_trace_noop_without_dir():
    with trace(None):
        pass  # must not require jax or start a profiler


def test_watchdog_fires_and_clears(capsys):
    with watchdog("fast-phase", timeout_s=60.0):
        pass  # finishes long before the deadline; no output
    assert "[watchdog]" not in capsys.readouterr().err

    with watchdog("slow-phase", timeout_s=0.05):
        time.sleep(0.3)
    err = capsys.readouterr().err
    assert "slow-phase" in err and "[watchdog]" in err


def test_chain_timer_times_and_preserves_math():
    """The shared chained-scan timer (runtime/measure.py) returns a sane
    per-iteration time and its carry/consumer fences don't break the timed
    function's shapes or dtypes."""
    import jax.numpy as jnp

    from streamz_tpu.runtime.measure import chain_timer

    a = jnp.ones((64, 64), jnp.bfloat16)
    b = jnp.ones((64, 64), jnp.bfloat16)
    t = chain_timer(
        lambda x, y: jnp.dot(x, y, preferred_element_type=jnp.float32),
        a, b, iters=4, repeats=2,
    )
    assert 0.0 < t < 10.0
    t_best = chain_timer(
        lambda x, y: jnp.dot(x, y, preferred_element_type=jnp.float32),
        a, b, iters=4, repeats=2, best=True,
    )
    assert 0.0 < t_best <= t * 10  # min-of-repeats is a time, too


def test_no_autotune_escape(monkeypatch, tmp_path):
    """STREAMZ_NO_AUTOTUNE=1 skips measurement probes (static default, no
    pinning) while cached decisions are still honored."""
    import json

    from streamz_tpu.runtime import autotune

    monkeypatch.setattr(autotune, "on_gpu", lambda: True)
    cache = tmp_path / "cache.json"
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(cache))
    monkeypatch.setenv("STREAMZ_NO_AUTOTUNE", "1")
    autotune.reset()

    probed = {"n": 0}

    def probe():
        probed["n"] += 1
        return 1.0

    # Cold cache: default wins, nothing probed, nothing pinned.
    got = autotune.measured_choice("t_stage", {"a": probe, "b": probe}, "b")
    assert got == "b" and probed["n"] == 0
    assert not cache.exists()

    # A cached decision still applies without probing.
    import jax

    key = f"t_stage:{jax.devices()[0].device_kind}"
    cache.write_text(json.dumps({key: {"choice": "a",
                                       "candidates": ["a", "b"]}}))
    autotune.reset()
    got = autotune.measured_choice("t_stage", {"a": probe, "b": probe}, "b")
    assert got == "a" and probed["n"] == 0

    # With the escape off, the probe runs and pins the winner.
    monkeypatch.delenv("STREAMZ_NO_AUTOTUNE")
    cache.unlink()
    autotune.reset()
    got = autotune.measured_choice("t_stage", {"a": probe, "b": probe}, "b")
    assert probed["n"] == 2
    autotune.reset()


def test_autotune_cache_invalidated_by_new_candidate(monkeypatch, tmp_path):
    """A stored decision is versioned by the candidate set it was measured
    against: shipping a new kernel re-probes instead of keeping a stale
    winner; an unchanged set keeps honoring the cache."""
    import json

    import jax

    from streamz_tpu.runtime import autotune

    monkeypatch.setattr(autotune, "on_gpu", lambda: True)
    cache = tmp_path / "cache.json"
    monkeypatch.setattr(autotune, "_CACHE_PATH", str(cache))
    monkeypatch.delenv("STREAMZ_NO_AUTOTUNE", raising=False)
    autotune.reset()

    probed = {"n": 0}

    def mk(t):
        def probe():
            probed["n"] += 1
            return t
        return probe

    # Measure with two candidates; 'a' wins and is pinned with its set.
    got = autotune.measured_choice("t_inv", {"a": mk(1.0), "b": mk(2.0)}, "b")
    assert got == "a" and probed["n"] == 2
    key = f"t_inv:{jax.devices()[0].device_kind}"
    entry = json.loads(cache.read_text())[key]
    assert entry == {"choice": "a", "candidates": ["a", "b"]}

    # Same candidate set in a fresh process: cache honored, no probe.
    autotune.reset()
    got = autotune.measured_choice("t_inv", {"a": mk(1.0), "b": mk(2.0)}, "b")
    assert got == "a" and probed["n"] == 2

    # A third candidate appears: the stale entry must not win silently —
    # all three are probed and the new fastest is pinned.
    autotune.reset()
    got = autotune.measured_choice(
        "t_inv", {"a": mk(1.0), "b": mk(2.0), "c": mk(0.5)}, "b"
    )
    assert got == "c" and probed["n"] == 5

    monkeypatch.setenv("STREAMZ_NO_AUTOTUNE", "1")

    # Probing disabled + a versioned entry from an OLDER candidate set:
    # since no re-measure will happen, a still-valid measured winner beats
    # the static default (a fleet pinned to --no-autotune must not lose its
    # measured kernels on upgrade).
    cache.write_text(
        json.dumps({key: {"choice": "a", "candidates": ["a", "b"]}})
    )
    autotune.reset()
    got = autotune.measured_choice(
        "t_inv", {"a": mk(1.0), "b": mk(2.0), "c": mk(0.5)}, "b"
    )
    assert got == "a" and probed["n"] == 5
    # ...but a retired winner falls back to the default, memoized so the
    # JSON is not re-read every call.
    cache.write_text(
        json.dumps({key: {"choice": "zz", "candidates": ["b", "zz"]}})
    )
    autotune.reset()
    got = autotune.measured_choice("t_inv", {"a": mk(1.0), "b": mk(2.0)}, "b")
    assert got == "b" and probed["n"] == 5
    cache.unlink()  # memoized: the missing file must not be consulted again
    got = autotune.measured_choice("t_inv", {"a": mk(1.0), "b": mk(2.0)}, "b")
    assert got == "b" and probed["n"] == 5
    autotune.reset()


def test_autotune_disk_put_concurrent_writers(monkeypatch, tmp_path):
    """Concurrent cold processes probing different stages must not drop each
    other's cached decisions (locked read-modify-write + atomic replace)."""
    import json
    import subprocess
    import sys

    cache = tmp_path / "cache.json"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", (
                "import streamz_tpu.runtime.autotune as at\n"
                f"at._CACHE_PATH = {str(cache)!r}\n"
                f"at._disk_put('stage{i}:kind', {{'choice': 'a', 'candidates': ['a']}})\n"
            )],
            cwd="/root/repo",
        )
        for i in range(8)
    ]
    for p in procs:
        assert p.wait(timeout=120) == 0
    data = json.loads(cache.read_text())
    assert sorted(data) == [f"stage{i}:kind" for i in range(8)]
    assert not list(tmp_path.glob("*.tmp.*"))  # no leftover temp files


def test_autotune_cache_path_is_per_user(monkeypatch):
    """The default disk-cache path embeds the uid: a fixed world-shared
    /tmp path breaks the second user on a shared machine (their lockfile
    writes fail silently; they read another user's decisions)."""
    import importlib

    import streamz_tpu.runtime.autotune as at

    monkeypatch.delenv("STREAMZ_AUTOTUNE_CACHE", raising=False)
    assert f"-{os.getuid()}" in at._default_cache_path()
    # The env override stays authoritative.
    monkeypatch.setenv("STREAMZ_AUTOTUNE_CACHE", "/tmp/shared_team.json")
    at2 = importlib.reload(at)
    try:
        assert at2._CACHE_PATH == "/tmp/shared_team.json"
    finally:
        monkeypatch.delenv("STREAMZ_AUTOTUNE_CACHE")
        importlib.reload(at)


def test_measured_choice_raises_on_failing_probe(monkeypatch, tmp_path):
    """A candidate whose probe raises is an error: the exception reaches the
    caller, and nothing is memoized or persisted, so the stage never
    silently settles on the default."""
    import pytest

    from streamz_tpu.runtime import autotune

    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "c.json"))
    monkeypatch.setattr(autotune, "on_gpu", lambda: True)
    monkeypatch.setattr(autotune, "probing_disabled", lambda: False)
    autotune._memory.clear()

    def failing_probe():
        raise RuntimeError("kernel refused")

    for _ in range(2):
        with pytest.raises(RuntimeError, match="kernel refused"):
            autotune.measured_choice(
                "probefail", {"a": lambda: 1.0, "b": failing_probe}, "a"
            )
    assert not autotune._memory
    assert autotune._disk_get("probefail:" + _device_kind()) is None


def test_measured_choice_takes_default_off_the_gpu(monkeypatch):
    """Off the GPU no probe runs: the static default is the answer."""
    from streamz_tpu.runtime import autotune

    monkeypatch.setattr(autotune, "on_gpu", lambda: False)
    monkeypatch.setattr(autotune, "probing_disabled", lambda: False)
    autotune.reset()

    def probe():
        raise AssertionError("must not probe")

    assert autotune.measured_choice("t_cpu", {"a": probe, "b": probe}, "b") == "b"
    autotune.reset()


def _device_kind():
    import jax

    return jax.devices()[0].device_kind


def test_autotune_cache_heals_corrupt_file(tmp_path, monkeypatch):
    """A corrupt cache file must not permanently disable persistence: the
    next successful put rewrites a clean file (previously every write
    raised at json.load before the dump, silently re-running every probe
    in every new process forever)."""
    import json

    from streamz_tpu.runtime import autotune

    path = str(tmp_path / "tune.json")
    with open(path, "w") as f:
        f.write("{ not json !!")
    monkeypatch.delenv("STREAMZ_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setattr(autotune, "_CACHE_PATH", path)
    autotune._disk_put("stage:dev", {"choice": "a", "candidates": ["a"]})
    with open(path) as f:
        data = json.load(f)
    assert data["stage:dev"]["choice"] == "a"
    # non-dict top level heals the same way
    with open(path, "w") as f:
        json.dump(["not", "a", "dict"], f)
    autotune._disk_put("s2:dev", "b")
    with open(path) as f:
        assert json.load(f)["s2:dev"] == "b"


def test_autotune_cache_env_set_after_import_wins(tmp_path, monkeypatch):
    """STREAMZ_AUTOTUNE_CACHE set after the module was imported must
    redirect reads AND writes (the path used to be captured at import)."""
    from streamz_tpu.runtime import autotune

    late = str(tmp_path / "late.json")
    monkeypatch.setenv("STREAMZ_AUTOTUNE_CACHE", late)
    autotune._disk_put("k:dev", {"choice": "v", "candidates": ["v"]})
    assert autotune._disk_get("k:dev") == "v"
    import os

    assert os.path.exists(late)


def test_chain_timer_even_repeats_lower_median():
    """repeats=2 must not report the WORSE run as 'median'."""
    from streamz_tpu.runtime import measure
    import jax.numpy as jnp

    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    t = measure.chain_timer(fn, jnp.zeros(()), iters=2, repeats=2)
    assert t >= 0.0  # sanity; the pick rule itself:
    times = [3.0, 1.0]
    assert sorted(times)[(len(times) - 1) // 2] == 1.0


def test_auto_mesh_pin_and_env_killswitch(monkeypatch):
    """set_active_mesh(None) stays pinned, and STREAMZ_TPU_MESH=0 set
    mid-process wins over an already-built mesh."""
    from streamz_tpu.parallel import mesh as meshmod

    old = meshmod._ACTIVE[0]
    try:
        meshmod.set_active_mesh(None)
        monkeypatch.delenv("STREAMZ_TPU_MESH", raising=False)
        assert meshmod.auto_mesh() is None  # pinned, not rebuilt
        m = object()
        meshmod.set_active_mesh(m)
        assert meshmod.auto_mesh() is m
        monkeypatch.setenv("STREAMZ_TPU_MESH", "0")
        assert meshmod.auto_mesh() is None  # env wins over the cache
    finally:
        meshmod._ACTIVE[0] = old
