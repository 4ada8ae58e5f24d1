"""Driver entry-point coverage (``__graft_entry__.py``): the entry forward,
and the multi-device dry run on the conftest 8-device CPU mesh.  The dry run
uses the ambient devices only; it never re-executes itself elsewhere.
"""

import jax
import pytest

import __graft_entry__ as graft


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] == 4  # one vote-sum row per clip
    assert out.ndim == 2


def test_dryrun_multichip_in_process_8_devices():
    # conftest forces 8 virtual CPU devices.
    graft.dryrun_multichip(8)


def test_dryrun_multichip_raises_without_enough_devices():
    """More devices than JAX sees is an error, not a fallback onto a
    forced CPU mesh."""
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft.dryrun_multichip(16)


def test_graft_main_runs_on_cpu_mesh():
    """``python __graft_entry__.py`` runs the entry forward and the dry run
    over every ambient device (an 8-device CPU mesh here) and exits 0."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = repo + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "__graft_entry__.py")],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip ok" in proc.stdout


def test_dryrun_reports_per_program_and_names_failures(monkeypatch, capsys):
    """The gate executes the full multi-device surface and a red run names
    the failing program in both the tail and the exception."""
    graft._dryrun_multichip_impl(8)
    out = capsys.readouterr().out
    assert "multichip programs:" in out
    for prog in ("dp_train", "discovery_scan", "halo_frontend",
                 "identify_psum", "serve_shard"):
        assert f"{prog}=ok" in out, out

    def boom(n):
        raise ValueError("synthetic serve failure")

    monkeypatch.setattr(graft, "_prog_serve_shard", boom)
    with pytest.raises(RuntimeError, match="serve_shard"):
        graft._dryrun_multichip_impl(8)
    out = capsys.readouterr().out
    assert "serve_shard=FAIL" in out and "dp_train=ok" in out
