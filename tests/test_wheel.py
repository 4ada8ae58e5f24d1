"""Wheel-install parity for the native ingest layer.

``pip install .`` used to produce a wheel with no ``native/`` sources: the
ctypes loader silently fell back to pure-Python ingest — behavior-identical
but a large perf cliff with no warning.  Now ``setup.py`` copies the C++
sources into ``streamz_tpu/native/`` inside the wheel, the loader probes
that directory second, and an unavailable native layer warns loudly once.

The end-to-end test builds a real wheel, installs it into a fresh venv
(``--system-site-packages`` for numpy; ``--no-index`` so no network is
touched), and asserts the installed package activates the native layer
from site-packages and decodes a real MP3 with it.
"""

import os
import subprocess
import sys
import venv

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MP3_DIR = "/root/reference/streamz-rs/examples/training_data"


def test_fallback_warns_loudly_once(monkeypatch):
    """No native sources anywhere -> exactly one RuntimeWarning naming the
    perf cliff, and available() is False (never raises)."""
    from streamz_tpu.io import native

    monkeypatch.setattr(native, "_CANDIDATE_DIRS", ("/nonexistent/a",))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_warned_fallback", False)
    monkeypatch.setattr(native, "_build_attempted", False)
    with pytest.warns(RuntimeWarning, match="pure-Python ingest"):
        assert not native.available()
    # Second probe: cached, no second warning.
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.available()


def test_source_dir_prefers_repo_layout():
    from streamz_tpu.io import native

    d = native.source_dir()
    assert d is not None
    assert os.path.samefile(d, os.path.join(REPO, "native"))


@pytest.mark.slow
def test_wheel_install_keeps_native_layer(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"

    # Build the wheel offline (setuptools from the ambient environment).
    wheel_dir = tmp_path / "dist"
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-build-isolation",
         "--no-deps", "--no-index", "-w", str(wheel_dir), REPO],
        check=True, capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path),
    )
    wheels = list(wheel_dir.glob("streamz_tpu-*.whl"))
    assert len(wheels) == 1, list(wheel_dir.iterdir())

    # Fresh venv; --no-index proves no network is needed.  The ambient
    # interpreter is itself a venv (so ``system_site_packages`` would
    # inherit the BASE prefix, not its site-packages): dependencies
    # (numpy/jax) are supplied to the probe via PYTHONPATH instead —
    # streamz_tpu is not installed there, so the wheel remains the only
    # provider of the package under test.
    import numpy as _np

    dep_site = os.path.dirname(os.path.dirname(os.path.abspath(_np.__file__)))
    venv_dir = tmp_path / "venv"
    venv.EnvBuilder(with_pip=True, system_site_packages=True).create(venv_dir)
    vpy = str(venv_dir / "bin" / "python")
    env["PYTHONPATH"] = dep_site
    subprocess.run(
        [vpy, "-m", "pip", "install", "--no-index", "--no-deps",
         str(wheels[0])],
        check=True, capture_output=True, text=True, timeout=300, env=env,
    )

    mp3s = sorted(
        os.path.join(MP3_DIR, f) for f in os.listdir(MP3_DIR)
        if f.endswith(".mp3")
    ) if os.path.isdir(MP3_DIR) else []
    probe = (
        "import os, sys, json\n"
        "import streamz_tpu\n"
        "from streamz_tpu.io import native\n"
        "d = native.source_dir()\n"
        "assert d and 'site-packages' in d.replace(os.sep, '/'), d\n"
        "assert native.available(), 'native layer not active from wheel'\n"
        "n = 0\n"
        f"mp3s = {mp3s[:1]!r}\n"
        "for p in mp3s:\n"
        "    clip = native.decode_file(p)\n"
        "    assert clip is not None and clip[0].size > 0, p\n"
        "    n = clip[0].size\n"
        "print(json.dumps({'dir': d, 'decoded': n}))\n"
    )
    proc = subprocess.run(
        [vpy, "-c", probe], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "site-packages" in proc.stdout
    if mp3s:
        import json as _json

        assert _json.loads(proc.stdout)["decoded"] > 0

    # The installed CLI runs too: both the console script the wheel
    # installs and `python -m streamz_tpu`, from a directory that is NOT
    # the repo (so the wheel is the only provider).
    for cmd in ([str(venv_dir / "bin" / "streamz"), "--help"],
                [vpy, "-m", "streamz_tpu", "--help"]):
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120, env=env,
            cwd=str(tmp_path),
        )
        assert proc.returncode == 0, (cmd, proc.stdout + proc.stderr)
        assert "usage" in proc.stdout.lower(), (cmd, proc.stdout)


def test_prebuilt_so_without_sources_still_loads(tmp_path, monkeypatch):
    """A deployment may ship ONLY the built .so (sources pruned); the
    loader must use it rather than falling back to pure-Python with a
    misleading 'no sources found' warning."""
    import shutil

    from streamz_tpu.io import native

    built = os.path.join(REPO, "native", "libstreamz_native.so")
    if not os.path.exists(built):
        assert native.available()  # builds it in-tree
    so_only = tmp_path / "deploy"
    so_only.mkdir()
    shutil.copy2(built, so_only / "libstreamz_native.so")

    monkeypatch.setattr(native, "_CANDIDATE_DIRS", (str(so_only),))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_warned_fallback", False)
    monkeypatch.setattr(native, "_build_attempted", False)
    assert native.source_dir() is None  # genuinely no sources
    assert native.available()
    clip = native.resample_i16_native(
        np.arange(-500, 500, dtype=np.int16), 22050, 44100
    )
    assert clip is not None and clip.size > 0
