"""Application-level device-count invariance.

The CLI auto-builds a ``"data"`` mesh over all local devices and routes the
ingest frontend, initial corpus training, eval embedding batches, and
long-clip identification through it.  These tests run the *whole application*
(train + ``--eval``) in subprocesses pinned to 1 and 8 virtual CPU devices
and assert identical discovered labels and eval metrics — the multi-chip
path changes wall-clock, not results.
"""

import os
import shutil
import subprocess
import sys

import pytest

REF_DATA = "/root/reference/streamz-rs/examples/training_data"
CLIPS = [
    "common_voice_fr_41911269.mp3",
    "common_voice_fr_41922955.mp3",
    "common_voice_fr_42346439.mp3",
    "common_voice_fr_42483609.mp3",
    "common_voice_fr_42541248.mp3",
]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF_DATA), reason="reference sample data absent"
)

_RUNNER = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from streamz_tpu.cli import main
sys.exit(main({argv!r}))
"""


def _run_cli(workdir, n_devices, argv=()):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    env["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()
    proc = subprocess.run(
        [sys.executable, "-c", _RUNNER.format(repo=REPO, argv=list(argv))],
        cwd=str(workdir),
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _stage(root):
    root.mkdir()
    data = root / "data"
    data.mkdir()
    for c in CLIPS:
        shutil.copy(os.path.join(REF_DATA, c), data / c)
    (root / "train_files.txt").write_text(
        "".join(f"data/{c}\n" for c in CLIPS)
    )


def _metric_lines(out):
    return [
        ln.strip()
        for ln in out.splitlines()
        if ln.strip().startswith(("Accuracy:", "Precision:", "Recall:", "F1-score:"))
    ]


def test_application_device_count_invariance(tmp_path):
    d1 = tmp_path / "one"
    d8 = tmp_path / "eight"
    _stage(d1)
    _stage(d8)

    out1 = _run_cli(d1, 1)
    out8 = _run_cli(d8, 8)

    assert "Running on 8 devices (data-parallel mesh)" in out8
    assert "data-parallel mesh" not in out1  # single device: no mesh

    labels1 = (d1 / "train_files.txt").read_text()
    labels8 = (d8 / "train_files.txt").read_text()
    assert labels1 == labels8, f"labels diverged:\n{labels1}\nvs\n{labels8}"

    import numpy as np

    n1 = int(np.load(d1 / "model.npz")["num_speakers"][0])
    n8 = int(np.load(d8 / "model.npz")["num_speakers"][0])
    assert n1 == n8

    ev1 = _metric_lines(_run_cli(d1, 1, ["--eval"]))
    ev8 = _metric_lines(_run_cli(d8, 8, ["--eval"]))
    assert len(ev1) == 4
    assert ev1 == ev8, f"eval metrics diverged: {ev1} vs {ev8}"


def test_labeled_initial_training_invariance(tmp_path):
    """Fresh-model corpus training (the DP path) with labels given."""
    d1 = tmp_path / "one"
    d8 = tmp_path / "eight"
    for d in (d1, d8):
        _stage(d)
        (d / "train_files.txt").write_text(
            "".join(f"data/{c},{i % 2 + 1}\n" for i, c in enumerate(CLIPS))
        )

    out1 = _run_cli(d1, 1)
    out8 = _run_cli(d8, 8)
    assert "Initial training loss:" in out1
    assert "Initial training loss:" in out8
    assert (d1 / "train_files.txt").read_text() == (d8 / "train_files.txt").read_text()


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
