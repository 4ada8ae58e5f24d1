"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and its
corpus builder, float64 references and phases hold at tiny sizes (the same
code runs at full size on the card)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_smoke_exits_nonzero_without_gpu():
    proc = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_smoke_alone_in_a_directory_fails(tmp_path):
    """Without the rest of the repository the script cannot run a phase."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_speaker_voice_is_seeded_and_speaker_specific():
    a = cs.speaker_voice(3, 4410, seed=1)
    assert a.dtype == np.int16 and a.shape == (4410,)
    np.testing.assert_array_equal(a, cs.speaker_voice(3, 4410, seed=1))
    assert not np.array_equal(a, cs.speaker_voice(4, 4410, seed=1))
    assert not np.array_equal(a, cs.speaker_voice(3, 4410, seed=2))
    assert np.abs(a).max() > 1000  # audible, not silence


def test_build_corpus_layout(tmp_path):
    from streamz_tpu.io import filelists
    from streamz_tpu.io.wav import read_wav

    entries = cs.build_corpus(str(tmp_path), n_speakers=4,
                              clips_per_speaker=3, seconds=0.2)
    assert len(entries) == 12
    assert sum(c is not None for _, c in entries) == 8  # clips 0 and 1
    listed = filelists.load_train_files(str(tmp_path / "train_files.txt"))
    assert listed == entries
    rates = {}
    for path, _ in entries:
        samples, rate, _ = read_wav(str(tmp_path / path))
        rates[path] = rate
        assert len(samples) == int(0.2 * rate)
    # The last clip of every fourth speaker is at 16 kHz (resampled).
    assert rates[os.path.join("clips", "spk00_c2.wav")] == 16000
    assert sorted(set(rates.values())) == [16000, 44100]


@pytest.mark.parametrize("num_speakers,capacity", [(2, 128), (64, 128),
                                                   (130, 256)])
def test_delta_rule_grads_match_corpus_grads(num_speakers, capacity):
    import jax.numpy as jnp

    from streamz_tpu.nn import train
    from streamz_tpu.nn.model import SpeakerNet

    net = SpeakerNet.new(input_size=60, hidden1=32, hidden2=16,
                         output=num_speakers, seed=1)
    net.ensure_capacity(capacity)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 60)).astype(np.float32)
    y = rng.integers(0, num_speakers + 3, 64).astype(np.int32)
    w = (rng.random(64) > 0.2).astype(np.float32)
    grads, _, _ = train.corpus_grads(net.params, jnp.asarray(x),
                                     jnp.asarray(y), jnp.asarray(w),
                                     num_speakers)
    want = cs.delta_rule_grads_f64(net.params, x, y, w, num_speakers)
    for k in want:
        np.testing.assert_allclose(np.asarray(grads[k]), want[k],
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_max_feature_error_checks_shapes():
    clip = cs.speaker_voice(0, 2000)
    from streamz_tpu.dsp.mfcc_ref import extract_features_np

    good = extract_features_np(clip).astype(np.float32)
    assert cs.max_feature_error([good], [clip]) < 1e-6
    with pytest.raises(AssertionError, match="shape"):
        cs.max_feature_error([good[:-1]], [clip])


def test_phase_frontend_tiny():
    assert cs.phase_frontend(n_clips=2, seconds=0.5) <= cs.FRONTEND_GATE


def test_phase_classifier_tiny():
    err, worst = cs.phase_classifier(n_windows=512, grad_batch=128)
    assert err <= cs.PROBS_ATOL and worst <= cs.GRAD_RTOL


def test_phase_cli_and_serving_tiny(tmp_path, monkeypatch):
    """Phase d (CLI discovery held to the host oracle, --eval, --identify,
    --check-embeddings) and phase e (a trained model serving slots on both
    wires, the TCP daemon) end to end at a tiny size."""
    monkeypatch.chdir(tmp_path)
    net = cs.phase_cli(str(tmp_path / "cli"), n_speakers=3,
                       clips_per_speaker=4, seconds=1.0)
    assert net.num_speakers >= 3
    cs.phase_serving(cs.serving_model(4, seconds=1.0, epochs=30), n_slots=8,
                     seconds=0.5)


@pytest.mark.gpu
def test_phases_on_the_gpu(tmp_path, monkeypatch):
    """The smoke phases on a real card at reduced sizes (the full-size run
    is ``python chip_smoke.py``).  Decides at run time whether a GPU is
    present."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("no GPU: chip_smoke.py runs these phases on the card")
    monkeypatch.chdir(tmp_path)
    assert cs.phase_frontend(n_clips=4, seconds=10.0) <= cs.FRONTEND_GATE
    cs.phase_classifier(n_windows=8192, grad_batch=1024)
    cs.phase_cli(str(tmp_path / "cli"), n_speakers=4, clips_per_speaker=4,
                 seconds=3.0)
    cs.phase_serving(cs.serving_model(8, seconds=2.0), n_slots=16,
                     seconds=1.0)
