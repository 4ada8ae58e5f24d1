"""The benchmark's honesty rules and the measurement helpers: a published
peak only for a listed card, no run off the GPU, and one compile-cache
location rule for every entry point."""

import os
import subprocess
import sys

import pytest

import bench
from streamz_tpu.runtime import compile_cache, measure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_peak_table_has_the_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
                     "f32_tflops": 67.0, "hbm_tb_per_s": 3.35}


@pytest.mark.parametrize(
    "kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA H100", "NVIDIA A100-SXM4-80GB",
             ""]
)
def test_peak_table_raises_for_unknown_device(kind):
    """No peak is assumed for a card that is not listed, not even for a
    near match of a listed name."""
    with pytest.raises(ValueError, match="no published peak"):
        bench.device_peaks(kind)


def test_bench_refuses_to_run_off_the_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert "measures the GPU" in proc.stderr
    assert '"metric"' not in proc.stdout


def test_compile_cache_honors_env_and_sets_nothing(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # Fixed: the same path on every call, nothing temporary in it.
        assert compile_cache.enable_compile_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_none_outside_a_checkout(monkeypatch, tmp_path):
    """An installed package (no pyproject.toml beside it) keeps JAX's
    default: it never writes a cache into site-packages."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "_CHECKOUT", tmp_path)
    assert compile_cache.checkout_cache_dir() is None
    assert compile_cache.enable_compile_cache() is None


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_card_name_needs_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(OSError):
        measure.card_name_and_power_limit()


def test_bench_device_leg_runs_at_tiny_size():
    """The timed pipeline compiles and reports a positive rate and FLOP
    rate (its numbers on the CPU mean nothing; the GPU run is bench.py)."""
    from streamz_tpu.dsp.mfcc import mfcc_features

    net = bench._make_net()
    rate, algo = bench._bench_device(
        net, mfcc_features, batch_clips=2, clip_seconds=0.2, iters=2)
    assert rate > 0 and algo > 0
