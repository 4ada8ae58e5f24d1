"""Benchmark harness: end-to-end identification pipeline, GPU vs CPU spec.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The reference publishes no numbers, so the baseline is the *measured*
reference-spec pipeline on the host CPU — the same algorithmic structure the
Rust binary executes per clip (its end-to-end hot path):

  1. MFCC+Δ+ΔΔ extraction (HOT LOOP A, ``streamz-rs/src/main.rs:500-508``) —
     the numpy golden spec, vectorized across windows (generous to the
     baseline: the reference FFTs one window at a time);
  2. the classifier forward per window (``src/lib.rs:880-891``) — computed
     per-window exactly as the reference does: its linear algebra is
     single-vector ndarray math with no batching (SURVEY.md §3.5);
  3. the vote-sum aggregation of ``identify_speaker`` (``src/lib.rs:1285-1303``).

``value`` is the GPU throughput of the batched jit-fused pipeline (frontend
+ batched forward + on-device vote sums) in windows/s; ``vs_baseline`` is
the speedup over the CPU spec.  Extra keys: ``device`` (platform, kind,
count), ``card`` (``nvidia-smi`` name and power limit), ``algo_tflops`` /
``mfu`` (algorithmic FLOP/s and its share of the card's published float32
peak — the pipeline's GEMMs run at ``Precision.HIGHEST``, see
``streamz_tpu/precision.py``), ``cpu_windows_per_sec``
(the vs_baseline denominator), and the 64-slot serving real-time factors on
the i16 and µ-law wires (``serve_bench.bench_slots_interleaved``).

Runs only on a GPU listed in :data:`PEAKS`; anything else is an error.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_CLASSES = 64  # plausible grown speaker count; capacity pads to 128

# Published dense peaks per card, keyed on the exact ``device_kind`` JAX
# reports.  Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense
# rates without sparsity, at the full 700 W power limit.  A card that is not
# listed is an error: no peak is assumed.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "f32_tflops": 67.0,
        "hbm_tb_per_s": 3.35,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; raises for an unknown card."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peak for device_kind {device_kind!r}; add the "
            "card to bench.PEAKS with its data-sheet source"
        ) from None


def _make_net():
    from streamz_tpu.nn.model import SpeakerNet

    return SpeakerNet.new(output=_CLASSES, seed=0)


def _bench_device(net, frontend, batch_clips: int = 32,
                  clip_seconds: float = 10.0, iters: int = 50):
    import jax
    import jax.numpy as jnp

    from streamz_tpu import config
    from streamz_tpu.dsp.mfcc import window_count
    from streamz_tpu.nn.model import forward

    rate = config.DEFAULT_SAMPLE_RATE
    t = int(clip_seconds * rate)
    t -= t % config.HOP_SIZE
    n_win = (t - config.WINDOW_SIZE) // config.HOP_SIZE + 1

    rng = np.random.default_rng(0)
    pcm = jnp.asarray(
        rng.normal(0.0, 0.1, size=(batch_clips, t)).astype(np.float32)
    )
    n_samples = jnp.full((batch_clips,), t, jnp.int32)
    params = net.params
    num_speakers = net.num_speakers

    @jax.jit
    def pipeline(pcm, n_samples):
        feats = frontend(pcm, n_samples)                  # [B, W, 60]
        probs = forward(params, feats, num_speakers)      # [B, W, cap]
        valid = (
            jnp.arange(feats.shape[1])[None, :]
            < window_count(n_samples)[:, None]
        )
        return (probs * valid[..., None]).sum(axis=1)     # vote sums

    jax.block_until_ready(pipeline(pcm, n_samples))  # compile + warm
    best = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        for _ in range(iters):
            out = pipeline(pcm, n_samples)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - start) / iters)

    # Algorithmic FLOPs per window (MFU convention — useful math only,
    # unpadded, one pass): DFT 2*400*(2*401) + mel 2*401*26 + DCT 2*26*20 +
    # classifier 2*(60*H1 + H1*H2 + H2*live).  (XLA's cost analysis does
    # not count the cuBLAS GEMMs on the GPU, so it is no executed count.)
    live = int(net.num_speakers)
    algo_per_win = (
        2 * 400 * (2 * 401) + 2 * 401 * config.N_MELS
        + 2 * config.N_MELS * config.MFCC_SIZE
        + 2 * (60 * config.HIDDEN1 + config.HIDDEN1 * config.HIDDEN2
               + config.HIDDEN2 * live)
    )
    algo_flops = batch_clips * n_win * algo_per_win
    return batch_clips * n_win / best, algo_flops / best


def _bench_cpu_baseline(net, clip_seconds: float = 3.0, iters: int = 2):
    from streamz_tpu import config
    from streamz_tpu.dsp.mfcc_ref import extract_features_np

    w1 = np.asarray(net.params["w1"]); b1 = np.asarray(net.params["b1"])
    w2 = np.asarray(net.params["w2"]); b2 = np.asarray(net.params["b2"])
    w3, b3 = net.output_layer()

    def forward_one(x):
        # Reference forward: per-window single-vector math (src/lib.rs:880-891).
        h1 = np.maximum(x @ w1 + b1, 0.0)
        h2 = np.tanh(h1 @ w2 + b2)
        z = h2 @ w3 + b3
        e = np.exp(z - z.max())
        return e / e.sum()

    rate = config.DEFAULT_SAMPLE_RATE
    t = int(clip_seconds * rate)
    rng = np.random.default_rng(1)
    clip = (rng.normal(0, 3000, size=t)).astype(np.int16)

    feats = extract_features_np(clip)  # warm
    sums = np.zeros(w3.shape[1])
    for win in feats:
        sums += forward_one(win)

    start = time.perf_counter()
    n_win = 0
    for _ in range(iters):
        feats = extract_features_np(clip)
        sums = np.zeros(w3.shape[1])
        for win in feats:
            sums += forward_one(win)
        int(sums.argmax())
        n_win += len(feats)
    elapsed = time.perf_counter() - start
    return n_win / elapsed


def main() -> None:
    import jax

    from streamz_tpu.dsp.mfcc import mfcc_features
    from streamz_tpu.runtime.compile_cache import enable_compile_cache
    from streamz_tpu.runtime.measure import card_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {dev.platform!r}"
        )
    peaks = device_peaks(dev.device_kind)
    enable_compile_cache()
    net = _make_net()
    device_rate, algo_fps = _bench_device(net, mfcc_features)
    cpu_rate = _bench_cpu_baseline(net)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "benchmarks"))
    from serve_bench import bench_slots_interleaved

    rows = bench_slots_interleaved(64, ticks=10, reps=2)
    f32_peak = peaks["f32_tflops"] * 1e12
    print(json.dumps({
        "metric": "identify_pipeline_windows_per_sec",
        "value": device_rate,
        "unit": "windows/s",
        "vs_baseline": device_rate / cpu_rate,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_name_and_power_limit(),
        "cpu_windows_per_sec": cpu_rate,
        "algo_tflops": algo_fps / 1e12,
        "mfu": algo_fps / f32_peak,
        "serve64_aggregate_rtf": rows["i16"]["aggregate_rtf"],
        "serve64_aggregate_rtf_ulaw": rows["ulaw"]["aggregate_rtf"],
    }))


if __name__ == "__main__":
    main()
