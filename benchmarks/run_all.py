"""Extended benchmark harness: per-stage throughput report.

``bench.py`` (repo root) prints the single headline JSON line; this harness
measures every hot stage and writes ``benchmarks/report.json`` (not
committed):

- MFCC frontend windows/s (the XLA formulation)
- identify pipeline (frontend + batched forward + vote sums) windows/s
- corpus training windows/s (data-parallel step over all local devices)
- CPU reference-spec baselines for each

Device timings end in ``block_until_ready``; most use dependency-chained
scans (``streamz_tpu.runtime.measure.chain_timer``) so one dispatch carries
many iterations.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chain_time(make_body, iters: int = 50, repeats: int = 3) -> float:
    """Thin adapter over the ONE shared chained-scan timer
    (streamz_tpu.runtime.measure.chain_timer, best=True — the peak
    statistic these throughput rows have always recorded), so a
    methodology fix (collapse fences, dtype-promotion fence) lands once
    instead of diverging between this harness and bench.py."""
    import jax.numpy as jnp

    from streamz_tpu.runtime.measure import chain_timer

    return chain_timer(
        make_body, jnp.float32(0.0), iters=iters, repeats=repeats, best=True
    )


def bench_frontends(B=32, seconds=10.0):
    import jax.numpy as jnp

    from streamz_tpu import config
    from streamz_tpu.dsp.mfcc import mfcc_features

    t = int(seconds * config.DEFAULT_SAMPLE_RATE)
    t -= t % config.HOP_SIZE
    n_win = (t - config.WINDOW_SIZE) // config.HOP_SIZE + 1
    rng = np.random.default_rng(0)
    pcm = jnp.asarray(rng.normal(0, 0.1, (B, t)).astype(np.float32))
    ns = jnp.full((B,), t, jnp.int32)

    dt = _chain_time(lambda c: mfcc_features(pcm + c, ns))
    return {"mfcc_xla_windows_per_sec": B * n_win / dt}


def bench_identify(B=32, seconds=10.0, classes=64):
    import jax.numpy as jnp

    from streamz_tpu import config
    from streamz_tpu.dsp.mfcc import mfcc_features, window_count
    from streamz_tpu.nn.model import SpeakerNet, forward

    t = int(seconds * config.DEFAULT_SAMPLE_RATE)
    t -= t % config.HOP_SIZE
    n_win = (t - config.WINDOW_SIZE) // config.HOP_SIZE + 1
    rng = np.random.default_rng(0)
    pcm = jnp.asarray(rng.normal(0, 0.1, (B, t)).astype(np.float32))
    ns = jnp.full((B,), t, jnp.int32)
    net = SpeakerNet.new(output=classes, seed=0)
    params, S = net.params, net.num_speakers

    def pipeline(c):
        feats = mfcc_features(pcm + c, ns)
        probs = forward(params, feats, S)
        valid = (jnp.arange(feats.shape[1])[None, :] < window_count(ns)[:, None])
        # max over classes, like bench.py: a plain sum over masked softmax
        # vote sums is ~= the valid-window count, which an algebraic
        # simplifier could cancel exp/sum-exp through — deleting the
        # classifier GEMMs from the timed program.
        return jnp.max((probs * valid[..., None]).sum(axis=1), axis=-1)

    dt = _chain_time(pipeline)
    return {"identify_pipeline_windows_per_sec": B * n_win / dt}


def bench_corpus_train(batch=65536, feat=60, classes=64):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from streamz_tpu.nn.model import SpeakerNet
    from streamz_tpu.parallel import comm, data_parallel as dp

    mesh = comm.make_mesh()
    n_dev = mesh.devices.size
    batch -= batch % n_dev
    rng = np.random.default_rng(1)
    x = rng.normal(size=(batch, feat)).astype(np.float32)
    y = rng.integers(0, classes, batch).astype(np.int32)
    w = np.ones(batch, np.float32)
    net = SpeakerNet.new(input_size=feat, output=classes, seed=0)

    # One scanned epoch = one device dispatch.
    steps = 50
    sh = NamedSharding(mesh, P(None, comm.DATA_AXIS))
    xb = jax.device_put(np.broadcast_to(x, (steps, *x.shape)).copy(), sh)
    yb = jax.device_put(np.broadcast_to(y, (steps, *y.shape)).copy(), sh)
    wb = jax.device_put(np.broadcast_to(w, (steps, *w.shape)).copy(), sh)

    epoch = dp.make_dp_train_epoch(mesh, steps=steps)
    params, losses = epoch(
        net.params, xb, yb, wb, jnp.int32(classes), jnp.float32(0.01)
    )
    jax.block_until_ready(losses)
    best = float("inf")
    for _ in range(2):
        start = time.perf_counter()
        params, losses = epoch(
            params, xb, yb, wb, jnp.int32(classes), jnp.float32(0.01)
        )
        jax.block_until_ready(losses)
        best = min(best, (time.perf_counter() - start) / steps)
    return {"devices": n_dev, "corpus_train_windows_per_sec": batch / best}


def bench_streaming(seconds=30.0, chunk_ms=100, classes=64):
    """Real-time factor of the live streaming identifier: how many seconds
    of 44.1 kHz audio one device absorbs per wall-clock second when fed in
    ~100 ms microphone-sized chunks (includes all host chunking overhead
    and the per-block device steps)."""
    from streamz_tpu import config
    from streamz_tpu.app.stream import StreamingIdentifier
    from streamz_tpu.nn.model import SpeakerNet

    net = SpeakerNet.new(output=classes, seed=0)
    rate = config.DEFAULT_SAMPLE_RATE
    rng = np.random.default_rng(0)
    pcm = rng.normal(0, 0.1, int(seconds * rate)).astype(np.float32)
    chunk = int(rate * chunk_ms / 1000)

    # Warm the compiled step/finalize programs on a short stream first.
    sid = StreamingIdentifier(net)
    sid.feed(pcm[: chunk * 5]); sid.current(); sid.finalize()

    sid = StreamingIdentifier(net)
    start = time.perf_counter()
    for off in range(0, len(pcm), chunk):
        sid.feed(pcm[off:off + chunk])
    sid.current()
    sid.finalize()
    wall = time.perf_counter() - start
    return {"streaming_realtime_factor": round(seconds / wall, 2)}


def bench_cpu_baselines(seconds=3.0, classes=64):
    from streamz_tpu import config
    from streamz_tpu.dsp.mfcc_ref import extract_features_np
    from streamz_tpu.nn.model import SpeakerNet

    t = int(seconds * config.DEFAULT_SAMPLE_RATE)
    clip = np.random.default_rng(1).normal(0, 3000, t).astype(np.int16)
    extract_features_np(clip)
    start = time.perf_counter()
    feats = extract_features_np(clip)
    dt = time.perf_counter() - start
    out = {"cpu_mfcc_windows_per_sec": len(feats) / dt}

    net = SpeakerNet.new(output=classes, seed=0)
    w1 = np.asarray(net.params["w1"]); b1 = np.asarray(net.params["b1"])
    w2 = np.asarray(net.params["w2"]); b2 = np.asarray(net.params["b2"])
    w3, b3 = net.output_layer()
    start = time.perf_counter()
    for win in feats:
        h1 = np.maximum(win @ w1 + b1, 0.0)
        h2 = np.tanh(h1 @ w2 + b2)
        z = h2 @ w3 + b3
        e = np.exp(z - z.max()); e / e.sum()
    dt_fwd = time.perf_counter() - start
    out["cpu_forward_windows_per_sec"] = len(feats) / dt_fwd
    out["cpu_identify_pipeline_windows_per_sec"] = len(feats) / (dt + dt_fwd)
    return out


def bench_incremental_train(n_windows=448, epochs=5, batch=8, classes=64):
    """Throughput of the semantics-exact per-file trainer
    (``train_on_windows``: fused shuffle/dropout/batch-8 scan) — the hot step
    of the incremental loop, measured per processed window-epoch."""
    import jax
    import jax.numpy as jnp

    from streamz_tpu.nn.model import SpeakerNet
    from streamz_tpu.nn.train import train_on_windows

    net = SpeakerNet.new(output=classes, seed=0)
    rng = np.random.default_rng(0)
    wins = jnp.asarray(rng.normal(size=(n_windows, 60)).astype(np.float32))
    tvec = np.zeros((net.capacity,), np.float32)
    tvec[3] = 1.0

    def run(params, key):
        return train_on_windows(
            params, wins, jnp.int32(n_windows), jnp.asarray(tvec),
            jnp.int32(classes), key, jnp.float32(0.01), jnp.float32(0.2),
            epochs=epochs, batch_size=batch,
        )

    params = jax.tree_util.tree_map(lambda a: a.copy(), net.params)
    params, _ = run(params, jax.random.PRNGKey(0))  # compile
    # 100 chained reps per timed round (each step's params feed the
    # next); best of 3 rounds.
    reps = 100
    best = np.inf
    for r in range(3):
        start = time.perf_counter()
        for i in range(reps):
            params, loss = run(params, jax.random.PRNGKey(r * reps + i))
        jax.block_until_ready(loss)
        best = min(best, time.perf_counter() - start)
    dt = best / reps
    out = {
        "incremental_train_window_epochs_per_sec": n_windows * epochs / dt,
        "incremental_train_step_ms": dt * 1e3,
    }
    out.update(_bench_fused_loop(n_windows=n_windows, epochs=epochs, batch=batch))
    return out


def _bench_fused_loop(n_files=64, n_windows=448, epochs=5, batch=8):
    """End-to-end per-file cost of the *whole* incremental loop body
    (embed→match→grow→train→centroid) via the fused device-resident loop —
    the number the reference's hot loop C pays per file
    (src/main.rs:750-835).  One async dispatch per file chunk, one sync at
    the end, so dispatch latency pipelines instead of stacking."""
    from streamz_tpu.app.device_loop import run_incremental_device
    from streamz_tpu.nn.model import SpeakerNet

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 60)).astype(np.float32) * 2.0

    def corpus(n):
        files, fm = [], {}
        for i in range(n):
            w = (centers[i % 8] + rng.normal(0, 0.3, size=(n_windows, 60))
                 ).astype(np.float32)
            files.append((f"bench_{i}.wav", 0 if i == 0 else None))
            fm[files[-1][0]] = w
        return files, fm

    # Warm the compile cache with a tiny run.
    files, fm = corpus(4)
    run_incremental_device(
        SpeakerNet.new(output=1, seed=0), files, fm, burn_in_limit=2,
        conf_threshold=0.8, dropout=0.2, batch_size=batch, epochs=epochs,
        max_speakers=None, show_progress=False,
    )

    best = np.inf
    for r in range(3):
        files, fm = corpus(n_files)
        net = SpeakerNet.new(output=1, seed=0)
        start = time.perf_counter()
        run_incremental_device(
            net, files, fm, burn_in_limit=8, conf_threshold=0.8, dropout=0.2,
            batch_size=batch, epochs=epochs, max_speakers=None,
            show_progress=False,
        )
        best = min(best, time.perf_counter() - start)

    # Device-resident handoff (what the CLI actually runs: the ingest
    # stage's DeviceFeatureStore feeds the loop, so the per-chunk feature
    # re-upload — the dominant transfer — disappears).
    import jax.numpy as jnp

    from streamz_tpu.dsp.mfcc import DeviceFeatureStore

    best_dev = np.inf
    for r in range(3):
        files, fm = corpus(n_files)
        paths = [p for p, _ in files]
        store = DeviceFeatureStore()
        arr = jnp.asarray(np.stack([fm[p] for p in paths]))
        arr.block_until_ready()
        store.add_bucket(arr, list(range(len(paths))), [n_windows] * len(paths))
        store.rekey({i: p for i, p in enumerate(paths)})
        net = SpeakerNet.new(output=1, seed=0)
        start = time.perf_counter()
        run_incremental_device(
            net, files, fm, burn_in_limit=8, conf_threshold=0.8, dropout=0.2,
            batch_size=batch, epochs=epochs, max_speakers=None,
            show_progress=False, device_store=store,
        )
        best_dev = min(best_dev, time.perf_counter() - start)
    return {
        "incremental_train_file_step_ms": best / n_files * 1e3,
        "incremental_loop_files_per_sec": n_files / best,
        "incremental_train_file_step_ms_device_resident": best_dev / n_files * 1e3,
        "incremental_loop_files_per_sec_device_resident": n_files / best_dev,
    }


def bench_eval_embeddings(n_files=256, n_windows=448, classes=64):
    """Eval-stage clip-embedding batches (``--eval``'s device work,
    src/main.rs:573-611): host-packed upload vs device-resident store
    gather — the eval analogue of the discovery loop's feature handoff."""
    import jax.numpy as jnp

    from streamz_tpu.dsp.mfcc import DeviceFeatureStore
    from streamz_tpu.infer.embed import batch_clip_embeddings
    from streamz_tpu.nn.model import SpeakerNet

    rng = np.random.default_rng(0)
    net = SpeakerNet.new(output=classes, seed=0)
    wins = rng.normal(0, 1, size=(n_files, n_windows, 60)).astype(np.float32)
    clips = [wins[i] for i in range(n_files)]
    keys = [f"e{i}.wav" for i in range(n_files)]

    batch_clip_embeddings(net, clips[:4])  # warm the compile cache
    best = np.inf
    for _ in range(3):
        start = time.perf_counter()
        batch_clip_embeddings(net, clips)
        best = min(best, time.perf_counter() - start)

    store = DeviceFeatureStore()
    arr = jnp.asarray(wins)
    arr.block_until_ready()
    store.add_bucket(arr, keys, [n_windows] * n_files)
    batch_clip_embeddings(net, clips[:4], store=store, keys=keys[:4])
    best_dev = np.inf
    for _ in range(3):
        start = time.perf_counter()
        batch_clip_embeddings(net, clips, store=store, keys=keys)
        best_dev = min(best_dev, time.perf_counter() - start)
    return {
        "eval_embed_files_per_sec": n_files / best,
        "eval_embed_files_per_sec_device_resident": n_files / best_dev,
    }


def bench_stego(payload_sizes=(64, 4096, 65536)):
    """Steganography encode across payload sizes: the on-device while_loop
    trainer (HOT LOOP D, src/lib.rs:1753-1764).  Reports wall seconds per
    size INCLUDING decode verification (the encode must converge to the
    bit-exact payload, not merely terminate).  The output layer grows as
    [256, 8·len] f32, so the 64 KiB row trains ~0.5 GB of weights."""
    import tempfile

    from streamz_tpu.stego import codec

    out = {}
    for n in payload_sizes:
        payload = np.random.default_rng(n).bytes(n)
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
            f.write(payload)
            path = f.name
        start = time.perf_counter()
        net = codec.encode_file(path, max_epochs=1_000_000)
        dt = time.perf_counter() - start
        got = codec.extract_file_from_classifier(net)[:n]
        os.unlink(path)
        assert got == payload, f"stego decode mismatch at {n} bytes"
        key = "" if n == 64 else f"_{n}b"  # 64 B keeps the legacy key
        out[f"stego_encode_seconds{key}"] = dt
        if n == 64:
            out["stego_payload_bytes"] = n
    return out


def bench_serve(slot_counts=(64, 256), wires=("i16", "ulaw")):
    """Multi-stream serving sweep.  Same measurement as
    benchmarks/serve_bench.py — the host loop and transfer are inside the
    number on purpose.  Wires are measured INTERLEAVED on one fleet, so a
    slow phase of the host samples both wires and the i16/u8 split is a
    wire effect."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from serve_bench import bench_slots_interleaved

    out = {}
    for s in slot_counts:
        rows = bench_slots_interleaved(int(s), ticks=10, reps=3, wires=wires)
        for wire, r in rows.items():
            out[f"serve{s}_{wire}_aggregate_rtf"] = r["aggregate_rtf"]
            out[f"serve{s}_{wire}_tick_ms"] = r["tick_ms"]
    return out


def bench_daemon_section():
    """The DEPLOYABLE serving surface: TCP daemon end-to-end over localhost
    + the 2-process fleet, with per-verdict and per-tick p50/p95/p99.
    The server child owns the device for the whole
    measurement; this process runs only socket clients until the section
    ends (run this section on its own — `run_all.py daemon` — so no other
    section's in-process device client coexists with the child's)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import daemon_bench

    out = daemon_bench.bench_daemon(n_streams=64)
    out.update(daemon_bench.bench_fleet())
    return out


def bench_soak_section():
    """60 s churn soak against the daemon subprocess: sustained open/close
    rate, a mid-soak hot-reload, the server RSS leak fence and verdict p99
    before/after the reload."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import daemon_bench

    return daemon_bench.bench_soak(duration_s=60.0)


SECTIONS = {
    "cpu": bench_cpu_baselines,
    "frontends": bench_frontends,
    "identify": bench_identify,
    "corpus": bench_corpus_train,
    "incremental": bench_incremental_train,
    "eval": bench_eval_embeddings,
    "stego": bench_stego,
    "streaming": bench_streaming,
    "serve": bench_serve,
    "daemon": bench_daemon_section,
    "soak": bench_soak_section,
}


def main(sections=None):
    from streamz_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()

    # Sections can run in separate processes (CLI arg); results merge into
    # report.json.
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "report.json")
    report = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            report = json.load(f)

    import jax

    def _round(v):
        if not isinstance(v, float):
            return v
        # 1 decimal flattens sub-0.05 metrics to 0.0; keep precision for
        # small magnitudes (seconds, ratios), coarse for windows/s-scale.
        return round(v, 1) if abs(v) >= 10 else round(v, 4)

    # daemon/soak require the server SUBPROCESS to be the sole device
    # owner (a JAX process reserves most of the card's memory); by the time
    # the default sweep reaches them, this process has long since
    # initialized its own device client.  They are therefore opt-in only:
    # `run_all.py daemon soak` in a fresh process.
    names = sections or [
        n for n in SECTIONS if n not in ("daemon", "soak")
    ]
    for name in names:
        # Merge + write AFTER EVERY section: a failure in section k must
        # not discard the tens of minutes of measurements sections
        # 0..k-1 already produced in this invocation.
        report.update({k: _round(v) for k, v in SECTIONS[name]().items()})
        report["device"] = str(jax.devices()[0])
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2, default=float))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:] or None)
