"""VoxCeleb-scale stretch config: 1000-speaker batched training over the
mesh."""

import numpy as np
import pytest

from streamz_tpu.app.corpus import build_window_pool, train_corpus
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.parallel import comm


def test_thousand_speaker_capacity():
    net = SpeakerNet.new(input_size=16, hidden1=32, hidden2=16, output=1000, seed=0)
    assert net.capacity >= 1000
    x = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
    probs = net.forward(x)
    assert probs.shape == (4, 1000)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-4)


def test_corpus_training_1000_speakers_sharded():
    """Synthetic 1000-class corpus trains data-parallel on the 8-device mesh
    and the loss drops."""
    rng = np.random.default_rng(1)
    n_classes, per_class, dim = 1000, 4, 32
    # class centers well separated in a random subspace
    centers = rng.normal(size=(n_classes, dim)).astype(np.float32) * 3.0
    x = (centers[:, None, :] + rng.normal(size=(n_classes, per_class, dim))
         ).reshape(-1, dim).astype(np.float32)
    y = np.repeat(np.arange(n_classes, dtype=np.int32), per_class)

    net = SpeakerNet.new(input_size=dim, hidden1=64, hidden2=32,
                         output=n_classes, seed=2)
    mesh = comm.make_mesh(8)
    losses = train_corpus(
        net, x, y, epochs=12, batch_size=512, lr=0.5, mesh=mesh
    )
    assert len(losses) == 12
    assert losses[-1] < losses[0] * 0.8
    # top-1 on training data beats chance by a wide margin
    preds = net.forward(x[:512]).argmax(axis=1)
    acc = (preds == y[:512]).mean()
    assert acc > 0.05  # chance = 0.001


def test_build_window_pool():
    fm = {
        "a": np.ones((3, 60), np.float32),
        "b": np.zeros((0, 60), np.float32),
        "c": np.full((2, 60), 2.0, np.float32),
    }
    x, y = build_window_pool(fm, [("a", 0), ("b", 1), ("c", 5), ("missing", 2)])
    assert x.shape == (5, 60)
    assert y.tolist() == [0, 0, 0, 5, 5]


# ---------------------------------------------------------------------------
# 1 -> 1000 class growth through the incremental loop: recompile accounting.
#
# Capacity changes are what force XLA recompiles (w3/b3 change shape); the
# tests count ``_grow_capacity`` events as the recompile proxy.
# ---------------------------------------------------------------------------


def _count_growth(monkeypatch):
    from streamz_tpu.nn.model import SpeakerNet as SN

    calls = []
    orig = SN._grow_capacity

    def patched(self, n):
        calls.append(n)
        return orig(self, n)

    monkeypatch.setattr(SN, "_grow_capacity", patched)
    return calls


def test_incremental_growth_to_1000_single_presize(monkeypatch):
    """The device-resident loop grows 1 -> 1001 speakers with exactly ONE
    capacity event (pre-sized up front), i.e. zero mid-run recompiles."""
    from streamz_tpu.app.incremental import run_incremental

    rng = np.random.default_rng(0)
    files = [(f"f{i:04d}.wav", None) for i in range(1000)]
    fm = {p: rng.normal(size=(8, 60)).astype(np.float32) for p, _ in files}
    net = SpeakerNet.new(output=1, seed=0)
    calls = _count_growth(monkeypatch)

    res = run_incremental(net, files, fm, burn_in_limit=1000, show_progress=False)

    assert res.processed == 1000
    assert net.output_size() == 1001
    assert net.capacity >= 1001
    assert len(calls) == 1  # one pre-size, no growth inside the loop
    # every file got a distinct burn-in label written back
    labels = [c for _, c in files]
    assert sorted(labels) == list(range(1, 1001))


def test_host_loop_growth_is_log_n(monkeypatch):
    """The host-stepped loop doubles capacity O(log n) times: 301 speakers
    from capacity 128 is exactly 2 doublings (256, 512)."""
    from streamz_tpu.app.incremental import run_incremental_host

    rng = np.random.default_rng(1)
    files = [(f"g{i:04d}.wav", None) for i in range(300)]
    fm = {p: rng.normal(size=(8, 60)).astype(np.float32) for p, _ in files}
    net = SpeakerNet.new(output=1, seed=0)
    calls = _count_growth(monkeypatch)

    run_incremental_host(net, files, fm, burn_in_limit=300, show_progress=False)

    assert net.output_size() == 301
    assert calls == [256, 512]


# ---------------------------------------------------------------------------
# Both branches of the adaptive gate's speaker-count factor
# (infer/cosine.py; reference src/lib.rs:1604-1631: f = 0.3 under 200
# speakers, else 1.0).
# ---------------------------------------------------------------------------


def _gate_fixture(n_speakers: int):
    """Centroid 0 gets sim 0.45 to the probe — between mean+0.3*std (0.43)
    and mean+1.0*std (0.5), and not above the 0.5 shortcut — so the factor
    branch alone decides acceptance."""
    rng = np.random.default_rng(2)
    dim = 64
    e0 = np.zeros(dim, np.float32)
    e0[0] = 1.0
    stats = [(e0, 0.4, 0.1)]
    for _ in range(n_speakers - 1):
        v = rng.normal(size=dim).astype(np.float32)
        v[0] = 0.0  # orthogonal to the probe: sim 0 -> fails the 0.35 gate
        stats.append((v / np.linalg.norm(v), 0.4, 0.1))
    emb = np.zeros(dim, np.float32)
    emb[0], emb[1] = 0.45, np.sqrt(1 - 0.45**2)
    return emb, stats


def test_adaptive_gate_factor_small_population():
    from streamz_tpu.infer.cosine import _adaptive_match

    emb, stats = _gate_fixture(150)  # < 200 -> factor 0.3 -> accepted
    assert _adaptive_match(emb, stats, 0.35) == 0


def test_adaptive_gate_factor_large_population():
    from streamz_tpu.infer.cosine import _adaptive_match

    emb, stats = _gate_fixture(250)  # >= 200 -> factor 1.0 -> rejected
    assert _adaptive_match(emb, stats, 0.35) is None


# ---------------------------------------------------------------------------
# Eval at the 1000-speaker stretch config stays batched (one GEMM), not a
# per-centroid Python loop: runtime sanity.
# ---------------------------------------------------------------------------


def test_evaluate_1000_speakers_runtime():
    import time

    from streamz_tpu.app.evaluate import evaluate

    rng = np.random.default_rng(3)
    net = SpeakerNet.new(output=1000, seed=0)
    h2 = net.embedding_size()
    net.set_embeddings(
        [
            (rng.normal(size=h2).astype(np.float32), 0.5, 0.05)
            for _ in range(1000)
        ]
    )
    targets = [(f"e{i:03d}.wav", i % 1000) for i in range(100)]
    fm = {p: rng.normal(size=(6, 60)).astype(np.float32) for p, _ in targets}

    start = time.time()
    metrics = evaluate(net, fm, targets, threshold=0.8, verbose=False)
    elapsed = time.time() - start
    assert elapsed < 60.0, elapsed
    assert set(metrics) >= {"accuracy", "precision", "recall", "f1"}
    total = (
        metrics["true_positive"]
        + metrics["false_positive"]
        + metrics["false_negative"]
    )
    assert total == 100


def test_checkpoint_roundtrip_1000_speakers(tmp_path):
    """Save/load at the stretch config: 1000 live classes -> 1000 per-column
    w3_i arrays in the npz (the reference's exact schema), loaded back into
    a capacity-1024 net with identical live weights and growth behavior."""
    import numpy as np

    from streamz_tpu.nn import checkpoint
    from streamz_tpu.nn.model import SpeakerNet

    net = SpeakerNet.new(input_size=16, hidden1=32, hidden2=16, output=1000,
                         seed=0)
    for i in range(0, 1000, 97):
        net.record_training_file(i, f"f{i}.wav")
    path = tmp_path / "model.npz"
    checkpoint.save(net, str(path))

    loaded = checkpoint.load(str(path))
    assert loaded.output_size() == 1000
    assert loaded.capacity == net.capacity
    w3a, _ = net.output_layer()
    w3b, _ = loaded.output_layer()
    np.testing.assert_array_equal(w3a, w3b)

    # Growth after load stays functional at scale.
    loaded.add_output_class()
    assert loaded.output_size() == 1001


def test_full_size_corpus_train_and_eval_1000_speakers(tmp_path):
    """The production configuration — 60x512x256 with 1000 live classes —
    trains data-parallel on the 8-device mesh (loss drops) and runs the eval
    pipeline end-to-end at that scale."""
    from streamz_tpu.app.evaluate import evaluate
    from streamz_tpu.infer.embed import batch_clip_embeddings

    rng = np.random.default_rng(3)
    n_classes, per_class, dim = 1000, 3, 60
    centers = rng.normal(size=(n_classes, dim)).astype(np.float32) * 3.0
    x = (
        centers[:, None, :]
        + rng.normal(0, 0.3, size=(n_classes, per_class, dim))
    ).reshape(-1, dim).astype(np.float32)
    y = np.repeat(np.arange(n_classes, dtype=np.int32), per_class)

    net = SpeakerNet.new(output=n_classes, seed=4)  # real 60x512x256 dims
    assert net.params["w1"].shape == (60, 512)
    assert net.params["w2"].shape == (512, 256)
    mesh = comm.make_mesh(8)
    losses = train_corpus(net, x, y, epochs=3, batch_size=512, lr=0.5, mesh=mesh)
    assert len(losses) == 3
    assert losses[-1] < losses[0] * 0.9

    # Eval pass at scale: per-speaker centroid = the mean clip embedding of
    # its training windows; a 200-file probe set must score well above
    # chance through the real evaluate() pipeline.
    probe_ids = rng.choice(n_classes, size=200, replace=False)
    fm = {}
    targets = []
    clips = []
    for i, sid in enumerate(probe_ids):
        wins = (
            centers[sid] + rng.normal(0, 0.3, size=(8, dim))
        ).astype(np.float32)
        path = f"probe_{i}.npy"
        fm[path] = wins
        targets.append((path, int(sid)))
        clips.append(wins)

    cent_clips = [
        (centers[s] + rng.normal(0, 0.3, size=(8, dim))).astype(np.float32)
        for s in range(n_classes)
    ]
    cents = batch_clip_embeddings(net, cent_clips, mesh=mesh)
    net.set_embeddings([(c, 0.9, 0.05) for c in cents])

    metrics = evaluate(net, fm, targets, 0.2, verbose=False, mesh=mesh)
    assert metrics["accuracy"] > 0.5  # way above the 1/1000 chance floor


_SOAK_WORKER = r'''
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, %(repo)r)
from streamz_tpu.cli import main
sys.exit(main([]))
'''


@pytest.mark.slow
def test_corpus_soak_2k_files_store_eviction_and_determinism(tmp_path):
    """Corpus soak: a ~2k-file synthetic corpus through the
    full CLI on the 8-device mesh, with STREAMZ_STORE_MAX_MB sized so the
    memory cap EVICTS one ingest bucket (its clips miss and host-pack — the
    partial-gather path at scale) while the other stays device-resident.
    Pins: both runs complete, labels are identical across two fresh runs,
    and peak child RSS stays bounded."""
    import os
    import resource
    import subprocess
    import sys as _sys

    from streamz_tpu.io.wav import write_wav

    n_files = int(os.environ.get("STREAMZ_SOAK_FILES", "2000"))
    rng = np.random.default_rng(0)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def stage(root):
        (root / "data").mkdir(parents=True)
        names = []
        for i in range(n_files):
            # Two interleaved lengths -> two ingest buckets -> mixed
            # hit/miss chunks once the cap evicts the larger bucket.
            n = 3200 if i % 3 else 4800
            pcm = rng.normal(0, 3000, size=n).astype(np.int16)
            p = f"data/s_{i:05d}.wav"
            write_wav(str(root / p), pcm, 44100)
            names.append(p)
        (root / "train_files.txt").write_text(
            "".join(x + "\n" for x in names)
        )

    # Ingest pads each clip to its pow2 block bucket, so the stored feature
    # tensors are [B, tlen/400 - 1, 60] f32.  Size both buckets exactly and
    # set the cap between them: the LARGER is evicted, the smaller stays.
    from streamz_tpu.dsp.mfcc import _bucket_len

    def bucket_bytes(n_samples, count):
        return count * (_bucket_len(n_samples) // 400 - 1) * 60 * 4

    n_4800 = (n_files + 2) // 3  # i % 3 == 0 rows
    b_3200 = bucket_bytes(3200, n_files - n_4800)
    b_4800 = bucket_bytes(4800, n_4800)
    cap_mb = (min(b_3200, b_4800) + abs(b_3200 - b_4800) / 2) / 1e6

    # Eviction observability: same corpus shape through the ingest API with
    # the same cap must record a dropped bucket AND still serve consumers.
    from streamz_tpu.dsp.mfcc import DeviceFeatureStore, extract_features_batch

    store = DeviceFeatureStore(max_bytes=int(cap_mb * 1e6))
    sample = [
        rng.normal(0, 0.2, size=(3200 if i % 3 else 4800,)).astype(np.float32)
        for i in range(n_files)
    ]
    feats = extract_features_batch(sample, store=store)
    assert store.stats["dropped_buckets"] >= 1
    assert any(store.lookup(i) is not None for i in range(n_files))
    assert all(f is not None for f in feats)
    del store, sample, feats

    before = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss

    outs = []
    for run in range(2):
        root = tmp_path / f"run{run}"
        stage(root)
        env = dict(os.environ, STREAMZ_STORE_MAX_MB=repr(cap_mb))
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run(
            [_sys.executable, "-c", _SOAK_WORKER % {"repo": repo}],
            cwd=str(root), env=env, capture_output=True, text=True,
            timeout=1800,
        )
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
        outs.append((root / "train_files.txt").read_text())

    assert outs[0] == outs[1], "labels diverged between identical soak runs"
    peak = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    # ru_maxrss is KiB on Linux; bound the soak's peak child RSS at 6 GB
    # (graceful degradation must not balloon host memory).
    assert peak < 6 * 1024 * 1024, f"peak child RSS {peak} KiB"
    assert peak >= before  # the measurement actually covered the children


def test_corpus_dropout_device_count_invariant():
    """Dropout masks are drawn for the UNPADDED pool only, so the rng
    stream (shuffles + masks) is identical across device counts; the
    trained params then agree up to psum reduction-order float noise
    (the draw used to cover n_pad rows, whose size depends on the
    mesh-multiple batch rounding — the rng would then diverge on every
    epoch after the first)."""
    rng = np.random.default_rng(7)
    dim = 16
    x = rng.normal(size=(90, dim)).astype(np.float32)
    y = rng.integers(0, 3, size=(90,)).astype(np.int32)
    results = []
    for nd in (2, 8):
        net = SpeakerNet.new(input_size=dim, hidden1=32, hidden2=16,
                             output=3, seed=5)
        train_corpus(net, x, y, epochs=3, batch_size=40, lr=0.1,
                     dropout=0.2, mesh=comm.make_mesh(nd), seed=11)
        results.append({k: np.asarray(v) for k, v in net.params.items()})
    for k in results[0]:
        np.testing.assert_allclose(
            results[0][k], results[1][k], rtol=0, atol=1e-6,
        )
