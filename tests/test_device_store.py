"""Device-resident feature handoff: ingest → discovery loop with no
host→device feature re-upload.

The frontend computes features on device and fetches host copies (the
feature-cache contract); :class:`streamz_tpu.dsp.mfcc.DeviceFeatureStore`
additionally keeps the device outputs alive so the fused discovery loop
assembles its chunks by device-side gather.  The gather must be
bit-identical to host zero-padded packing (deltas_and_norm zeroes frames
beyond each clip's window count), so labels/params/centroids must match the
host-packed path exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from streamz_tpu import config
from streamz_tpu.app.incremental import run_incremental
from streamz_tpu.dsp.mfcc import (
    DeviceFeatureStore,
    extract_features_batch,
    window_count_host,
)
from streamz_tpu.nn import drivers
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.parallel import comm


def _clips(rng, n=6):
    # Mixed lengths across several ingest buckets, incl. one < WINDOW_SIZE.
    lens = [4000, 9000, 4000, 22000, 700, 9000][:n]
    return [rng.normal(0, 0.2, size=(l,)).astype(np.float32) for l in lens]


def test_store_rows_match_host_outputs():
    rng = np.random.default_rng(0)
    clips = _clips(rng)
    store = DeviceFeatureStore()
    feats = extract_features_batch(clips, store=store)
    for i, clip in enumerate(clips):
        hit = store.lookup(i)
        assert hit is not None
        bid, row, n_win = hit
        assert n_win == window_count_host(len(clip)) == len(feats[i])
        got = np.asarray(store.bucket(bid)[row])
        # valid frames identical; padding frames exact zeros
        assert np.array_equal(got[:n_win], feats[i])
        assert not got[n_win:].any()


def test_store_rekey_and_release():
    rng = np.random.default_rng(1)
    clips = _clips(rng, n=3)
    store = DeviceFeatureStore()
    extract_features_batch(clips, store=store)
    store.rekey({0: "a.wav", 1: "b.wav", 2: "c.wav"})
    assert store.lookup("b.wav") is not None
    assert store.lookup(1) is None
    store.release()
    assert store.lookup("a.wav") is None


def _feature_corpus(rng, n_files, n_clusters, windows_per_file=8, dim=60):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 2.0
    files, fm = [], {}
    for i in range(n_files):
        c = i % n_clusters
        wins = (
            centers[c] + rng.normal(0, 0.3, size=(windows_per_file, dim))
        ).astype(np.float32)
        files.append((f"clip_{i}.wav", None))
        fm[f"clip_{i}.wav"] = wins
    return files, fm


def _synthetic_store(fm, paths, mesh=None):
    """Build a store whose buckets hold the feature_map windows directly
    (one bucket per distinct window count), as the ingest stage would."""
    store = DeviceFeatureStore(mesh=mesh)
    by_w: dict = {}
    for i, p in enumerate(paths):
        by_w.setdefault(fm[p].shape[0], []).append(i)
    for w, idxs in by_w.items():
        batch = np.stack([fm[paths[i]] for i in idxs])
        arr = jnp.asarray(batch)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from streamz_tpu.parallel.mesh import pad_rows_to_mesh

            _, (padded,) = pad_rows_to_mesh(mesh, batch)
            arr = jax.device_put(
                padded, NamedSharding(mesh, P(mesh.axis_names[0]))
            )
        store.add_bucket(arr, idxs, [w] * len(idxs))
    store.rekey({i: p for i, p in enumerate(paths)})
    return store


def _run_loop(files, fm, *, mesh=None, device_store=None, **kw):
    drivers._key_counter[0] = 1000  # identical PRNG streams across runs
    net = SpeakerNet.new(output=1, seed=0)
    fs = [tuple(f) for f in files]
    run_incremental(
        net, fs, dict(fm), show_progress=False, mesh=mesh,
        device_store=device_store, **kw,
    )
    return net, [c for _, c in fs]


def test_loop_with_store_bit_identical_single_device():
    rng = np.random.default_rng(2)
    files, fm = _feature_corpus(rng, 20, 3)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    store = _synthetic_store(fm, paths)
    kw = dict(burn_in_limit=4, conf_threshold=0.8, epochs=1)
    net_h, labels_h = _run_loop(files, fm, **kw)
    net_s, labels_s = _run_loop(files, fm, device_store=store, **kw)
    assert labels_s == labels_h
    for k in net_h.params:
        assert np.array_equal(
            np.asarray(net_h.params[k]), np.asarray(net_s.params[k])
        ), k


def test_loop_with_store_bit_identical_sharded():
    mesh = comm.make_mesh(8)
    rng = np.random.default_rng(3)
    files, fm = _feature_corpus(rng, 16, 4)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    kw = dict(burn_in_limit=4, conf_threshold=0.8, epochs=1)
    net_h, labels_h = _run_loop(files, fm, mesh=mesh, **kw)
    store = _synthetic_store(fm, paths, mesh=mesh)
    net_s, labels_s = _run_loop(files, fm, mesh=mesh, device_store=store, **kw)
    assert labels_s == labels_h
    for k in net_h.params:
        assert np.array_equal(
            np.asarray(net_h.params[k]), np.asarray(net_s.params[k])
        ), k


def test_loop_store_miss_falls_back_per_chunk():
    """A file missing from the store (e.g. routed through the PCM-sharded
    long-clip frontend) host-packs its chunk; results stay identical."""
    rng = np.random.default_rng(4)
    files, fm = _feature_corpus(rng, 12, 3)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    store = _synthetic_store(fm, [p for p in paths if p != paths[5]])
    kw = dict(burn_in_limit=3, conf_threshold=0.8, epochs=1)
    net_h, labels_h = _run_loop(files, fm, **kw)
    net_s, labels_s = _run_loop(files, fm, device_store=store, **kw)
    assert labels_s == labels_h
    for k in net_h.params:
        assert np.array_equal(
            np.asarray(net_h.params[k]), np.asarray(net_s.params[k])
        ), k


def test_loop_store_partial_gather_uploads_only_misses():
    """One store-missed clip must NOT forfeit device residency for its
    chunk: results stay bit-identical AND the host→device
    repair upload covers exactly the missing rows."""
    rng = np.random.default_rng(40)
    files, fm = _feature_corpus(rng, 12, 3)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    store = _synthetic_store(fm, [p for p in paths if p != paths[5]])
    kw = dict(burn_in_limit=3, conf_threshold=0.8, epochs=1)
    net_h, labels_h = _run_loop(files, fm, **kw)
    net_s, labels_s = _run_loop(files, fm, device_store=store, **kw)
    assert labels_s == labels_h
    for k in net_h.params:
        assert np.array_equal(
            np.asarray(net_h.params[k]), np.asarray(net_s.params[k])
        ), k
    # Host-bytes-moved assertion: exactly ONE row (the miss) was packed and
    # uploaded — w_pad = next_pow2(ceil(8 windows / batch 8)) * 8 = 8.
    assert store.stats["host_pack_rows"] == 1
    assert store.stats["host_pack_bytes"] == 1 * 8 * 60 * 4


def test_loop_store_partial_gather_sharded_miss():
    """Same contract under the SPMD discovery scan: a missed clip is
    repaired by a single-row scatter, labels/params bit-identical."""
    mesh = comm.make_mesh(8)
    rng = np.random.default_rng(41)
    files, fm = _feature_corpus(rng, 16, 4)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    store = _synthetic_store(
        fm, [p for p in paths if p != paths[7]], mesh=mesh
    )
    kw = dict(burn_in_limit=4, conf_threshold=0.8, epochs=1)
    net_h, labels_h = _run_loop(files, fm, mesh=mesh, **kw)
    net_s, labels_s = _run_loop(
        files, fm, mesh=mesh, device_store=store, **kw
    )
    assert labels_s == labels_h
    for k in net_h.params:
        assert np.array_equal(
            np.asarray(net_h.params[k]), np.asarray(net_s.params[k])
        ), k
    assert store.stats["host_pack_rows"] == 1


def test_batch_embeddings_partial_gather_uploads_only_misses():
    """The pooled-embedding buckets repair store misses per row too."""
    rng = np.random.default_rng(42)
    files, fm = _feature_corpus(rng, 10, 3, windows_per_file=6)
    paths = [p for p, _ in files]
    net = SpeakerNet.new(output=3, seed=1)
    store = _synthetic_store(fm, [p for p in paths if p not in paths[2:4]])
    ref = _embed_all(net, fm, paths)
    got = _embed_all(net, fm, paths, store=store)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    # Two misses in a 10-clip bucket: exactly two rows uploaded.
    assert store.stats["host_pack_rows"] == 2


def test_loop_mesh_mismatched_store_is_ignored():
    """A store built under a different sharding than the loop's effective
    one must be dropped, not fed to a scan traced for other devices."""
    mesh = comm.make_mesh(8)
    rng = np.random.default_rng(5)
    files, fm = _feature_corpus(rng, 8, 2)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    store = _synthetic_store(fm, paths, mesh=mesh)  # mesh-sharded buckets
    kw = dict(burn_in_limit=2, conf_threshold=0.8, epochs=1)
    # Single-device loop (no mesh): the mesh-built store must be ignored.
    net_h, labels_h = _run_loop(files, fm, **kw)
    net_s, labels_s = _run_loop(files, fm, device_store=store, **kw)
    assert labels_s == labels_h


def _embed_all(net, fm, paths, mesh=None, store=None):
    from streamz_tpu.infer.embed import batch_clip_embeddings

    return batch_clip_embeddings(
        net, [fm[p] for p in paths], mesh=mesh, store=store, keys=paths
    )


def test_batch_embeddings_store_bit_identical_single_device():
    rng = np.random.default_rng(7)
    files, fm = _feature_corpus(rng, 10, 3, windows_per_file=6)
    # Mixed window counts across pooling buckets.
    for i, (p, _) in enumerate(files[:4]):
        fm[p] = fm[p][: 2 + i]
    paths = [p for p, _ in files]
    net = SpeakerNet.new(output=3, seed=1)
    store = _synthetic_store(fm, paths)
    ref = _embed_all(net, fm, paths)
    got = _embed_all(net, fm, paths, store=store)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)


def test_batch_embeddings_store_bit_identical_sharded():
    mesh = comm.make_mesh(8)
    rng = np.random.default_rng(8)
    files, fm = _feature_corpus(rng, 12, 3, windows_per_file=9)
    paths = [p for p, _ in files]
    net = SpeakerNet.new(output=3, seed=1)
    store = _synthetic_store(fm, paths, mesh=mesh)
    ref = _embed_all(net, fm, paths, mesh=mesh)
    got = _embed_all(net, fm, paths, mesh=mesh, store=store)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)


def test_batch_embeddings_store_miss_and_mesh_mismatch():
    mesh = comm.make_mesh(8)
    rng = np.random.default_rng(9)
    files, fm = _feature_corpus(rng, 6, 2, windows_per_file=5)
    paths = [p for p, _ in files]
    net = SpeakerNet.new(output=2, seed=2)
    ref = _embed_all(net, fm, paths)
    # One path missing -> its bucket host-packs; results identical.
    store = _synthetic_store(fm, paths[:-1])
    got = _embed_all(net, fm, paths, store=store)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    # Store built under a mesh fed to a no-mesh call -> ignored, identical.
    store_m = _synthetic_store(fm, paths, mesh=mesh)
    got2 = _embed_all(net, fm, paths, store=store_m)
    for a, b in zip(ref, got2):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("use_mesh", [False, True])
def test_evaluate_with_store_identical_metrics(use_mesh):
    from streamz_tpu.app.evaluate import evaluate
    from streamz_tpu.infer.embed import normalize

    mesh = comm.make_mesh(8) if use_mesh else None
    rng = np.random.default_rng(10)
    files, fm = _feature_corpus(rng, 12, 3, windows_per_file=7)
    paths = [p for p, _ in files]
    net = SpeakerNet.new(output=3, seed=3)
    # Centroids from the clips themselves so some eval rows match.
    embs = _embed_all(net, fm, paths, mesh=mesh)
    cents = [
        (normalize(np.mean(embs[i::3], axis=0)), 0.9, 0.05) for i in range(3)
    ]
    net.set_embeddings(cents)
    targets = [(p, i % 3) for i, p in enumerate(paths)]
    ref = evaluate(net, fm, targets, 0.2, verbose=False, mesh=mesh)
    store = _synthetic_store(fm, paths, mesh=mesh)
    got = evaluate(
        net, fm, targets, 0.2, verbose=False, mesh=mesh, store=store
    )
    assert got == ref
    assert ref["correct"] > 0  # the comparison is non-vacuous


def test_compute_speaker_embeddings_feature_map_and_store(tmp_path, monkeypatch):
    """Finalize centroid recompute: the in-memory feature map replaces the
    per-file re-ingest on cache miss (bit-identical to the cache path, and
    it publishes the cache), an existing cache file still wins, and the
    device store feeds the map-sourced batches."""
    from streamz_tpu.dsp.features import save_cached_features
    from streamz_tpu.infer.cosine import compute_speaker_embeddings
    from streamz_tpu.io import audio as io_audio

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(11)
    files, fm = _feature_corpus(rng, 9, 3, windows_per_file=6)
    paths = [p for p, _ in files]
    net = SpeakerNet.new(output=3, seed=4)
    for i, p in enumerate(paths):
        net.record_training_file(i % 3, p)

    # Ground truth: the pure cache path.
    for p in paths:
        save_cached_features(p, fm[p])
    ref = compute_speaker_embeddings(net)
    import shutil

    shutil.rmtree("feature_cache")

    # Cache miss + feature_map: identical stats, cache published.
    got = compute_speaker_embeddings(net, feature_map=fm)
    for (m1, a1, s1), (m2, a2, s2) in zip(ref, got):
        assert np.array_equal(m1, m2) and a1 == a2 and s1 == s2
    for p in paths:
        cache = io_audio.feature_cache_path(p)
        assert cache.exists()
        assert np.array_equal(np.load(cache), fm[p])
    shutil.rmtree("feature_cache")

    # Device store feeds the map-sourced batches: still identical.
    store = _synthetic_store(fm, paths)
    got_s = compute_speaker_embeddings(net, feature_map=fm, store=store)
    for (m1, a1, s1), (m2, a2, s2) in zip(ref, got_s):
        assert np.array_equal(m1, m2) and a1 == a2 and s1 == s2
    shutil.rmtree("feature_cache")

    # An existing cache file beats the map (on-disk is authoritative).
    other = fm[paths[0]] + 1.0
    save_cached_features(paths[0], other)
    got_c = compute_speaker_embeddings(net, feature_map=fm)
    assert not np.array_equal(got_c[0][0], ref[0][0])


def test_store_max_bytes_cap():
    """Over-budget buckets are dropped (clips miss, consumers host-pack);
    under-budget ones register normally."""
    a = jnp.zeros((2, 4, 60), jnp.float32)
    store = DeviceFeatureStore(max_bytes=int(a.nbytes))
    store.add_bucket(a, [0, 1], [4, 4])
    b = jnp.zeros((2, 4, 60), jnp.float32)
    store.add_bucket(b, [2, 3], [4, 4])  # would exceed the cap -> dropped
    assert store.lookup(0) is not None
    assert store.lookup(2) is None
    store.release()
    assert store._bytes == 0

    # An all-miss (capped-out) store leaves the loop bit-identical.
    rng = np.random.default_rng(12)
    files, fm = _feature_corpus(rng, 8, 2)
    files[0] = (files[0][0], 0)
    empty = DeviceFeatureStore(max_bytes=1)
    kw = dict(burn_in_limit=2, conf_threshold=0.8, epochs=1)
    net_h, labels_h = _run_loop(files, fm, **kw)
    net_s, labels_s = _run_loop(files, fm, device_store=empty, **kw)
    assert labels_s == labels_h
    for k in net_h.params:
        assert np.array_equal(
            np.asarray(net_h.params[k]), np.asarray(net_s.params[k])
        ), k


def test_cli_store_env_knob(tmp_path, monkeypatch):
    """STREAMZ_STORE_MAX_MB<=0 disables the store in build_feature_map."""
    from streamz_tpu.cli import build_feature_map
    from streamz_tpu.dsp.features import FeatureExtractor
    from streamz_tpu.io import wav

    rng = np.random.default_rng(13)
    pcm = (rng.normal(0, 0.1, size=(4000,)) * 20000).astype(np.int16)
    p = tmp_path / "c.wav"
    wav.write_wav(str(p), pcm, config.DEFAULT_SAMPLE_RATE)
    monkeypatch.setenv("STREAMZ_STORE_MAX_MB", "0")
    fmap, store = build_feature_map(
        [str(p)], FeatureExtractor("auto"), keep_device=True
    )
    assert store is None and str(p) in fmap
    monkeypatch.setenv("STREAMZ_STORE_MAX_MB", "64")
    fmap, store = build_feature_map(
        [str(p)], FeatureExtractor("auto"), keep_device=True
    )
    assert store is not None and store.lookup(str(p)) is not None


def test_cli_store_paths_filter(tmp_path):
    """build_feature_map(store_paths=...) pins only the requested clips —
    eval mode must not spend the device-memory budget on training files whose rows
    are never gathered."""
    from streamz_tpu.cli import build_feature_map
    from streamz_tpu.dsp.features import FeatureExtractor
    from streamz_tpu.io import wav

    rng = np.random.default_rng(14)
    paths = []
    for i in range(4):
        pcm = (rng.normal(0, 0.1, size=(4000 + 1000 * i,)) * 20000).astype(
            np.int16
        )
        p = tmp_path / f"f{i}.wav"
        wav.write_wav(str(p), pcm, config.DEFAULT_SAMPLE_RATE)
        paths.append(str(p))
    keep = set(paths[2:])
    fmap, store = build_feature_map(
        paths, FeatureExtractor("auto"), keep_device=True, store_paths=keep
    )
    assert store is not None
    for p in paths:
        assert p in fmap
        hit = store.lookup(p)
        if p in keep:
            assert hit is not None
            bid, row, n_win = hit
            assert np.array_equal(
                np.asarray(store.bucket(bid)[row])[:n_win], fmap[p]
            )
        else:
            assert hit is None
    # Only the kept clips' buckets are resident.
    total_rows = sum(int(b.shape[0]) for b in store._buckets)
    assert total_rows <= len(keep) + 1  # +1 allows a mesh-padding row
    store.release()


def test_cli_build_feature_map_returns_path_keyed_store(tmp_path):
    from streamz_tpu.cli import build_feature_map
    from streamz_tpu.dsp.features import FeatureExtractor
    from streamz_tpu.io import wav

    rng = np.random.default_rng(6)
    paths = []
    for i in range(3):
        pcm = (rng.normal(0, 0.1, size=(4000 + 2000 * i,)) * 20000).astype(
            np.int16
        )
        p = tmp_path / f"c{i}.wav"
        wav.write_wav(str(p), pcm, config.DEFAULT_SAMPLE_RATE)
        paths.append(str(p))
    fmap, store = build_feature_map(
        paths, FeatureExtractor("auto"), keep_device=True
    )
    assert store is not None
    for p in paths:
        hit = store.lookup(p)
        assert hit is not None
        bid, row, n_win = hit
        assert np.array_equal(
            np.asarray(store.bucket(bid)[row])[:n_win], fmap[p]
        )
    store.release()


def test_partial_gather_non_pow2_miss_count_meters_misses_only():
    """3 misses pad to a 4-row scatter dispatch, but host_pack_bytes must
    meter the MISSES ONLY (the docstring contract) — not the pow2-padded
    payload — and results stay bit-identical to the host-packed loop."""
    rng = np.random.default_rng(41)
    files, fm = _feature_corpus(rng, 12, 3)
    files[0] = (files[0][0], 0)
    paths = [p for p, _ in files]
    missing = {paths[2], paths[5], paths[9]}
    store = _synthetic_store(fm, [p for p in paths if p not in missing])
    kw = dict(burn_in_limit=3, conf_threshold=0.8, epochs=1)
    net_h, labels_h = _run_loop(files, fm, **kw)
    net_s, labels_s = _run_loop(files, fm, device_store=store, **kw)
    assert labels_s == labels_h
    for k in net_h.params:
        assert np.array_equal(
            np.asarray(net_h.params[k]), np.asarray(net_s.params[k])
        ), k
    assert store.stats["host_pack_rows"] == 3
    assert store.stats["host_pack_bytes"] == 3 * 8 * 60 * 4


def test_gather_wrapper_all_or_nothing():
    """The thin all-or-nothing `gather` facade over `gather_partial`:
    full-hit key sets return the assembled tensor, any miss returns None."""
    rng = np.random.default_rng(42)
    clips = _clips(rng, n=3)
    store = DeviceFeatureStore()
    feats = extract_features_batch(clips, store=store)
    w_pad = config.next_pow2(max(len(f) for f in feats))
    wins = store.gather([0, 1, 2], w_pad)
    assert wins is not None and wins.shape == (3, w_pad, 60)
    for i, f in enumerate(feats):
        got = np.asarray(wins[i])
        assert np.array_equal(got[: len(f)], f)
        assert not got[len(f):].any()
    assert store.gather([0, 1, 99], w_pad) is None
