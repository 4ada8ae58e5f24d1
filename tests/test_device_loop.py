"""Fused device-resident incremental loop vs the host-stepped oracle.

The device loop (app/device_loop.py) moves embed→match→grow→train→centroid
into one dispatch per file with all decision state on device.  These tests
pin its behavior to the host formulation on well-separated synthetic data
(dropout 0 so the two loops' different RNG streams can't diverge the
trajectories) and cover the decision branches.
"""

import numpy as np
import pytest

from streamz_tpu.app.incremental import run_incremental, run_incremental_host
from streamz_tpu.nn.model import SpeakerNet


def _corpus(n_files, n_clusters, rng, windows_per_file=8, dim=60, noise=0.1):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 3.0
    files, fm = [], {}
    for i in range(n_files):
        c = i % n_clusters
        wins = (centers[c] + rng.normal(0, noise, size=(windows_per_file, dim))
                ).astype(np.float32)
        path = f"clip_{i}.wav"
        files.append((path, None))
        fm[path] = wins
    return files, fm


def _run_both(files, fm, **kw):
    rng_files_d = [tuple(f) for f in files]
    rng_files_h = [tuple(f) for f in files]
    net_d = SpeakerNet.new(output=1, seed=0)
    net_h = SpeakerNet.new(output=1, seed=0)
    res_d = run_incremental(net_d, rng_files_d, dict(fm), show_progress=False, **kw)
    res_h = run_incremental_host(net_h, rng_files_h, dict(fm), show_progress=False, **kw)
    return (net_d, rng_files_d, res_d), (net_h, rng_files_h, res_h)


def test_device_loop_matches_host_labels():
    rng = np.random.default_rng(0)
    files, fm = _corpus(30, 3, rng)
    files[0] = (files[0][0], 0)
    (net_d, fd, rd), (net_h, fh, rh) = _run_both(
        files, fm, burn_in_limit=6, conf_threshold=0.8, dropout=0.0, epochs=1
    )
    assert [c for _, c in fd] == [c for _, c in fh]
    assert net_d.output_size() == net_h.output_size()
    assert rd.processed == rh.processed == 30
    # centroids agree
    for sid, c in rh.speaker_embeddings.items():
        np.testing.assert_allclose(
            rd.speaker_embeddings[sid], c, rtol=1e-3, atol=1e-5
        )


def test_device_loop_matches_host_with_seeds_and_labels():
    """Pre-seeded centroids (resume) + a mix of labeled files."""
    rng = np.random.default_rng(3)
    files, fm = _corpus(16, 2, rng)
    for i in (0, 1, 4):
        files[i] = (files[i][0], i % 2)

    def fresh_net():
        net = SpeakerNet.new(output=2, seed=1)
        net.set_embeddings(
            [
                (np.ones(net.embedding_size(), np.float32) / 16.0, 0.9, 0.05),
                (-np.ones(net.embedding_size(), np.float32) / 16.0, 0.9, 0.05),
            ]
        )
        return net

    fd = [tuple(f) for f in files]
    fh = [tuple(f) for f in files]
    nd, nh = fresh_net(), fresh_net()
    run_incremental(nd, fd, dict(fm), burn_in_limit=2, conf_threshold=0.8,
                    dropout=0.0, epochs=1, show_progress=False)
    run_incremental_host(nh, fh, dict(fm), burn_in_limit=2, conf_threshold=0.8,
                         dropout=0.0, epochs=1, show_progress=False)
    assert [c for _, c in fd] == [c for _, c in fh]
    assert nd.output_size() == nh.output_size()
    assert nd.file_lists == nh.file_lists


def test_device_loop_max_speakers_cap():
    rng = np.random.default_rng(2)
    files, fm = _corpus(12, 6, rng)
    net = SpeakerNet.new(output=1, seed=0)
    files[0] = (files[0][0], 0)
    run_incremental(
        net, files, fm, burn_in_limit=12, conf_threshold=0.99,
        epochs=1, max_speakers=4, show_progress=False, dropout=0.0,
    )
    assert net.output_size() <= 4
    assert all(c is not None and c < 4 for _, c in files)


def test_device_loop_out_of_range_label_trains_zero_target():
    """A given label beyond the live classes must not grow the model
    (the reference's zero-target quirk, src/lib.rs:592-594)."""
    rng = np.random.default_rng(4)
    files, fm = _corpus(3, 1, rng)
    files = [(p, 7) for p, _ in files]  # label 7 >> output_size 1
    net = SpeakerNet.new(output=1, seed=0)
    run_incremental(net, files, fm, burn_in_limit=0, epochs=1,
                    dropout=0.0, show_progress=False)
    assert net.output_size() == 1  # no growth for labeled files
    assert all(c == 7 for _, c in files)


def test_device_loop_few_dispatches(monkeypatch):
    """The fused loop must batch files into scan dispatches, not dispatch
    (let alone synchronize) per file — the dispatch-tax regression guard."""
    from streamz_tpu.app import device_loop as dl

    rng = np.random.default_rng(5)
    files, fm = _corpus(10, 2, rng)
    files[0] = (files[0][0], 0)
    net = SpeakerNet.new(output=1, seed=0)

    calls = {"n": 0}
    real_scan = dl.incremental_scan

    def counting_scan(*a, **kw):
        calls["n"] += 1
        return real_scan(*a, **kw)

    monkeypatch.setattr(dl, "incremental_scan", counting_scan)
    dl.run_incremental_device(
        net, files, fm, burn_in_limit=2, conf_threshold=0.8, dropout=0.0,
        batch_size=8, epochs=1, max_speakers=None, show_progress=False,
    )
    # 10 same-bucket files -> one padded-to-16 scan dispatch.
    assert calls["n"] == 1


def test_pow2_chunking():
    from streamz_tpu.app.device_loop import MAX_SCAN_FILES, _pow2_chunks

    assert _pow2_chunks(1) == [1]
    assert _pow2_chunks(10) == [16]
    assert _pow2_chunks(64) == [64]
    assert _pow2_chunks(150) == [64, 64, 32]
    assert sum(_pow2_chunks(64)) == MAX_SCAN_FILES


if __name__ == "__main__":
    pytest.main([__file__, "-v"])


def test_trainer_pad_invariant():
    """train_on_windows_impl is bit-identical across pad sizes (the property
    chunk-level bucket padding relies on): counter-based PRNG draws are
    prefix-stable, argsort is stable, and padding rows are masked."""
    import jax
    import jax.numpy as jnp

    from streamz_tpu.nn.model import init_params
    from streamz_tpu.nn.train import train_on_windows_impl

    rng = np.random.default_rng(0)
    params = init_params(60, 64, 32, 8, seed=0)
    cap = params["b3"].shape[0]
    w = rng.normal(0, 1, (100, 60)).astype(np.float32)
    tv = np.zeros(cap, np.float32)
    tv[2] = 1.0
    key = jax.random.PRNGKey(7)
    outs = []
    for n_pad in (104, 416):
        wp = np.zeros((n_pad, 60), np.float32)
        wp[:100] = w
        p2, loss = train_on_windows_impl(
            dict(params), jnp.asarray(wp), jnp.int32(100), jnp.asarray(tv),
            jnp.int32(8), key, jnp.float32(0.05), jnp.float32(0.2),
            epochs=5, batch_size=8,
        )
        outs.append((jax.tree_util.tree_map(np.asarray, p2), float(loss)))
    for k in outs[0][0]:
        np.testing.assert_array_equal(outs[0][0][k], outs[1][0][k])
    assert outs[0][1] == outs[1][1]


def test_interleaved_buckets_still_batch(monkeypatch):
    """Alternating short/long clips (different window buckets) must still
    batch into full chunks — files in a chunk pad to the chunk's max bucket,
    and labels are unchanged vs the host oracle."""
    from streamz_tpu.app import device_loop as dl

    rng = np.random.default_rng(6)
    centers = rng.normal(size=(2, 60)).astype(np.float32) * 3.0
    files, fm = [], {}
    n_files = 40
    for i in range(n_files):
        c = i % 2
        n_win = 8 if c == 0 else 30  # buckets 8 and 32 (spread 4)
        path = f"mix_{i}.wav"
        fm[path] = (
            centers[c] + rng.normal(0, 0.1, size=(n_win, 60))
        ).astype(np.float32)
        files.append((path, None))
    files[0] = (files[0][0], 0)

    calls = {"n": 0}
    real_scan = dl.incremental_scan

    def counting_scan(*a, **kw):
        calls["n"] += 1
        return real_scan(*a, **kw)

    monkeypatch.setattr(dl, "incremental_scan", counting_scan)
    fd = [tuple(f) for f in files]
    fh = [tuple(f) for f in files]
    net_d = SpeakerNet.new(output=1, seed=0)
    net_h = SpeakerNet.new(output=1, seed=0)
    dl.run_incremental_device(
        net_d, fd, dict(fm), burn_in_limit=4, conf_threshold=0.8, dropout=0.0,
        batch_size=8, epochs=1, max_speakers=None, show_progress=False,
    )
    assert calls["n"] <= n_files // dl.MAX_SCAN_FILES + 1  # not per-bucket runs
    run_incremental_host(
        net_h, fh, dict(fm), burn_in_limit=4, conf_threshold=0.8, dropout=0.0,
        batch_size=8, epochs=1, max_speakers=None, show_progress=False,
    )
    assert [c for _, c in fd] == [c for _, c in fh]
    assert net_d.output_size() == net_h.output_size()


def test_bucket_spread_cap_flushes():
    """A clip whose bucket exceeds MAX_BUCKET_SPREAD x the chunk's min bucket
    starts a new chunk, so short files never pad to a 10-minute clip."""
    from streamz_tpu.app import device_loop as dl

    rng = np.random.default_rng(8)
    files, fm = [], {}
    for i, n_win in enumerate([8, 8, 300, 8, 8]):  # 300 -> bucket 512
        path = f"spread_{i}.wav"
        fm[path] = rng.normal(0, 1, size=(n_win, 60)).astype(np.float32)
        files.append((path, 0))
    net = SpeakerNet.new(output=1, seed=0)
    res = dl.run_incremental_device(
        net, files, fm, burn_in_limit=0, conf_threshold=0.8, dropout=0.0,
        batch_size=8, epochs=1, max_speakers=None, show_progress=False,
    )
    assert res[1] == 5  # all processed, three chunks (8s | 512 | 8s)


def test_sharded_scan_matches_single_device():
    """The mesh path of the fused discovery loop (window-sharded embed +
    per-chunk psum gradients) produces identical labels
    and near-identical params at 1 vs 8 devices — same key, dropout on."""
    from streamz_tpu.app import device_loop as dl
    from streamz_tpu.nn import drivers
    from streamz_tpu.parallel import comm

    rng = np.random.default_rng(0)
    files, fm = _corpus(30, 3, rng, windows_per_file=20)
    files[0] = (files[0][0], 0)
    mesh8 = comm.make_mesh(8)

    def run(mesh, dropout):
        import jax

        drivers._key_counter[0] = 0
        fs = [tuple(f) for f in files]
        net = SpeakerNet.new(output=1, seed=0)
        res = dl.run_incremental_device(
            net, fs, dict(fm), burn_in_limit=6, conf_threshold=0.8,
            dropout=dropout, batch_size=8, epochs=2, max_speakers=None,
            show_progress=False, mesh=mesh,
        )
        params = jax.tree_util.tree_map(np.asarray, net.params)
        return [c for _, c in fs], net.output_size(), res[0], params

    for dropout in (0.0, 0.2):
        l1, n1, loss1, p1 = run(None, dropout)
        l8, n8, loss8, p8 = run(mesh8, dropout)
        assert l1 == l8
        assert n1 == n8
        assert abs(loss1 - loss8) < 1e-3
        for k in p1:  # f32 psum-order noise only
            np.testing.assert_allclose(p1[k], p8[k], atol=1e-3)


def test_sharded_scan_env_escape(monkeypatch):
    """STREAMZ_SHARD_DISCOVERY=0 forces the single-device scan even with a
    mesh active."""
    from streamz_tpu.app import device_loop as dl
    from streamz_tpu.parallel import comm

    monkeypatch.setenv("STREAMZ_SHARD_DISCOVERY", "0")
    calls = {"n": 0}
    real = dl.make_incremental_scan_sharded

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(dl, "make_incremental_scan_sharded", counting)
    rng = np.random.default_rng(1)
    files, fm = _corpus(4, 2, rng)
    net = SpeakerNet.new(output=1, seed=0)
    dl.run_incremental_device(
        net, files, fm, burn_in_limit=2, conf_threshold=0.8, dropout=0.0,
        batch_size=8, epochs=1, max_speakers=None, show_progress=False,
        mesh=comm.make_mesh(8),
    )
    assert calls["n"] == 0


def test_out_of_range_label_then_match_follows_reference():
    """An explicit label at/beyond the live class count seeds a centroid the
    reference still argmaxes over, spawning a NEW class when that centroid
    wins below the live range (src/main.rs:791-797).  The device loop must
    reproduce the host oracle here, not pre-mask the id (which silently
    matched the runner-up in-range centroid instead of spawning)."""
    rng = np.random.default_rng(7)
    dim, wpf = 60, 8
    base = rng.normal(size=dim).astype(np.float32) * 3.0
    tilt = rng.normal(size=dim).astype(np.float32)
    # Two CORRELATED clusters: an unlabeled B-file clears the threshold
    # against BOTH centroids, so the winner (not the gate) decides.
    center_a = base
    center_b = base + 1.2 * tilt

    def mk(center):
        return (center + rng.normal(0, 0.05, size=(wpf, dim))).astype(
            np.float32
        )

    files = [("a0.wav", 0), ("b_lab.wav", 5), ("b0.wav", None),
             ("b1.wav", None)]
    fm = {"a0.wav": mk(center_a), "b_lab.wav": mk(center_b),
          "b0.wav": mk(center_b), "b1.wav": mk(center_b)}
    (net_d, fd, rd), (net_h, fh, rh) = _run_both(
        files, fm, burn_in_limit=0, conf_threshold=0.2, dropout=0.0, epochs=1
    )
    assert [c for _, c in fd] == [c for _, c in fh]
    # The unlabeled B-files must have spawned a NEW class (the out-of-range
    # centroid 5 won), not matched class 0.
    assert fh[2][1] == net_h.output_size() - 1 != 0
    assert net_d.output_size() == net_h.output_size()
    assert set(rd.speaker_embeddings) == set(rh.speaker_embeddings)


def test_legacy_prng_falls_back_to_exact_buckets():
    """Under jax_threefry_partitionable=False (or a non-threefry PRNG),
    uniform(key, (n,))[i] DEPENDS on n, so chunk-max padding would train
    differently from the per-file host oracle.  The loop must detect the
    config, group only equal buckets, and still match the oracle exactly.
    (With dropout>0 so the divergence would actually bite via the masks.)"""
    import jax

    from streamz_tpu.app import device_loop as dl

    assert dl._prng_pad_invariant()  # default config
    jax.config.update("jax_threefry_partitionable", False)
    try:
        assert not dl._prng_pad_invariant()
        rng = np.random.default_rng(17)
        centers = rng.normal(size=(2, 60)).astype(np.float32) * 3.0
        files, fm = [], {}
        for i in range(16):
            n_win = 8 if i % 2 == 0 else 30  # buckets 8 and 32
            path = f"legacy_{i}.wav"
            fm[path] = (
                centers[i % 2] + rng.normal(0, 0.1, size=(n_win, 60))
            ).astype(np.float32)
            files.append((path, None))
        files[0] = (files[0][0], 0)
        fd = [tuple(f) for f in files]
        fh = [tuple(f) for f in files]
        net_d = SpeakerNet.new(output=1, seed=0)
        net_h = SpeakerNet.new(output=1, seed=0)
        dl.run_incremental_device(
            net_d, fd, dict(fm), burn_in_limit=4, conf_threshold=0.8,
            dropout=0.2, batch_size=8, epochs=2, max_speakers=None,
            show_progress=False,
        )
        run_incremental_host(
            net_h, fh, dict(fm), burn_in_limit=4, conf_threshold=0.8,
            dropout=0.2, batch_size=8, epochs=2, max_speakers=None,
            show_progress=False,
        )
        assert [c for _, c in fd] == [c for _, c in fh]
        assert net_d.output_size() == net_h.output_size()
    finally:
        jax.config.update("jax_threefry_partitionable", True)


def test_scan_backend_probe_executes_on_cpu_mesh(monkeypatch, tmp_path):
    """Run the (normally GPU-only) scan-backend probes end-to-end by faking
    a kernel backend on the 8-device CPU mesh: state is pre-committed to
    each candidate's placement OUTSIDE the timed region (so the cached
    choice measures the scans, not per-rep host->mesh replication), both
    candidates execute, and a winner lands in the autotune cache."""
    from streamz_tpu.app import device_loop
    from streamz_tpu.parallel import comm
    from streamz_tpu.runtime import autotune

    monkeypatch.setattr(autotune, "_CACHE_PATH", str(tmp_path / "t.json"))
    autotune.reset()
    monkeypatch.setattr(autotune, "on_gpu", lambda: True)
    try:
        mesh = comm.make_mesh(8)
        net = SpeakerNet.new(output=1, seed=0)
        choice = device_loop._resolve_scan_backend(
            mesh, 1, 8, net.params, 60, 8,
        )
        assert choice in ("single", "sharded")
        # and the decision is cached for this device kind
        assert device_loop._resolve_scan_backend(
            mesh, 1, 8, net.params, 60, 8,
        ) == choice
    finally:
        autotune.reset()
