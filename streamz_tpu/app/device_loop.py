"""Device-resident incremental loop: the whole corpus in a few dispatches.

A host-stepped incremental loop pays ~2 blocking device round-trips per
file (embedding fetch → host match → train dispatch), which dwarf the
per-file compute.  This loop moves the *entire* per-file body of the reference's hot loop C
(``streamz-rs/src/main.rs:750-835``) onto the device:

    embed (mean ReLU-h2, normalize)            src/main.rs:764-768
    → cosine match vs centroids                src/lib.rs:1499-1529
    → burn-in / labeled / new-class decision   src/main.rs:779-800
    → 5-epoch batch-8 training scan            src/main.rs:802-815
    → centroid running-mean update             src/main.rs:818-824

and then ``lax.scan``s that body over *files*: consecutive files whose padded
window counts share a bucket run as ONE dispatch (chunks of up to 64 files,
padded with inactive rows).  All decision state (``num_speakers``, centroid
sums/counts) lives on device, so nothing blocks until the single fetch at
the end.  Class growth is pure arithmetic on the device scalar: capacity is
pre-sized once (``SpeakerNet.ensure_capacity``), so no recompiles happen
mid-loop.

Semantics notes (vs the host formulation in app/incremental.py, which is
kept as the test oracle):

- The every-100-files centroid refresh (``src/main.rs:826-829``) is a no-op
  here by construction: centroids are exact running means of this run's
  embeddings at every step — precisely what the refresh recomputed.
- Matching uses the cosine against the *unnormalized* running sum — cosine
  is scale-invariant, so this equals the host's match against the
  normalized mean (``average_vectors``).
- Inactive padding rows train with ``n_valid = 0`` (no windows survive the
  mask → zero update, zero loss) and add zero to the centroids, so padding
  never perturbs state.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu import config
from streamz_tpu.infer.embed import average_vectors
from streamz_tpu.nn.drivers import _fresh_key
from streamz_tpu.nn.model import SpeakerNet, forward_embedding
from streamz_tpu.nn.train import train_on_windows_impl
from streamz_tpu.runtime.progress import progress

# Files per fused dispatch.  Consecutive files are chunked to power-of-two
# lengths up to this cap, bounding both the number of compiled variants (one
# per (window-bucket, chunk-length) pair) and the padding waste.
MAX_SCAN_FILES = 64

# A chunk pads every file to the chunk's max window bucket, so interleaved
# clip lengths still batch MAX_SCAN_FILES files per dispatch.  Safe because the per-file trainer is bit-identical across pad sizes
# (counter-based PRNG: uniform(key, (n,))[i] does not depend on n; stable
# argsort; all padding rows masked — verified in test_device_loop).  The
# spread cap bounds the padding FLOPs a small file can pay when chunked next
# to a long one; beyond it the chunk is flushed.
MAX_BUCKET_SPREAD = 4


def _prng_pad_invariant() -> bool:
    """Whether ``uniform(key, (n,))[i]`` is independent of ``n``.

    The pad-invariance claim above holds for the DEFAULT partitionable
    threefry PRNG only.  Under ``jax_threefry_partitionable=False`` (legacy
    threefry pairs counter ``i`` with ``i + n/2``) or a non-threefry default
    impl (``rbg``), draws depend on the padded length — so chunk-max padding
    and the sharded path's mesh-multiple padding would silently train
    differently from the per-file host oracle.  Callers fall back to
    exact-bucket grouping / the single-device scan in those configs.
    """
    try:
        if str(jax.config.jax_default_prng_impl) != "threefry2x32":
            return False
        return bool(jax.config.jax_threefry_partitionable)
    except AttributeError:
        return False  # unknown jax version: take the conservative path


def _file_body(
    carry, x, seed_cent, seed_mask, max_speakers, dropout, *, epochs,
    batch_size, axis=None, n_dev=1,
):
    """One file of the incremental loop; shapes are per-bucket static.

    With ``axis`` set (inside ``shard_map``) the window axis of the embed
    forward and of every per-chunk training gradient is computed by this
    device's slice and psum-merged — the mesh path of the discovery loop.
    All decision state stays replicated, so every device takes the same
    branch and labels match the single-device scan up to floating-point
    near-ties (the psum's reduction order differs from the single-device
    sum, so two centroids within ~1e-3 cosine of each other can argmax
    either way — the reference's rayon loop is nondeterministic there too).
    """
    params, num_speakers, run_sum, run_cnt = carry
    windows, n_valid, label, burn_phase, threshold, lr, key, active = x
    W = windows.shape[0]
    capacity = params["b3"].shape[0]
    is_active = active > 0
    n_valid = jnp.where(is_active, n_valid, 0)  # inactive rows: no-op train

    # --- clip embedding: masked mean ReLU-h2, L2-normalized ---------------
    if axis is None:
        e = forward_embedding(params, windows)  # [W, h2]
        valid = (jnp.arange(W) < n_valid).astype(jnp.float32)
        s = (e * valid[:, None]).sum(0)
    else:
        wl = W // n_dev  # W is padded to a mesh multiple by the caller
        d = jax.lax.axis_index(axis)
        w_local = jax.lax.dynamic_slice_in_dim(windows, d * wl, wl)
        e = forward_embedding(params, w_local)  # [wl, h2]
        valid = ((d * wl + jnp.arange(wl)) < n_valid).astype(jnp.float32)
        s = jax.lax.psum((e * valid[:, None]).sum(0), axis)
    s = s / jnp.maximum(n_valid.astype(jnp.float32), 1.0)
    norm = jnp.sqrt((s * s).sum())
    emb = jnp.where(norm > 1e-6, s / norm, s)

    # --- cosine match vs current centroids (src/lib.rs:1499-1529) ---------
    seen = run_cnt > 0
    cent = jnp.where(seen[:, None], run_sum, seed_cent)
    # Candidate set = EVERY centroid key — an explicitly-labeled file can
    # seed an id at or beyond the live class count, and the reference
    # argmaxes over the whole HashMap, checking range only AFTER the match
    # (src/main.rs:791-797).  Pre-masking out-of-range ids here diverged
    # from the host oracle on both the match and the <20 relaxation count.
    valid_id = seed_mask | seen
    ne = jnp.sqrt((emb * emb).sum())
    nc = jnp.sqrt((cent * cent).sum(axis=1))
    denom = ne * nc
    # Elementwise multiply-sum, not a dot: float32 on every backend (a GPU
    # dot would default to TF32, and the margins here are ~1e-3).
    dots = (cent * emb[None, :]).sum(axis=1)
    sims = jnp.where(denom > 0.0, dots / jnp.where(denom == 0.0, 1.0, denom), 0.0)
    sims = jnp.where(valid_id, sims, -jnp.inf)
    n_ids = valid_id.sum()
    best = jnp.argmax(sims).astype(jnp.int32)
    dyn = jnp.where(n_ids < 20, 0.7 * threshold, threshold)
    matched_ok = (n_ids > 0) & (sims[best] > dyn)
    in_range = best < num_speakers

    # --- label decision (src/main.rs:779-800 + --max-speakers doc) --------
    at_cap = num_speakers >= max_speakers
    is_labeled = label >= 0
    new_burn = burn_phase & (~is_labeled) & (~at_cap)
    unl = (~is_labeled) & (~new_burn)
    # A below-threshold OR out-of-range best spawns a new class
    # (src/main.rs:793-797); at cap, the best centroid wins outright —
    # range-unchecked, exactly like the host oracle's -2.0 re-identify.
    new_class = unl & (~(matched_ok & in_range)) & (~at_cap)
    best_forced = jnp.where(n_ids > 0, best, 0)
    sid = jnp.where(
        is_labeled,
        label,
        jnp.where(
            new_burn | new_class,
            num_speakers,
            jnp.where(matched_ok & in_range, best, best_forced),
        ),
    ).astype(jnp.int32)
    sid = jnp.where(is_active, sid, 0)
    grow = (new_burn | new_class) & is_active
    ns_new = num_speakers + grow.astype(jnp.int32)

    # --- train (pretrain_from_features semantics, src/main.rs:802-815) ----
    # _target_vec rule (src/lib.rs:592-594): one-hot only when the class is
    # in range — an out-of-range given label trains with a zero target.
    tvec = jax.nn.one_hot(sid, capacity, dtype=jnp.float32)
    tvec = tvec * (sid < ns_new).astype(jnp.float32)
    if axis is None:
        params, loss = train_on_windows_impl(
            params, windows, n_valid, tvec, ns_new, key, lr, dropout,
            epochs=epochs, batch_size=batch_size,
        )
    else:
        from streamz_tpu.nn.train import train_on_windows_sharded_impl

        params, loss = train_on_windows_sharded_impl(
            params, windows, n_valid, tvec, ns_new, key, lr, dropout,
            epochs=epochs, batch_size=batch_size, axis=axis, n_dev=n_dev,
        )

    # --- centroid updates (zero for inactive rows) -------------------------
    gain = is_active.astype(jnp.float32)
    run_sum = run_sum.at[sid].add(emb * gain)
    run_cnt = run_cnt.at[sid].add(gain)
    out_sid = jnp.where(is_active, sid, -1)
    return (params, ns_new, run_sum, run_cnt), (out_sid, loss, emb)


@partial(
    jax.jit,
    static_argnames=("epochs", "batch_size"),
    donate_argnums=(0, 1, 2, 3),
)
def incremental_scan(
    params,
    num_speakers,     # int32 scalar (device-resident class count)
    run_sum,          # [capacity, h2] running embedding sums per speaker
    run_cnt,          # [capacity] counts of embeddings accumulated this run
    seed_cent,        # [capacity, h2] centroids seeded from net.embeddings
    seed_mask,        # [capacity] bool: seed present
    max_speakers,     # int32 cap (2**30 when unbounded)
    dropout,          # f32 (loop constant)
    windows,          # [L, W_pad, F] padded windows, one row per file
    n_valids,         # [L] int32 true window counts
    labels,           # [L] int32 given labels, -1 if unlabeled
    burns,            # [L] bool burn-phase flags (host-known clock)
    thresholds,       # [L] f32 (0.5 during burn-in else --threshold)
    lrs,              # [L] f32 (host-known from the processed-file clock)
    keys,             # [L] PRNG keys
    actives,          # [L] int32: 0 = padding row, ignore
    *,
    epochs: int,
    batch_size: int,
):
    """Fused scan over up to MAX_SCAN_FILES files — one dispatch."""
    body = partial(
        _file_body,
        seed_cent=seed_cent,
        seed_mask=seed_mask,
        max_speakers=max_speakers,
        dropout=dropout,
        epochs=epochs,
        batch_size=batch_size,
    )
    carry = (params, num_speakers, run_sum, run_cnt)
    xs = (windows, n_valids, labels, burns, thresholds, lrs, keys, actives)
    (params, num_speakers, run_sum, run_cnt), (sids, losses, embs) = jax.lax.scan(
        body, carry, xs
    )
    return params, num_speakers, run_sum, run_cnt, sids, losses, embs


@lru_cache(maxsize=8)
def make_incremental_scan_sharded(mesh, epochs: int, batch_size: int):
    """The fused file scan SPMD over the data mesh.

    Every input is replicated (``P()``): decision state must be identical on
    all devices, and a file's window set is small enough (≤ a few MB) that
    replicating it costs less than the halo bookkeeping sharded storage
    would need.  What *is* sharded is the computation: each device runs the
    embed forward and every per-chunk training gradient on its
    ``1/n_dev`` slice of the window axis, merged with one psum each — the
    SPMD analogue of the reference's rayon fan-out #3 sharing one model
    (``streamz-rs/src/main.rs:750-835``).  Outputs (params, centroids,
    labels) stay replicated bit-identically on every device.

    Trade-off: per-chunk gradient psums put ~280 collectives on the
    critical path of a 448-window file (5 epochs x 56 chunks), so this wins
    only when per-device compute per chunk dominates the collective
    latency — which is why :func:`_resolve_scan_backend` measures it.
    """
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    def scan_fn(
        params, num_speakers, run_sum, run_cnt, seed_cent, seed_mask,
        max_speakers, dropout, windows, n_valids, labels, burns,
        thresholds, lrs, keys, actives,
    ):
        body = partial(
            _file_body,
            seed_cent=seed_cent,
            seed_mask=seed_mask,
            max_speakers=max_speakers,
            dropout=dropout,
            epochs=epochs,
            batch_size=batch_size,
            axis=axis,
            n_dev=n_dev,
        )
        carry = (params, num_speakers, run_sum, run_cnt)
        xs = (windows, n_valids, labels, burns, thresholds, lrs, keys, actives)
        (params, num_speakers, run_sum, run_cnt), (sids, losses, embs) = (
            jax.lax.scan(body, carry, xs)
        )
        return params, num_speakers, run_sum, run_cnt, sids, losses, embs

    n_in = 16
    return jax.jit(
        jax.shard_map(
            scan_fn,
            mesh=mesh,
            in_specs=(P(),) * n_in,
            out_specs=(P(),) * 7,
            check_vma=False,
        ),
        donate_argnums=(0, 1, 2, 3),
    )


def _resolve_scan_backend(
    mesh, epochs: int, batch_size: int, params, feat: int, w_pad: int,
) -> str:
    """Measured choice between the single-device and SPMD discovery scans.
    At the reference's batch-8 knobs the sharded scan's per-chunk
    collectives can cost more than they save; collective latency against
    per-chunk compute is a device and interconnect property, so it is
    measured.  Probes one synthetic 8-file chunk at this run's leading
    window bucket; cached per (device_kind, n_dev) via the autotune
    registry.  On the CPU (or multi-host, or with probing disabled) the
    default is 'sharded', which is what the CPU-mesh tests exercise.
    ``STREAMZ_SHARD_DISCOVERY`` still forces either path.
    """
    from streamz_tpu.runtime import autotune

    n_dev = int(mesh.devices.size)
    capacity = int(params["b3"].shape[0])
    h2 = int(params["w3"].shape[0])
    L = 8

    def make_probe(sharded: bool):
        def probe() -> float:
            wp = w_pad
            if sharded:
                while wp % n_dev:
                    wp += batch_size
            rng = np.random.default_rng(0)
            wins = jnp.asarray(
                rng.normal(0, 1, size=(L, wp, feat)).astype(np.float32))
            xs = (
                wins,
                jnp.full((L,), min(w_pad, wp), jnp.int32),   # n_valids
                jnp.full((L,), -1, jnp.int32),               # labels
                jnp.zeros((L,), bool),                       # burns
                jnp.full((L,), 0.8, jnp.float32),            # thresholds
                jnp.full((L,), 0.05, jnp.float32),           # lrs
                jax.vmap(lambda k: jax.random.fold_in(
                    jax.random.PRNGKey(0), k))(jnp.arange(L)),
                jnp.ones((L,), jnp.int32),                   # actives
            )
            seed_cent = jnp.zeros((capacity, h2), jnp.float32)
            seed_mask = jnp.zeros((capacity,), bool)
            # Commit the inputs to the candidate's placement OUTSIDE the
            # timed region.  The real loop replicates params to the mesh
            # once per run (donated outputs stay resident across chunks),
            # so paying host→mesh replication on every timed rep would
            # bias the cached choice toward 'single'; the per-rep
            # jnp.copy of an already-committed tree below is device-local
            # and placement-preserving for both candidates.
            from jax.sharding import NamedSharding, PartitionSpec as P

            if sharded:
                rep = NamedSharding(mesh, P())
                src = jax.device_put((params, xs, seed_cent, seed_mask), rep)
            else:
                src = jax.device_put(
                    (params, xs, seed_cent, seed_mask),
                    list(mesh.devices.flat)[0],
                )
            params_c, xs, seed_cent, seed_mask = src
            fn = (
                make_incremental_scan_sharded(
                    mesh, int(epochs), int(batch_size))
                if sharded else incremental_scan
            )

            def run():
                # Fresh state copies per call: the scans donate args 0-3.
                state = (
                    jax.tree.map(jnp.copy, params_c), jnp.int32(1),
                    jnp.zeros((capacity, h2), jnp.float32),
                    jnp.zeros((capacity,), jnp.float32),
                )
                kw = ({} if sharded else dict(
                    epochs=int(epochs), batch_size=int(batch_size),
                ))
                out = fn(
                    *state, seed_cent, seed_mask, jnp.int32(2**30),
                    jnp.float32(0.2), *xs, **kw,
                )
                float(np.asarray(out[5]).sum())  # block on the losses

            run()  # compile + warm
            return autotune.median_time(run, reps=3)

        return probe

    return autotune.measured_choice(
        f"discovery_scan_{n_dev}dev",
        {"single": make_probe(False), "sharded": make_probe(True)},
        default="sharded",
    )


def _pow2_chunks(n: int) -> List[int]:
    """Split n into chunk lengths: MAX_SCAN_FILES-sized chunks plus one
    power-of-two remainder (bounds compiled variants to log2 sizes)."""
    out = []
    while n >= MAX_SCAN_FILES:
        out.append(MAX_SCAN_FILES)
        n -= MAX_SCAN_FILES
    if n > 0:
        out.append(config.next_pow2(n))  # padded with inactive rows
    return out


def run_incremental_device(
    net: SpeakerNet,
    train_files: List[Tuple[str, Optional[int]]],
    feature_map: Dict[str, np.ndarray],
    *,
    burn_in_limit: int,
    conf_threshold: float,
    dropout: float,
    batch_size: int,
    epochs: int,
    max_speakers: Optional[int],
    show_progress: bool = True,
    mesh=None,
    device_store=None,
):
    """Chunk the file sequence, enqueue one fused scan per chunk, fetch all
    results once at the end.

    With ``device_store`` (the ingest stage's
    :class:`~streamz_tpu.dsp.mfcc.DeviceFeatureStore`) each chunk's window
    tensor is assembled ON the device from the frontend's outputs instead of
    re-uploading the host ``feature_map`` copies — bit-identical inputs
    (the store's padding frames are exact zeros), minus the dominant
    host→device transfer of every loop dispatch.  The store must have been
    built under this call's effective sharding (same mesh when the SPMD
    scan runs, no mesh otherwise) or it is ignored.

    With ``mesh`` (>1 device) the scan runs SPMD: each device computes its
    window-axis slice of the embed forward and of every training chunk's
    gradient (``make_incremental_scan_sharded``), so the discovery loop —
    the application's dominant phase — uses the whole mesh.  Labels match
    the single-device scan (``STREAMZ_SHARD_DISCOVERY=0`` forces the
    single-device path).

    Returns ``(total_loss, processed, speaker_features, speaker_embeddings)``
    and mutates ``net`` / the labels in ``train_files`` like the host loop.
    """
    import os

    n_dev = 0 if mesh is None else mesh.devices.size
    # The sharded scan pads the window axis to a mesh multiple, which is
    # only oracle-identical under a pad-invariant PRNG.  With the env knob
    # unset, the choice between the single-device and SPMD scans is
    # MEASURED on this device (see _resolve_scan_backend) — None here
    # defers the decision until the job shapes are known.
    _shard_env = os.environ.get("STREAMZ_SHARD_DISCOVERY")
    eligible = n_dev > 1 and _prng_pad_invariant()
    sharded: bool | None = (
        False if not eligible
        else (_shard_env != "0") if _shard_env is not None
        else None
    )
    jobs = []  # (orig_index, path, label, windows, n_valid, bucket)
    for i, (path, label) in enumerate(train_files):
        windows = feature_map.get(path)
        if windows is None:
            print(f"Missing audio for {path}")
            continue
        if len(windows) < 5:
            print(f"Skipping {path}, too short")
            continue
        windows = np.asarray(windows, np.float32)
        n_chunks = max(1, -(-len(windows) // batch_size))
        jobs.append((
            i, path, label, windows, len(windows),
            config.next_pow2(n_chunks) * batch_size,
        ))

    h2 = net.embedding_size()
    seed_embeddings = {
        i: np.asarray(mean, np.float32) for i, (mean, _, _) in enumerate(net.embeddings)
    }
    if not jobs:
        return 0.0, 0, {}, seed_embeddings

    # Pre-size capacity: every unlabeled file could spawn a class, and
    # explicit labels must be addressable.
    n_unlabeled = sum(1 for _, _, label, _, _, _ in jobs if label is None)
    max_label = max(
        (label for _, _, label, _, _, _ in jobs if label is not None), default=-1
    )
    needed = net.num_speakers + n_unlabeled
    max_sp = 2**30 if max_speakers is None else int(max_speakers)
    needed = min(needed, max(max_sp, net.num_speakers))
    needed = max(needed, max_label + 1)
    net.ensure_capacity(max(needed, 1))
    capacity = net.capacity

    seed_cent = np.zeros((capacity, h2), np.float32)
    seed_mask = np.zeros((capacity,), bool)
    for i, mean in seed_embeddings.items():
        if i < capacity:
            seed_cent[i] = mean
            seed_mask[i] = True
    seed_cent = jnp.asarray(seed_cent)
    seed_mask = jnp.asarray(seed_mask)

    # Work on a device copy: the scan donates its params input (argnum 0),
    # and donating the arrays net.params still references would leave the
    # caller's net pointing at deleted buffers if a later chunk dispatch
    # fails — net.params is only reassigned after ALL chunks complete.
    params = jax.tree.map(jnp.copy, net.params)
    ns = jnp.int32(net.num_speakers)
    run_sum = jnp.zeros((capacity, h2), jnp.float32)
    run_cnt = jnp.zeros((capacity,), jnp.float32)
    N = len(jobs)
    base_key = _fresh_key()
    all_keys = jax.vmap(lambda k: jax.random.fold_in(base_key, k))(jnp.arange(N))

    # Chunk consecutive files greedily; every file in a chunk is padded to
    # the chunk's max window bucket, so interleaved clip lengths still batch
    # MAX_SCAN_FILES files per dispatch.  A new chunk starts only at the file
    # cap or when the bucket spread would exceed MAX_BUCKET_SPREAD (bounding
    # the padding FLOPs short files pay next to long ones).
    runs: List[List[int]] = []  # lists of job indices
    # spread 1 = only equal buckets share a chunk: required when the PRNG
    # makes draws depend on the padded length (see _prng_pad_invariant).
    spread = MAX_BUCKET_SPREAD if _prng_pad_invariant() else 1
    for k in range(N):
        b = jobs[k][5]
        if runs:
            bmin = min(jobs[j][5] for j in runs[-1])
            bmax = max(jobs[j][5] for j in runs[-1])
            if (
                len(runs[-1]) < MAX_SCAN_FILES
                and max(bmax, b) <= spread * min(bmin, b)
            ):
                runs[-1].append(k)
                continue
        runs.append([k])

    chunks: List[Tuple[List[int], int]] = []  # (job indices, padded length)
    for run in runs:
        pos = 0
        for clen in _pow2_chunks(len(run)):
            chunks.append((run[pos: pos + min(clen, len(run) - pos)], clen))
            pos += clen

    if sharded is None:
        # Measured choice (env knob unset): probe both scans at this run's
        # leading bucket shape; autotune caches the winner per device kind.
        sharded = _resolve_scan_backend(
            mesh, int(epochs), int(batch_size), params,
            int(jobs[0][3].shape[1]), int(jobs[0][5]),
        ) == "sharded"

    scan_sharded = (
        make_incremental_scan_sharded(mesh, int(epochs), int(batch_size))
        if sharded
        else None
    )
    # The ingest store is usable only when it was built under the same
    # sharding this loop will trace with: a mesh-sharded bucket fed to the
    # single-device scan (or vice versa) would mix committed device sets.
    store = device_store
    if store is not None:
        store_ok = (
            # Equality, not identity: current jax interns Mesh (equal
            # meshes ARE one object) but that is an implementation detail
            # — an equal-but-distinct Mesh must not silently drop the
            # store and forfeit its device-resident input.
            (sharded and store.mesh == mesh)
            or (not sharded and store.mesh is None)
        )
        if not store_ok:
            # Built under a different sharding than this loop traces with
            # (e.g. a mesh-built store when STREAMZ_SHARD_DISCOVERY=0 keeps
            # the loop single-device): dropping it is the only safe move,
            # but say so — the user would otherwise see the documented
            # device-resident speedup silently vanish.
            import sys

            print(
                "discovery loop: ingest feature store built under a "
                "different sharding; falling back to host-packed chunks",
                file=sys.stderr,
            )
            store = None
    out_parts = []  # (job_ks, sids_dev, losses_dev, embs_dev, n_real)
    for job_ks, L in progress(chunks, desc="incremental", enabled=show_progress):
        w_pad = max(jobs[k][5] for k in job_ks)
        if sharded:
            # The sharded embed slices the window axis evenly across devices;
            # extra padding is free (the trainer is pad-invariant).
            while w_pad % n_dev:
                w_pad += batch_size
        feat = jobs[job_ks[0]][3].shape[1]
        n_real = len(job_ks)
        # Device-side gather from the ingest store — no host→device feature
        # re-upload.  Misses (e.g. the PCM-sharded long-clip route, or a
        # bucket dropped by STREAMZ_STORE_MAX_MB) are host-packed and
        # scattered INDIVIDUALLY — one missed clip does not forfeit device
        # residency for its whole chunk.  With a mesh the
        # gather is replicated (the SPMD scan's in_spec).
        wins_dev, misses = (
            store.gather_partial(
                [jobs[k][1] for k in job_ks], w_pad,
                mesh=mesh if sharded else None, n_rows=L,
            )
            if store is not None
            else (None, None)
        )
        wins = np.zeros((L, w_pad, feat), np.float32) if wins_dev is None else None
        n_valids = np.zeros((L,), np.int32)
        labels_a = np.full((L,), -1, np.int32)
        burns = np.zeros((L,), bool)
        thrs = np.zeros((L,), np.float32)
        lrs = np.zeros((L,), np.float32)
        actives = np.zeros((L,), np.int32)
        key_rows = np.zeros((L,), np.int32)
        for row, k in enumerate(job_ks):
            _, _, label, windows, n_valid, _ = jobs[k]
            if wins is not None:
                wins[row, :n_valid] = windows
            n_valids[row] = n_valid
            labels_a[row] = -1 if label is None else int(label)
            burn = k < burn_in_limit
            burns[row] = burn
            thrs[row] = 0.5 if burn else conf_threshold
            lrs[row] = (
                config.LR_EARLY if k < config.LR_SWITCH_COUNT else config.LR_LATE
            )
            actives[row] = 1
            key_rows[row] = k
        keys = all_keys[jnp.asarray(key_rows)]

        if wins_dev is not None and misses:
            # Repair the missed rows only: host-pack [n_miss, w_pad, feat]
            # and scatter into the gathered tensor (bit-identical to a full
            # host pack — hit rows are the frontend's own device outputs).
            miss_rows = [r for r, _ in misses]
            pack = np.zeros((len(miss_rows), w_pad, feat), np.float32)
            for j, r in enumerate(miss_rows):
                _, _, _, windows, n_valid, _ = jobs[job_ks[r]]
                pack[j, :n_valid] = windows
            wins_dev = store.scatter_rows(
                wins_dev, pack, miss_rows, mesh=mesh if sharded else None
            )
        wins_in = wins_dev if wins_dev is not None else jnp.asarray(wins)
        if sharded:
            (params, ns, run_sum, run_cnt, sids, losses, embs) = scan_sharded(
                params, ns, run_sum, run_cnt, seed_cent, seed_mask,
                jnp.int32(max_sp), jnp.float32(dropout),
                wins_in, jnp.asarray(n_valids),
                jnp.asarray(labels_a), jnp.asarray(burns), jnp.asarray(thrs),
                jnp.asarray(lrs), keys, jnp.asarray(actives),
            )
        else:
            (params, ns, run_sum, run_cnt, sids, losses, embs) = incremental_scan(
                params, ns, run_sum, run_cnt, seed_cent, seed_mask,
                jnp.int32(max_sp), jnp.float32(dropout),
                wins_in, jnp.asarray(n_valids), jnp.asarray(labels_a),
                jnp.asarray(burns), jnp.asarray(thrs), jnp.asarray(lrs),
                keys, jnp.asarray(actives),
                epochs=int(epochs), batch_size=int(batch_size),
            )
        out_parts.append((job_ks, sids, losses, embs, n_real))

    # Single synchronization point: fetch everything at once.
    net.params = params
    net.num_speakers = int(np.asarray(ns))
    while len(net.file_lists) < net.num_speakers:
        net.file_lists.append([])

    total_loss = 0.0
    speaker_features: Dict[int, List[np.ndarray]] = {}
    for job_ks, sids, losses, embs, n_real in out_parts:
        sids = np.asarray(sids)[:n_real]
        losses = np.asarray(losses)[:n_real]
        embs = np.asarray(embs)[:n_real]
        total_loss += float(losses.sum())
        for row, k in enumerate(job_ks):
            i, path, _, _, _, _ = jobs[k]
            sid = int(sids[row])
            train_files[i] = (path, sid)
            net.record_training_file(sid, path)
            speaker_features.setdefault(sid, []).append(embs[row])

    speaker_embeddings = dict(seed_embeddings)
    for sid, feats in speaker_features.items():
        speaker_embeddings[sid] = average_vectors(feats)

    return total_loss, N, speaker_features, speaker_embeddings
