"""Clip-level embedding extraction (median/mean pooled, L2-normalized).

Preserves the reference's *intentional* asymmetries between call sites
(SURVEY.md "quirks"): ``extract_embedding`` pools the tanh-h2 head with a
per-dimension median (``streamz-rs/src/lib.rs:1418-1447``) while
``extract_embedding_from_features`` pools the ReLU-h2 head with a mean
(``src/lib.rs:1450-1471``) and ``median_embedding_from_features`` pools the
ReLU-h2 head with a median (``src/lib.rs:1474-1495``).  All pooling runs
vmapped on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu import config
from streamz_tpu.nn.model import SpeakerNet, embed as embed_fn, forward_embedding


def normalize(v: np.ndarray) -> np.ndarray:
    """L2-normalize when the norm exceeds 1e-6 (src/lib.rs:132-139)."""
    v = np.asarray(v, np.float32)
    norm = float(np.sqrt((v * v).sum()))
    if norm > 1e-6:
        return v / norm
    return v.copy()


def average_vectors(vectors) -> np.ndarray:
    """Mean of vectors, L2-normalized (src/lib.rs:144-159)."""
    vectors = [np.asarray(v, np.float32) for v in vectors]
    if not vectors:
        return np.zeros((0,), np.float32)
    return normalize(np.mean(vectors, axis=0))


average_features = average_vectors  # src/lib.rs:162-164


@jax.jit
def _embed_median(params, windows):
    e = embed_fn(params, windows)  # tanh head
    return jnp.median(e, axis=0)


@jax.jit
def _fembed_mean(params, windows):
    e = forward_embedding(params, windows)  # relu head
    return e.mean(axis=0)


@jax.jit
def _fembed_median(params, windows):
    e = forward_embedding(params, windows)
    return jnp.median(e, axis=0)


@jax.jit
def _fembed_mean_batch(params, windows, n_valid):
    """Masked mean ReLU-h2 embeddings for padded clips.

    windows: [B, W_pad, F]; n_valid: [B] → [B, h2].
    """
    e = forward_embedding(params, windows)  # [B, W, h2]
    mask = (jnp.arange(windows.shape[1])[None, :] < n_valid[:, None])
    e = e * mask[..., None]
    return e.sum(axis=1) / jnp.maximum(n_valid[:, None], 1.0)


def _put_bucket(batch, lens, mesh):
    """Device-put one bucket, clip axis sharded when a mesh is given."""
    if mesh is not None:
        from streamz_tpu.parallel.mesh import pad_rows_to_mesh, put_batch_sharded

        _, (batch_p, lens_p) = pad_rows_to_mesh(mesh, batch, lens)
        return put_batch_sharded(mesh, batch_p, lens_p)
    return jnp.asarray(batch), jnp.asarray(lens)


def _batch_pooled(net: SpeakerNet, clips, mesh, kernel, store=None, keys=None) -> list:
    """Shared scaffold of the batched pooled-embedding paths.

    Buckets clips by power-of-two window count, pads each bucket, runs the
    jitted masked pooling ``kernel`` (mean or exact-median) once per bucket
    (clip axis sharded when ``mesh`` is given), and L2-normalizes — one
    device dispatch per bucket instead of per clip.

    With ``store``/``keys`` (the ingest stage's
    :class:`~streamz_tpu.dsp.mfcc.DeviceFeatureStore`; ``keys[i]`` is clip
    ``i``'s store key) each bucket whose clips all hit the store is
    assembled by device-side gather — no host→device feature re-upload.
    The gathered rows are bit-identical to host zero-packing, so the
    embeddings are unchanged.  A bucket with any miss host-packs as before.
    The store must have been built under this call's sharding (same mesh
    or both None) or it is ignored.
    """
    if not clips:
        return []
    if store is not None and keys is not None:
        store_ok = (
            (mesh is None and store.mesh is None)
            # equality, not identity (see device_loop's twin check)
            or (mesh is not None and store.mesh == mesh)
        )
        if not store_ok:
            store = None
    arrs = [np.asarray(c, np.float32) for c in clips]
    out = [None] * len(arrs)
    buckets: dict = {}
    feat = next((a.shape[1] for a in arrs if a.ndim == 2 and len(a)), None)
    for i, a in enumerate(arrs):
        if len(a) == 0:
            out[i] = np.zeros((net.embedding_size(),), np.float32)
            continue
        buckets.setdefault(config.next_pow2(len(a)), []).append(i)
    from streamz_tpu.parallel.mesh import (
        fetch,
        pad_rows_to_mesh,
        put_batch_sharded,
    )

    for n_pad, idxs in buckets.items():
        lens = np.asarray([len(arrs[i]) for i in idxs], np.int32)
        # Pad the CLIP axis to a power of two as well (n_valid = 0 rows
        # are masked no-ops in both pooling kernels): the window axis was
        # already bucketed, but a raw B = len(idxs) retraces and
        # recompiles the kernel for every distinct clip count — seconds
        # of compile per discovery round as the corpus grows, against the
        # repo's static-shape rule.
        B = len(idxs)
        B_pad = config.next_pow2(B)
        if B_pad > B:
            lens = np.concatenate([lens, np.zeros(B_pad - B, np.int32)])
        batch_d = lens_d = None
        if store is not None and keys is not None:
            bucket_keys = [keys[i] for i in idxs]
            if mesh is not None:
                _, (lens_p,) = pad_rows_to_mesh(mesh, lens)
                batch_d, misses = store.gather_partial(
                    bucket_keys, n_pad, mesh=mesh, rows_sharded=True,
                    n_rows=len(lens_p),
                )
                if batch_d is not None:
                    (lens_d,) = put_batch_sharded(mesh, lens_p)
            else:
                batch_d, misses = store.gather_partial(
                    bucket_keys, n_pad, n_rows=B_pad,
                )
                if batch_d is not None:
                    lens_d = jnp.asarray(lens)
            if batch_d is not None and misses:
                # Host-pack ONLY the missed clips and scatter them in —
                # the rest of the bucket keeps device residency
                # (bit-identical to a full host pack).
                miss_rows = [r for r, _ in misses]
                pack = np.zeros((len(miss_rows), n_pad, feat), np.float32)
                for j, r in enumerate(miss_rows):
                    a = arrs[idxs[r]]
                    pack[j, : len(a)] = a
                batch_d = store.scatter_rows(
                    batch_d, pack, miss_rows, mesh=mesh,
                    rows_sharded=mesh is not None,
                )
        if batch_d is None:
            batch = np.zeros((len(lens), n_pad, feat), np.float32)
            for row, i in enumerate(idxs):
                batch[row, : len(arrs[i])] = arrs[i]
            batch_d, lens_d = _put_bucket(batch, lens, mesh)
        embs = fetch(kernel(net.params, batch_d, lens_d))
        for row, i in enumerate(idxs):
            out[i] = normalize(embs[row])
    return out


def batch_clip_embeddings(net: SpeakerNet, clips, mesh=None, store=None, keys=None) -> list:
    """Mean-pooled ReLU-h2 embeddings for many clips in few device calls.

    Equivalent to calling :func:`extract_embedding_from_features` per clip
    (same normalization contract) but batched with window-count bucketing —
    one device dispatch per bucket instead of per clip.  With ``mesh`` the
    clip axis is sharded across the data mesh (SPMD via pjit).  With
    ``store``/``keys`` the buckets gather device-resident ingest features
    instead of re-uploading (see :func:`_batch_pooled`); only safe when
    ``clips[i]`` IS the ingest output for ``keys[i]`` (e.g. the CLI's
    ``feature_map`` in the same run) — the disk feature-cache contract may
    legitimately differ, so cache-fed callers must not pass a store.
    """
    return _batch_pooled(net, clips, mesh, _fembed_mean_batch, store, keys)


@jax.jit
def _fembed_median_batch(params, windows, n_valid):
    """Masked median ReLU-h2 embeddings for padded clips.

    The per-clip median over a ragged window set is computed exactly by
    pushing padding rows to +inf in the sort and reading the two middle
    order statistics of the true count (the reference's even/odd midpoint
    rule, src/lib.rs:1483-1492).
    windows: [B, W_pad, F]; n_valid: [B] → [B, h2].
    """
    e = forward_embedding(params, windows)  # [B, W, h2]
    W = windows.shape[1]
    mask = (jnp.arange(W)[None, :] < n_valid[:, None])[..., None]
    big = jnp.where(mask, e, jnp.inf)
    s = jnp.sort(big, axis=1)  # valid values first, inf padding last
    n = jnp.maximum(n_valid, 1)
    lo_i = ((n - 1) // 2)[:, None, None]
    hi_i = (n // 2)[:, None, None]
    lo = jnp.take_along_axis(s, jnp.broadcast_to(lo_i, (s.shape[0], 1, s.shape[2])), axis=1)
    hi = jnp.take_along_axis(s, jnp.broadcast_to(hi_i, (s.shape[0], 1, s.shape[2])), axis=1)
    return ((lo + hi) / 2.0)[:, 0, :]


def batch_median_embeddings(net: SpeakerNet, clips, mesh=None, store=None, keys=None) -> list:
    """Median-pooled ReLU-h2 embeddings for many clips, bucketed+batched.

    Equivalent to :func:`median_embedding_from_features` per clip (including
    the even-count midpoint rule, src/lib.rs:1483-1492), L2-normalized.
    With ``mesh`` the clip axis is sharded across the data mesh.  For
    ``store``/``keys`` see :func:`batch_clip_embeddings` — same contract
    (and the same caveat: only keys whose clip IS the ingest output may be
    store keys; cache-sourced clips must carry a missing key).
    """
    return _batch_pooled(net, clips, mesh, _fembed_median_batch, store, keys)


def extract_embedding(net: SpeakerNet, sample, extractor=None) -> np.ndarray:
    """Median-pooled tanh-h2 embedding of raw PCM (src/lib.rs:1418-1447)."""
    from streamz_tpu.dsp.features import FeatureExtractor

    extractor = extractor or FeatureExtractor()
    windows = extractor.extract(np.asarray(sample))
    if len(windows) == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    emb = np.asarray(_embed_median(net.params, jnp.asarray(windows)))
    return normalize(emb)


def extract_embedding_from_features(net: SpeakerNet, feats: np.ndarray) -> np.ndarray:
    """Mean-pooled ReLU-h2 embedding (src/lib.rs:1450-1471).

    This is the variant the incremental loop and ``--eval`` use.
    """
    feats = np.asarray(feats, np.float32)
    if len(feats) == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    emb = np.asarray(_fembed_mean(net.params, jnp.asarray(feats)))
    return normalize(emb)


def median_embedding_from_features(net: SpeakerNet, feats: np.ndarray) -> np.ndarray:
    """Median-pooled ReLU-h2 embedding (src/lib.rs:1474-1495)."""
    feats = np.asarray(feats, np.float32)
    if len(feats) == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    emb = np.asarray(_fembed_median(net.params, jnp.asarray(feats)))
    return normalize(emb)
