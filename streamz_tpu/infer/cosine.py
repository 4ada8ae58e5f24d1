"""Cosine-similarity centroid matching with the reference's gating rules.

- ``cosine_similarity`` (``streamz-rs/src/lib.rs:1532-1541``): zero when
  either norm is exactly zero.
- ``identify_speaker_from_embedding`` (``src/lib.rs:1499-1529``): best
  centroid by cosine; the threshold relaxes to ``0.7 * threshold`` when fewer
  than 20 speakers exist; no match → ``None`` (the reference's ``usize::MAX``
  "new speaker" sentinel).
- ``identify_speaker_cosine(_feats)`` (``src/lib.rs:1604-1661``): adaptive
  per-speaker gate — reject ``sim < mean_sim - 2*std_sim``; accept when
  ``sim > 0.35`` and (``sim > mean_sim + std_sim*f`` or ``sim > 0.5``) with
  ``f = 0.3`` under 200 speakers else 1.0; winner must also beat the caller's
  threshold (``best_val`` starts at ``threshold``).
- ``compute_speaker_embeddings`` (``src/lib.rs:1555-1599``): per-speaker
  centroid = normalized mean of per-file median embeddings (from the feature
  cache), plus mean/std of the cosine similarities to the centroid.

The batched comparisons run as one [n x dim] @ [dim] device matvec.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from streamz_tpu.infer.embed import (
    extract_embedding,
    extract_embedding_from_features,
    median_embedding_from_features,
    normalize,
)
from streamz_tpu.nn.model import SpeakerNet

SpeakerStats = Tuple[np.ndarray, float, float]  # (mean, mean_sim, std_sim)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    na = float(np.sqrt((a * a).sum()))
    nb = float(np.sqrt((b * b).sum()))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(a @ b) / (na * nb)


def _cosine_matrix(emb: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Cosine of one embedding vs many centroids, zero-norm safe. [n]"""
    # One definition of the zero-norm guard: delegate to the batch twin.
    return cosine_matrix_many(np.asarray(emb, np.float32)[None, :], centroids)[0]


def cosine_matrix_many(embs: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Cosine of many embeddings vs many centroids, zero-norm safe. [n, s]

    One GEMM instead of a per-(file, centroid) Python loop — the eval path
    stays linear-time at the 1000-speaker stretch config.
    """
    embs = np.asarray(embs, np.float32)
    centroids = np.asarray(centroids, np.float32)
    ne = np.sqrt((embs * embs).sum(axis=1))          # [n]
    nc = np.sqrt((centroids * centroids).sum(axis=1))  # [s]
    dots = embs @ centroids.T                        # [n, s]
    denom = ne[:, None] * nc[None, :]
    return np.where(denom > 0.0, dots / np.where(denom == 0.0, 1.0, denom), 0.0)


def identify_speaker_from_embedding(
    emb: np.ndarray,
    speaker_embeddings: Dict[int, np.ndarray],
    threshold: float,
) -> Optional[int]:
    """Best-centroid match with the <20-speaker relaxation (src/lib.rs:1499-1529).

    Returns the speaker id, or ``None`` for "create a new speaker".
    """
    if not speaker_embeddings:
        return None
    ids = list(speaker_embeddings.keys())
    centroids = np.stack([np.asarray(speaker_embeddings[i], np.float32) for i in ids])
    sims = _cosine_matrix(emb, centroids)
    best = int(np.argmax(sims))
    dynamic_threshold = threshold * 0.7 if len(ids) < 20 else threshold
    if float(sims[best]) > dynamic_threshold:
        return ids[best]
    return None


def _adaptive_match(
    emb: np.ndarray,
    speaker_embeds: Sequence[SpeakerStats],
    threshold: float,
) -> Optional[int]:
    """Shared adaptive gate of identify_speaker_cosine(_feats)."""
    if not speaker_embeds:
        return None
    centroids = np.stack([np.asarray(m, np.float32) for m, _, _ in speaker_embeds])
    sims = _cosine_matrix(emb, centroids)
    return identify_sims_cosine(sims, speaker_embeds, threshold)


def identify_sims_cosine(
    sims: np.ndarray,
    speaker_embeds: Sequence[SpeakerStats],
    threshold: float,
) -> Optional[int]:
    """The adaptive gate on a precomputed ``[n_speakers]`` cosine row.

    Factored out so callers that already hold a batched similarity matrix
    (one ``cosine_matrix_many`` GEMM over many clips — ``--eval``-style,
    and the CLI's ``--identify``) gate each row without recomputing the
    per-clip cosines.
    """
    if not speaker_embeds:
        return None
    sims = np.asarray(sims, np.float32)
    mean_sims = np.array([m for _, m, _ in speaker_embeds], np.float32)
    std_sims = np.array([s for _, _, s in speaker_embeds], np.float32)

    factor = 0.3 if len(speaker_embeds) < 200 else 1.0
    not_rejected = sims >= (mean_sims - 2.0 * std_sims)
    dynamic = mean_sims + std_sims * factor
    accepted = (sims > 0.35) & ((sims > dynamic) | (sims > 0.5)) & not_rejected

    # Vectorized argmax with the loop's exact semantics: float64 compare
    # against the threshold (the loop upcast each sim via float()), strict
    # greater-than, first index wins ties.  A 1000-speaker corpus gated
    # thousands of clips through a Python loop here after the sims were
    # already one GEMM.
    cand = np.flatnonzero(accepted & (sims.astype(np.float64) > threshold))
    if cand.size == 0:
        return None
    return int(cand[np.argmax(sims[cand])])


def identify_embedding_cosine(
    emb: np.ndarray,
    speaker_embeds: Sequence[SpeakerStats],
    threshold: float,
) -> Optional[int]:
    """Adaptive-gate match on a precomputed clip embedding.

    The same gate as :func:`identify_speaker_cosine(_feats)` factored to the
    embedding level, so batched embedding producers
    (:func:`streamz_tpu.infer.embed.batch_clip_embeddings`) can share one
    device program across clips and gate each result on the host — used by
    the CLI's ``--identify`` mode.  Cosine is scale-invariant, so ``emb``
    need not be pre-normalized.
    """
    if not speaker_embeds:
        return None
    return _adaptive_match(np.asarray(emb, np.float32), speaker_embeds, threshold)


def identify_speaker_cosine(
    net: SpeakerNet,
    speaker_embeds: Sequence[SpeakerStats],
    sample,
    threshold: float,
    extractor=None,
) -> Optional[int]:
    """Adaptive-gate match on raw PCM (src/lib.rs:1604-1631)."""
    if not speaker_embeds:
        return None
    emb = extract_embedding(net, sample, extractor)
    return _adaptive_match(emb, speaker_embeds, threshold)


def identify_speaker_cosine_feats(
    net: SpeakerNet,
    speaker_embeds: Sequence[SpeakerStats],
    windows: np.ndarray,
    threshold: float,
) -> Optional[int]:
    """Adaptive-gate match on precomputed windows (src/lib.rs:1634-1661)."""
    if not speaker_embeds:
        return None
    # extract_embedding_from_features already L2-normalizes; a second
    # normalize only perturbed LSBs for nothing.
    emb = extract_embedding_from_features(net, windows)
    return _adaptive_match(emb, speaker_embeds, threshold)


def compute_speaker_embeddings(
    net: SpeakerNet, extractor=None, mesh=None, feature_map=None, store=None
) -> Optional[List[SpeakerStats]]:
    """Per-speaker (mean, mean_sim, std_sim) from the feature cache
    (src/lib.rs:1555-1599).  With ``mesh`` the pooled embedding batches are
    sharded across the data mesh.

    ``feature_map`` (this run's in-memory path→windows map) short-circuits
    the compute-on-cache-miss path: an EXISTING cache file still wins (the
    reference's load-or-compute contract — on-disk content is
    authoritative), but a missing one takes the map's windows and publishes
    them to the cache instead of re-ingesting the file one clip at a time —
    on a fresh corpus the reference pays its whole L0+L1 pipeline per file
    again here (``src/lib.rs:1569`` → ``:558-579``), and a device pays a
    per-file dispatch.  (Published bytes come from *batched*
    extraction; a later cache-miss recompute is single-clip — the two agree
    to ~1e-5, inside the 1e-3 parity gate but not bit-identical: QUIRKS.md.)  ``store`` (the ingest stage's
    :class:`~streamz_tpu.dsp.mfcc.DeviceFeatureStore`) additionally lets
    those map-sourced batches gather device-resident rows, skipping the
    host→device re-upload; cache-sourced files host-pack as before.
    """
    from streamz_tpu.dsp.features import (
        load_cached_features,
        save_cached_features,
    )
    from streamz_tpu.infer.embed import batch_median_embeddings
    from streamz_tpu.io import audio

    # Gather every file's cached windows first, then pool all embeddings in
    # bucketed batched device calls (one dispatch per bucket, not per file).
    per_speaker_wins: List[List[np.ndarray]] = []
    flat_wins: List[np.ndarray] = []
    flat_keys: List[object] = []  # store keys; cache-sourced rows must miss
    # One stats entry per LIVE class, always: a net whose file_lists lags
    # num_speakers (grown without recorded files) gets zero-centroid stats
    # for the tail instead of silently dropping those speakers from the
    # saved embeddings.
    file_lists: List[List[str]] = list(net.file_lists[: net.output_size()])
    file_lists += [[] for _ in range(net.output_size() - len(file_lists))]
    for files in file_lists:
        wins_list: List[np.ndarray] = []
        for path in files:
            from_map = (
                feature_map is not None
                and feature_map.get(path) is not None
                and not audio.feature_cache_path(path).exists()
            )
            if from_map:
                wins = feature_map[path]
                try:
                    save_cached_features(path, wins)
                except Exception:
                    pass  # cache publish is best-effort; windows are in hand
            else:
                try:
                    wins = load_cached_features(path, extractor)
                except Exception:
                    continue
            wins_list.append(wins)
            flat_keys.append(path if from_map else object())
        per_speaker_wins.append(wins_list)
        flat_wins.extend(wins_list)

    flat_embeds = batch_median_embeddings(
        net, flat_wins, mesh=mesh, store=store, keys=flat_keys
    )
    it = iter(flat_embeds)

    out: List[SpeakerStats] = []
    for wins_list in per_speaker_wins:
        # batch_median_embeddings' contract already L2-normalizes each row.
        embeds = [next(it) for _ in wins_list]
        if not embeds:
            out.append((np.zeros((net.embedding_size(),), np.float32), 0.0, 0.0))
            continue
        mean = normalize(np.mean(embeds, axis=0))
        # One [n_files x 1] GEMM instead of a per-file Python dot loop.
        sims = cosine_matrix_many(np.stack(embeds), mean[None, :])[:, 0]
        mean_sim = float(sims.mean())
        std_sim = float(np.sqrt(((sims - mean_sim) ** 2).mean()))
        out.append((mean, mean_sim, std_sim))
    return out
