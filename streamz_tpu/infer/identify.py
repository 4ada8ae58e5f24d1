"""On-device speaker identification: window voting and thresholds.

Device-batched rebuilds of the reference's L4 identifiers — each is a single
vmapped forward + reduction instead of the per-window scalar loop:

- ``identify_speaker``: sum softmax over windows → argmax
  (``streamz-rs/src/lib.rs:1285-1303``)
- ``identify_speaker_with_threshold(_feats)``: confidence = best_sum/count,
  ``None`` below threshold or when ``output_size <= 1``
  (``src/lib.rs:1307-1377``)
- ``identify_speaker_list``: per-window argmax votes with a per-window
  probability gate, sorted by descending count (``src/lib.rs:1383-1411``)
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu.nn.model import SpeakerNet, forward


@jax.jit
def _prob_sums(params, windows, num_speakers):
    probs = forward(params, windows, num_speakers)  # [W, capacity]
    return probs.sum(axis=0), probs


def _windows_of(sample, extractor):
    from streamz_tpu.dsp.features import FeatureExtractor

    extractor = extractor or FeatureExtractor()
    return extractor.extract(np.asarray(sample))


def _long_mesh(mesh, n_windows: int) -> bool:
    from streamz_tpu.parallel.window_parallel import LONG_CLIP_WINDOW_THRESHOLD

    return (
        mesh is not None
        and mesh.devices.size > 1
        and n_windows >= LONG_CLIP_WINDOW_THRESHOLD
    )


def _default_frontend(extractor) -> bool:
    """True when the fused PCM-sharded fast path (which computes features
    with the XLA formulation) is faithful to the caller's extractor choice.
    A duck-typed extractor WITHOUT a ``backend`` attribute must disable the
    bypass — defaulting the missing attribute to 'auto' would silently
    compute default MFCCs instead of whatever the caller's object does."""
    return extractor is None or getattr(extractor, "backend", None) == "auto"


def identify_speaker(
    net: SpeakerNet, sample, extractor=None, mesh=None
) -> int:
    """Argmax of summed window softmax (src/lib.rs:1285-1303).

    With ``mesh``, a long clip runs as ONE fused SPMD program — PCM-sharded
    frontend → forward → psum vote sums across the mesh
    (:func:`streamz_tpu.parallel.window_parallel.identify_speaker_pcm_sharded`).
    """
    if not net.num_speakers:
        return 0  # skip the device dispatch the result would ignore
    sample = np.asarray(sample)
    from streamz_tpu.dsp.mfcc import window_count_host

    n_win = window_count_host(len(sample))
    if _long_mesh(mesh, n_win) and net.num_speakers and _default_frontend(extractor):
        from streamz_tpu.parallel.window_parallel import identify_speaker_pcm_sharded

        return identify_speaker_pcm_sharded(net, sample, mesh)
    windows = _windows_of(sample, extractor)
    if len(windows) == 0:
        return 0
    sums, _ = _prob_sums(net.params, jnp.asarray(windows), net.num_speakers)
    return int(np.asarray(sums)[: net.num_speakers].argmax()) if net.num_speakers else 0


def identify_speaker_with_threshold_feats(
    net: SpeakerNet, windows: np.ndarray, threshold: float, mesh=None
) -> Optional[int]:
    """Thresholded voting on precomputed windows (src/lib.rs:1346-1377).

    With ``mesh``, a long window set (cached-feature path) shards its window
    axis across the mesh and psums the vote sums (the CP analogue)."""
    if net.output_size() <= 1:
        return None  # single-speaker nets always answer "unknown" (:1316-1318)
    windows = np.asarray(windows, np.float32)
    if windows.ndim == 1:
        # a bare [F] vector is ONE window — matching the sharded twin's
        # _pad_to_mesh; left 1-D it would reach _prob_sums as [F] and die
        # on a 0-d slice.
        windows = windows.reshape(1, -1)
    if len(windows) == 0:
        return None
    if _long_mesh(mesh, len(windows)):
        from streamz_tpu.parallel.window_parallel import vote_sums_sharded

        sums = vote_sums_sharded(net, windows, mesh)
    else:
        sums, _ = _prob_sums(net.params, jnp.asarray(windows), net.num_speakers)
        sums = np.asarray(sums)[: net.num_speakers]
    best_idx = int(sums.argmax())
    confidence = float(sums[best_idx]) / len(windows)
    return best_idx if confidence >= threshold else None


def identify_speaker_with_threshold(
    net: SpeakerNet, sample, threshold: float, extractor=None, mesh=None
) -> Optional[int]:
    """Thresholded voting on raw PCM (src/lib.rs:1307-1343)."""
    if net.output_size() <= 1:
        return None
    windows = _windows_of(sample, extractor)
    return identify_speaker_with_threshold_feats(net, windows, threshold, mesh=mesh)


def identify_speaker_list(
    net: SpeakerNet, sample, threshold: float, extractor=None
) -> List[int]:
    """All speakers present, by per-window votes (src/lib.rs:1383-1411).

    A window votes for its argmax class when that probability clears the
    threshold; speakers are returned sorted by descending vote count, ties in
    ascending id order (Rust's stable sort on count only).
    """
    windows = _windows_of(sample, extractor)
    if len(windows) == 0 or net.num_speakers == 0:
        return []
    _, probs = _prob_sums(net.params, jnp.asarray(windows), net.num_speakers)
    return _list_from_probs(np.asarray(probs), net.num_speakers, threshold)


def _list_from_probs(probs: np.ndarray, num_speakers: int, threshold: float) -> List[int]:
    """The vote-count/sort tail of ``identify_speaker_list``: a window votes
    for its argmax class when that probability clears the threshold;
    descending count, ties in ascending id (Rust's stable sort on count
    only, src/lib.rs:1383-1411)."""
    probs = probs[:, :num_speakers]
    best = probs.argmax(axis=1)
    best_val = probs.max(axis=1)
    # Gate in f32 EXPLICITLY: the reference compares f32 prob >= f32
    # threshold (src/lib.rs:1383-1411), and the batched device path
    # (_vote_counts_batch) compares in f32 on device.  NumPy 2's weak
    # scalars already make `f32_array >= python_float` an f32 compare;
    # the cast pins that parity on any NumPy version, so a threshold
    # whose f32 rounding crosses a window's max probability gates the
    # same way in all three formulations.
    counts = np.bincount(
        best[best_val >= np.float32(threshold)], minlength=num_speakers
    )
    order = sorted(
        (i for i in range(num_speakers) if counts[i] > 0),
        key=lambda i: (-counts[i], i),
    )
    return list(order)


@jax.jit
def _vote_counts_batch(params, windows, n_valid, num_speakers, threshold):
    """Per-clip gated vote counts for padded clip batches.

    windows: [B, W_pad, F]; n_valid: [B] → counts [B, capacity].  A padding
    window never votes (its row is masked out before the bincount).
    """
    probs = forward(params, windows, num_speakers)      # [B, W, cap]
    cap = probs.shape[-1]
    best = probs.argmax(axis=-1)                        # [B, W]
    best_val = probs.max(axis=-1)
    valid = jnp.arange(windows.shape[1])[None, :] < n_valid[:, None]
    gate = valid & (best_val >= threshold)
    onehot = jax.nn.one_hot(best, cap, dtype=jnp.int32)
    return (onehot * gate[..., None]).sum(axis=1)       # [B, cap]


def identify_speaker_list_batch(
    net: SpeakerNet, clips, threshold: float, extractor=None, mesh=None
) -> List[List[int]]:
    """Batched :func:`identify_speaker_list` over many clips.

    Buckets clips by power-of-two window count and runs ONE gated
    vote-count program per bucket (clip axis sharded over ``mesh`` when
    given) — the multi-clip L4 surface the per-clip host loop lacked.
    Per-clip results equal
    ``identify_speaker_list(net, clip)`` exactly, including the
    descending-count / ascending-id tie order.
    """
    clips = list(clips)
    if not clips or net.num_speakers == 0:
        return [[] for _ in clips]
    from streamz_tpu.dsp.features import FeatureExtractor

    extractor = extractor or FeatureExtractor()
    # Batched frontend too (one dispatch per length bucket, clip axis
    # sharded over the mesh) — per-clip extract() would pay N frontend
    # round trips while only the vote counting was batched.
    wins = extractor.extract_batch([np.asarray(c) for c in clips], mesh=mesh)
    out: List[List[int]] = [[] for _ in clips]
    buckets: dict = {}
    feat = next((w.shape[1] for w in wins if len(w)), None)
    for i, w in enumerate(wins):
        if len(w):
            from streamz_tpu import config

            buckets.setdefault(config.next_pow2(len(w)), []).append(i)
    for n_pad, idxs in buckets.items():
        lens = np.asarray([len(wins[i]) for i in idxs], np.int32)
        batch = np.zeros((len(idxs), n_pad, feat), np.float32)
        for row, i in enumerate(idxs):
            batch[row, : len(wins[i])] = wins[i]
        if mesh is not None:
            from streamz_tpu.parallel.mesh import (
                fetch, pad_rows_to_mesh, put_batch_sharded,
            )

            _, (batch_p, lens_p) = pad_rows_to_mesh(mesh, batch, lens)
            batch_d, lens_d = put_batch_sharded(mesh, batch_p, lens_p)
            counts = fetch(_vote_counts_batch(
                net.params, batch_d, lens_d, net.num_speakers,
                jnp.float32(threshold),
            ))
        else:
            counts = np.asarray(_vote_counts_batch(
                net.params, jnp.asarray(batch), jnp.asarray(lens),
                net.num_speakers, jnp.float32(threshold),
            ))
        ns = net.num_speakers
        for row, i in enumerate(idxs):
            c = counts[row][:ns]
            out[i] = sorted(
                (s for s in range(ns) if c[s] > 0),
                key=lambda s: (-c[s], s),
            )
    return out
