"""The incremental open-set discovery loop (default run mode).

Deterministic sequential rebuild of the reference's rayon fan-out #3
(``streamz-rs/src/main.rs:750-835``) — per file, in list order:

1. skip clips with fewer than 5 feature windows (``:757-761``);
2. clip embedding = normalized mean ReLU-h2 (``:764-768``);
3. burn-in phase while processed-count < burn-in limit; matching threshold
   0.5 during burn-in else ``--threshold`` (``:770-776``);
4. label assignment (``:779-800``): burn-in + unlabeled → always a *new*
   class (preserved quirk: no matching attempt during burn-in); labeled →
   keep; otherwise cosine match against current centroids, spawning a new
   class when no centroid passes;
5. train 5 epochs, batch 8, lr 0.05 for the first 1000 files then 0.01
   (``:802-815``);
6. update per-speaker running centroid (``:818-824``); every 100 files the
   embedding list is re-synced (``:826-829`` → ``recompute_embeddings``).

The reference's labels depend on rayon's nondeterministic interleaving; this
rebuild fixes file order = list order (SURVEY.md §7.7), giving reproducible
labels with the same capability.

``--max-speakers`` is *enforced* here as documented (README.md:68): when the
cap is reached, unlabeled files are assigned their best-matching existing
centroid instead of spawning a new class.  (The reference parses the flag but
never uses it — class growth is unbounded there, ``src/main.rs:520``.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from streamz_tpu import config
from streamz_tpu.infer.cosine import (
    compute_speaker_embeddings,
    identify_speaker_from_embedding,
)
from streamz_tpu.infer.embed import (
    average_vectors,
    extract_embedding_from_features,
    normalize,
)
from streamz_tpu.nn import drivers
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.runtime.progress import progress


# Re-exported routing threshold (defined with the sharded programs it gates).
from streamz_tpu.parallel.window_parallel import LONG_CLIP_WINDOW_THRESHOLD


@dataclasses.dataclass
class IncrementalResult:
    total_loss: float
    processed: int
    speaker_features: Dict[int, List[np.ndarray]]
    speaker_embeddings: Dict[int, np.ndarray]


def run_incremental(
    net: SpeakerNet,
    train_files: List[Tuple[str, Optional[int]]],
    feature_map: Dict[str, np.ndarray],
    *,
    burn_in_limit: int,
    conf_threshold: float = config.DEFAULT_CONF_THRESHOLD,
    dropout: float = config.DEFAULT_DROPOUT,
    batch_size: int = config.BATCH_SIZE,
    epochs: int = config.INCREMENTAL_EPOCHS,
    max_speakers: Optional[int] = None,
    show_progress: bool = True,
    mesh=None,
    device_store=None,
) -> IncrementalResult:
    """Mutates ``net`` and the labels inside ``train_files``; returns stats.

    Always the device-resident fused loop
    (:mod:`streamz_tpu.app.device_loop`) — one async dispatch per file, one
    synchronization at the end, so remote-TPU dispatch latency pipelines
    instead of stacking per file.  With a ``mesh`` the scan itself runs
    SPMD, window-sharding every file's embed forward and training gradients
    (the CP analogue, SURVEY.md §5.7) — long clips included, so one long
    clip no longer demotes the whole corpus to the host-stepped loop (which
    would cost ~2 blocking round-trips for every *other* file).  The
    bucket-spread cap keeps a long clip from inflating its neighbors'
    padding, and its padded windows are at most 2x the clip itself.
    """
    from streamz_tpu.app.device_loop import run_incremental_device

    total_loss, processed, sf, se = run_incremental_device(
        net,
        train_files,
        feature_map,
        burn_in_limit=burn_in_limit,
        conf_threshold=conf_threshold,
        dropout=dropout,
        batch_size=batch_size,
        epochs=epochs,
        max_speakers=max_speakers,
        show_progress=show_progress,
        mesh=mesh,
        device_store=device_store,
    )
    return IncrementalResult(
        total_loss=total_loss,
        processed=processed,
        speaker_features=sf,
        speaker_embeddings=se,
    )


def run_incremental_host(
    net: SpeakerNet,
    train_files: List[Tuple[str, Optional[int]]],
    feature_map: Dict[str, np.ndarray],
    *,
    burn_in_limit: int,
    conf_threshold: float = config.DEFAULT_CONF_THRESHOLD,
    dropout: float = config.DEFAULT_DROPOUT,
    batch_size: int = config.BATCH_SIZE,
    epochs: int = config.INCREMENTAL_EPOCHS,
    max_speakers: Optional[int] = None,
    show_progress: bool = True,
    mesh=None,
) -> IncrementalResult:
    """Host-stepped formulation of the same loop.

    Kept as the behavioral oracle the fused device loop is tested against
    (``tests/test_device_loop.py``).  With ``mesh`` it extracts embeddings
    of clips over ``LONG_CLIP_WINDOW_THRESHOLD`` windows via the
    feature-level window-sharded step — the same CP semantics the fused
    scan's psum-merged embed implements on-device.
    """

    # Seed the centroid map from the model's stored embeddings
    # (src/main.rs:715-734).
    speaker_embeddings: Dict[int, np.ndarray] = {
        i: np.asarray(mean, np.float32)
        for i, (mean, _, _) in enumerate(net.embeddings)
    }
    speaker_features: Dict[int, List[np.ndarray]] = {}

    total_loss = 0.0
    count = 0  # the reference's loss_count atomic: processed-file clock

    indices = list(range(len(train_files)))
    for i in progress(indices, desc="incremental", enabled=show_progress):
        path, label = train_files[i]
        windows = feature_map.get(path)
        if windows is None:
            print(f"Missing audio for {path}")
            continue
        if len(windows) < 5:
            print(f"Skipping {path}, too short")
            continue

        if mesh is not None and len(windows) >= LONG_CLIP_WINDOW_THRESHOLD:
            from streamz_tpu.parallel.window_parallel import extract_embedding_sharded

            # extract_embedding_sharded already L2-normalizes (its
            # call-site contract) — no outer normalize.
            emb = extract_embedding_sharded(net, windows, mesh)
        else:
            emb = normalize(extract_embedding_from_features(net, windows))

        burn_phase = count < burn_in_limit
        threshold = 0.5 if burn_phase else conf_threshold

        at_cap = max_speakers is not None and net.output_size() >= max_speakers
        if burn_phase and label is None and not at_cap:
            # Preserved quirk: burn-in unlabeled files always spawn a new
            # class without matching (src/main.rs:779-786).
            speaker_id = net.output_size()
            net.add_output_class()
            net.record_training_file(speaker_id, path)
            label = speaker_id
        elif label is not None:
            speaker_id = label
        else:
            matched = identify_speaker_from_embedding(
                emb, speaker_embeddings, threshold
            )
            if matched is None or matched >= net.output_size():
                if at_cap:
                    # --max-speakers enforcement: best centroid wins outright.
                    matched = identify_speaker_from_embedding(
                        emb, speaker_embeddings, -2.0
                    )
                    if matched is None:
                        matched = 0
                else:
                    net.add_output_class()
                    matched = net.output_size() - 1
            speaker_id = matched
            label = matched
        train_files[i] = (path, label)

        lr = config.LR_EARLY if count < config.LR_SWITCH_COUNT else config.LR_LATE
        loss = drivers.pretrain_from_features(
            net, windows, speaker_id, net.output_size(), epochs, lr,
            dropout, batch_size,
        )
        net.record_training_file(speaker_id, path)
        total_loss += loss

        speaker_features.setdefault(speaker_id, []).append(emb)
        speaker_embeddings[speaker_id] = average_vectors(
            speaker_features[speaker_id]
        )

        count += 1
        if count % 100 == 0:
            # Re-sync all centroids from collected features
            # (src/main.rs:216-241).
            for sid, feats in speaker_features.items():
                speaker_embeddings[sid] = average_vectors(feats)

    return IncrementalResult(
        total_loss=total_loss,
        processed=count,
        speaker_features=speaker_features,
        speaker_embeddings=speaker_embeddings,
    )


def finalize_and_save(
    net: SpeakerNet,
    result: IncrementalResult,
    model_path: str = config.MODEL_PATH,
    feature_map=None,
    store=None,
    mesh=None,
) -> None:
    """Recompute stored embeddings from the feature cache, save the model,
    print the summary (src/main.rs:840-868).

    ``feature_map``/``store``/``mesh`` forward to
    :func:`~streamz_tpu.infer.cosine.compute_speaker_embeddings`: files the
    run just ingested reuse the in-memory (or device-resident) windows
    instead of being decoded+extracted AGAIN one at a time — on a fresh
    corpus the reference re-runs its whole per-file pipeline here
    (``src/lib.rs:1569``), which on a device would mean one host round trip
    per file; existing cache files still take precedence bit-for-bit.
    """
    from streamz_tpu.nn import checkpoint

    new_embeddings = (
        compute_speaker_embeddings(
            net, mesh=mesh, feature_map=feature_map, store=store
        )
        or []
    )
    for i, (embed_v, mean, std) in enumerate(new_embeddings):
        norm = float(np.linalg.norm(embed_v))
        print(
            f"Saving Speaker {i} -> mean_sim: {mean:.4f}, "
            f"std_sim: {std:.4f}, norm: {norm:.4f}"
        )
    net.set_embeddings(new_embeddings)
    checkpoint.save(net, model_path)
    print(
        f"Computed {len(net.embeddings)} embeddings for "
        f"{net.output_size()} speakers"
    )
    if result.processed > 0:
        print(f"Average training loss: {result.total_loss / result.processed:.4f}")
