"""The StreamZ CLI driver.

Flag surface and mode dispatch mirror the reference binary
(``streamz-rs/src/main.rs:326-892``), including the flags that are documented
in its README but dead in its code (``--force``/``--retrain``/``--eval-split``/
``--cluster-embeddings`` — implemented for real here, per SURVEY.md §5.6):

  streamz [--threshold <v>] [--burn-in-limit <n>] [--max-speakers <n>]
          [--no-cache-wav] [--eval] [--eval-split <frac>] [--check-embeddings]
          [--cluster-embeddings <k>] [--force] [--retrain] [--no-autotune]
          [--encode <file>] [--decode <out>] [--checksum <hex>]
          [--identify <file>...] [--serve [port]] [--serve-streams <n>]
          [--serve-max-buffer <seconds>] [--serve-idle-timeout <seconds>]
          [--profile [dir]]
          [--coordinator <host:port>] [--num-processes <n>] [--process-id <i>]

Parsing is intentionally lenient like the reference's hand-rolled scanner
(``src/main.rs:343-448``): unknown flags are ignored, malformed values fall
back to defaults with a warning.  One deliberate exception: ``--help``/``-h``
prints this usage and exits instead of being ignored — the reference would
silently start a training run on it, a footgun worth fixing.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

import numpy as np

from streamz_tpu import config
from streamz_tpu.app.embedquality import print_embedding_quality
from streamz_tpu.app.evaluate import evaluate, resolve_eval_targets
from streamz_tpu.app.incremental import finalize_and_save, run_incremental
from streamz_tpu.dsp.features import FeatureExtractor
from streamz_tpu.infer.cluster import cluster_embeddings
from streamz_tpu.infer.cosine import compute_speaker_embeddings
from streamz_tpu.io import audio, filelists as fl
from streamz_tpu.nn import checkpoint
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.runtime.profiler import PhaseTimer, trace
from streamz_tpu.stego import codec


def _flag_value(
    args: List[str], flag: str, warn: bool = True
) -> Optional[str]:
    if flag in args:
        idx = args.index(flag)
        if idx + 1 < len(args):
            return args[idx + 1]
        if warn:
            print(f"Missing value for {flag}", file=sys.stderr)
    return None


def _parse_float(args, flag, default):
    raw = _flag_value(args, flag)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        print(
            f"Invalid value for {flag} '{raw}', using default {default}",
            file=sys.stderr,
        )
        return default


def _parse_int(args, flag) -> Optional[int]:
    raw = _flag_value(args, flag)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        print(
            f"Invalid value for {flag} '{raw}', using automatic setting",
            file=sys.stderr,
        )
        return None


def build_feature_map(
    paths: List[str], extractor: FeatureExtractor, show_progress: bool = True,
    timer=None, mesh=None, keep_device: bool = False, store_paths=None,
):
    """batch_resample + batched device feature extraction
    (src/main.rs:486-509, rayon fan-outs #1/#2 → thread pool + one batched
    device call; with ``mesh`` the clip axis is sharded across the data
    mesh).

    With ``keep_device`` returns ``(feature_map, store)`` where ``store`` is
    a path-keyed :class:`~streamz_tpu.dsp.mfcc.DeviceFeatureStore` holding
    the frontend's device outputs — the discovery loop assembles its fused
    chunks from it by device-side gather instead of re-uploading the
    features it just downloaded.  ``store`` is None when unavailable (numpy
    backend, multi-host run — host fetches there gather across processes,
    so per-process device rows don't cover every clip).

    ``store_paths`` restricts which clips the store keeps device-resident
    (e.g. eval mode pins only the eval targets — the training files'
    features are never gathered there, so pinning them would spend the
    device-memory budget on rows nobody reads).  Clips outside the set extract in a
    separate batched call so their buckets are never referenced by the
    store.
    """
    from streamz_tpu.runtime.watchdog import watchdog

    timer = timer or PhaseTimer()
    with timer.phase("ingest"), watchdog("ingest", 600.0):
        resampled = audio.batch_resample(paths)
    store = None
    if keep_device:
        import jax

        from streamz_tpu.dsp.mfcc import DeviceFeatureStore

        # STREAMZ_STORE_MAX_MB bounds the store's device-memory residency
        # (default 4096 MB ≈ 37k ten-second clips); <=0 disables the store
        # entirely (every consumer host-packs).
        try:
            cap_mb = float(os.environ.get("STREAMZ_STORE_MAX_MB", "4096"))
        except ValueError:
            cap_mb = 4096.0
        if (
            extractor.backend != "numpy"
            and jax.process_count() == 1
            and cap_mb > 0
        ):
            store = DeviceFeatureStore(
                mesh=mesh, max_bytes=int(cap_mb * 1e6)
            )
    with timer.phase("features"):
        if store is not None and store_paths is not None:
            kept = [
                i for i, (p, _) in enumerate(resampled) if p in store_paths
            ]
            rest = [
                i
                for i, (p, _) in enumerate(resampled)
                if p not in store_paths
            ]
            feats: List = [None] * len(resampled)
            if rest:
                for i, f in zip(
                    rest,
                    extractor.extract_batch(
                        [resampled[i][1] for i in rest], mesh=mesh
                    ),
                ):
                    feats[i] = f
            if kept:
                for i, f in zip(
                    kept,
                    extractor.extract_batch(
                        [resampled[i][1] for i in kept], mesh=mesh,
                        store=store,
                    ),
                ):
                    feats[i] = f
            rekey_map = {row: resampled[i][0] for row, i in enumerate(kept)}
        else:
            clips = [s for _, s in resampled]
            feats = extractor.extract_batch(clips, mesh=mesh, store=store)
            rekey_map = {i: p for i, (p, _) in enumerate(resampled)}
    fmap = {p: f for (p, _), f in zip(resampled, feats)}
    if keep_device:
        if store is not None:
            store.rekey(rekey_map)
        return fmap, store
    return fmap


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if "--help" in args or "-h" in args:
        # Print usage and exit BEFORE any device/bootstrap work.  The
        # reference's lenient scanner would ignore the flag and start a
        # training run — the one place leniency is a footgun.
        try:
            # __doc__ is None under python -OO (docstrings stripped): the
            # flag hardened against footguns must not traceback there.
            print((__doc__ or "usage: python -m streamz_tpu [flags] "
                   "(full usage requires docstrings; run without -OO)"
                   ).strip())
            sys.stdout.flush()
        except BrokenPipeError:  # `streamz --help | head` closed the pipe
            try:
                sys.stdout.close()
            except BrokenPipeError:
                pass
        return 0
    from streamz_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()

    # Multi-host bootstrap (must precede any device access): each process of
    # a multi-machine job passes the same coordinator and its own id, and the
    # mesh below then spans every host's devices (SURVEY.md §5.8).  Single-process runs skip this entirely.
    from streamz_tpu.parallel import comm

    comm.initialize_distributed(
        _flag_value(args, "--coordinator"),
        _parse_int(args, "--num-processes"),
        _parse_int(args, "--process-id"),
    )

    # Multi-chip: one "data" mesh over all (global) devices, used by every
    # batched application stage (ingest frontend, initial corpus training,
    # eval embedding batches, long-clip identification).  The application-
    # level analogue of the reference's rayon fan-outs (src/main.rs:490-508,
    # :750-835).
    from streamz_tpu.parallel.mesh import auto_mesh

    mesh = auto_mesh()
    if mesh is not None:
        import jax

        host = (
            f" across {jax.process_count()} hosts"
            if jax.process_count() > 1
            else ""
        )
        print(f"Running on {mesh.devices.size} devices (data-parallel mesh{host})")

    conf_threshold = _parse_float(args, "--threshold", config.DEFAULT_CONF_THRESHOLD)
    eval_split = _parse_float(args, "--eval-split", 0.2)
    burn_in_limit = _parse_int(args, "--burn-in-limit")
    max_speakers = _parse_int(args, "--max-speakers")
    cluster_k = _parse_int(args, "--cluster-embeddings")
    encode_path = _flag_value(args, "--encode")
    decode_path = _flag_value(args, "--decode")
    checksum_arg = _flag_value(args, "--checksum")
    # --identify consumes every following non-flag token (one-shot "who is
    # this clip?" — the reference library exposes identify_speaker_cosine
    # but its binary never surfaces it; extra mode, MIGRATION.md).
    identify_paths: List[str] = []
    if "--identify" in args:
        j = args.index("--identify") + 1
        while j < len(args) and not args[j].startswith("--"):
            identify_paths.append(args[j])
            j += 1
        if not identify_paths:
            print("Missing value for --identify", file=sys.stderr)
            return 1
    eval_mode = "--eval" in args
    check_embeddings = "--check-embeddings" in args
    force_retrain = "--force" in args or "--retrain" in args
    no_cache_wav = "--no-cache-wav" in args
    config.set_wav_cache_enabled(not no_cache_wav)
    if "--no-autotune" in args:
        # Skip the first-use measurement probes (seconds of device
        # cold-start); cached decisions still apply, a cold cache takes the
        # static defaults.  Exported so worker subprocesses inherit it.
        os.environ["STREAMZ_NO_AUTOTUNE"] = "1"
    profile = "--profile" in args
    profile_dir = None
    if profile:
        # The directory is optional: bare --profile is valid (no warning).
        maybe = _flag_value(args, "--profile", warn=False)
        if maybe and not maybe.startswith("--"):
            profile_dir = maybe
    timer = PhaseTimer()

    if checksum_arg:
        config.set_checksum_constant_override(checksum_arg)
    # Fresh trigger state per invocation (the reference is a fresh process).
    audio.CHECKSUM_TRIGGERED.clear()

    extractor = FeatureExtractor()

    if check_embeddings:
        try:
            net = checkpoint.load(config.MODEL_PATH)
        except Exception as e:
            print(
                f"Failed to load model from {config.MODEL_PATH}: {e}",
                file=sys.stderr,
            )
            return 1
        print(f"Loaded {config.MODEL_PATH} for embedding check")
        print_embedding_quality(net, extractor, mesh=mesh)
        return 0

    if cluster_k is not None:
        if cluster_k < 0:
            print(
                f"--cluster-embeddings expects a non-negative k, got {cluster_k}",
                file=sys.stderr,
            )
            return 1
        try:
            net = checkpoint.load(config.MODEL_PATH)
        except Exception as e:
            print(f"Failed to load model: {e}", file=sys.stderr)
            return 1
        embeds = [np.asarray(m) for m, _, _ in net.embeddings]
        if not embeds:
            print("No embeddings available to cluster")
            return 0
        labels = cluster_embeddings(embeds, cluster_k, 20)
        for i, lab in enumerate(labels):
            print(f"Speaker {i} -> cluster {lab}")
        return 0

    if decode_path:
        # --decode always decodes standalone and exits before any training
        # (src/main.rs:450-469; the in-training decode branch at :672-685 is
        # unreachable because of this early return).
        return _standalone_decode(decode_path)

    if identify_paths:
        return _identify_mode(
            identify_paths, extractor, conf_threshold, mesh, timer
        )

    if "--serve" in args:
        return _serve_mode(args, conf_threshold, mesh)

    train_files = fl.load_train_files(config.TRAIN_FILE_LIST)
    if not train_files:
        print(f"{config.TRAIN_FILE_LIST} is empty", file=sys.stderr)
        return 1
    original_paths = [p for p, _ in train_files]
    target_files = fl.load_target_files(config.TARGET_FILE_LIST)

    audio.precache_mp3_files(train_files)
    if eval_mode:
        audio.precache_target_files(target_files)

    import contextlib

    _trace_stack = contextlib.ExitStack()
    _trace_stack.enter_context(trace(profile_dir))
    try:
        return _run_main_body(
            train_files, target_files, original_paths, eval_mode,
            eval_split, conf_threshold, burn_in_limit, max_speakers,
            force_retrain, encode_path, extractor, timer, profile, mesh,
        )
    finally:
        # One exit path for the profiler trace: the previous four
        # hand-placed close() calls leaked an active jax.profiler trace
        # whenever the body raised — losing exactly the trace needed to
        # debug the failure.
        _trace_stack.close()


def _run_main_body(
    train_files, target_files, original_paths, eval_mode, eval_split,
    conf_threshold, burn_in_limit, max_speakers, force_retrain, encode_path,
    extractor, timer, profile, mesh,
) -> int:
    """The train/eval body of :func:`main` (split out so the profiler
    trace and the device store release sit in real ``finally`` blocks)."""
    path_list = [p for p, _ in train_files]
    if eval_mode:
        path_list.extend(p for p, _ in target_files)
    # Resolve the eval targets ONCE: the store-pin set below and the
    # evaluated set must be the same list, or a drift between two calls
    # silently pins the wrong clips (store misses losing the
    # device-residency win).
    targets = None
    store_paths = None
    if eval_mode:
        targets = resolve_eval_targets(train_files, target_files, eval_split)
        # keep_device: the downstream device consumer — the discovery loop
        # (training mode) or the eval embedding batches — reuses the
        # frontend's device outputs directly instead of re-uploading them.
        # Eval gathers only the eval targets' rows, so pin only those.
        store_paths = {p for p, _ in targets}
    feature_map, device_store = build_feature_map(
        path_list, extractor, timer=timer, mesh=mesh, keep_device=True,
        store_paths=store_paths,
    )

    for p, _ in train_files:
        if p not in feature_map:
            print(f"No features found for training path: {p}", file=sys.stderr)

    dataset_size = len(train_files)
    burn_in_default = int(np.ceil(dataset_size * config.DEFAULT_BURN_IN_FRAC))
    burn_in_limit_val = (
        burn_in_limit
        if burn_in_limit is not None
        else min(max(burn_in_default, 10), 50)
    )
    max_speakers_val = (
        max_speakers
        if max_speakers is not None
        else fl.count_speakers(train_files) + 10
    )

    if eval_mode:
        print(f"Evaluating with threshold = {conf_threshold}")
        # The in-memory lists: precache rewrote their MP3 entries to the
        # cache-WAV paths the feature map is keyed by.  The reference
        # re-loads the raw lists here (src/main.rs:525) and so silently
        # evaluates zero files for MP3 target lists — consciously fixed
        # (QUIRKS.md).  `targets` is the SAME list the store pinned above
        # (resolved once); precache rewrites paths, never labels, so the
        # in-memory train_files carries the same label set the reference
        # re-read from disk for build_label_map.
        label_map = fl.build_label_map(train_files, targets)
        norm_targets = fl.normalize_with_map(targets, label_map)
        if not os.path.exists(config.MODEL_PATH):
            print(
                f"Model file {config.MODEL_PATH} not found. Please train first.",
                file=sys.stderr,
            )
            return 1
        print(f"Loading model from {config.MODEL_PATH}")
        try:
            net = checkpoint.load(config.MODEL_PATH)
        except Exception as e:
            print(f"Failed to load model: {e}", file=sys.stderr)
            return 1
        print(f"Model contains {len(net.embeddings)} saved embeddings")
        with timer.phase("eval"):
            evaluate(
                net, feature_map, norm_targets, conf_threshold, mesh=mesh,
                store=device_store,
            )
        if device_store is not None:
            device_store.release()
        if profile:
            print(timer.report())
        return 0

    # ------------------------------------------------------------------
    # Training / incremental mode (src/main.rs:627-891)
    # ------------------------------------------------------------------
    num_speakers = fl.count_speakers(train_files)
    model_exists = os.path.exists(config.MODEL_PATH) and not force_retrain
    if model_exists:
        try:
            net = checkpoint.load(config.MODEL_PATH)
            print(f"Loaded saved model from {config.MODEL_PATH}")
            net.set_embeddings(
                compute_speaker_embeddings(
                    net, extractor, mesh=mesh,
                    feature_map=feature_map, store=device_store,
                )
                or []
            )
        except Exception as e:
            print(f"Failed to load model: {e}", file=sys.stderr)
            net = SpeakerNet.new(output=max(num_speakers, 1))
            model_exists = False
    else:
        if num_speakers == 0:
            num_speakers = 1
            p0, _ = train_files[0]
            train_files[0] = (p0, 0)
            print("No labeled speakers found - assigned speaker 0 to first file.")
        net = SpeakerNet.new(output=max(num_speakers, 1))

    if not model_exists:
        train_refs = [(p, c) for p, c in train_files if c is not None]
        if train_refs:
            # Batched initial training: one global shuffled window pool,
            # large batches, data-parallel over the mesh with psum allreduce
            # (app/corpus.py) — replacing the reference's per-file batch-8
            # loop (src/main.rs:652-669).  Same epochs/lr/dropout knobs;
            # host-side shuffle+dropout keep it device-count-invariant.
            from streamz_tpu.app import corpus

            pool_x, pool_y = corpus.build_window_pool(feature_map, train_refs)
            losses = corpus.train_corpus(
                net,
                pool_x,
                pool_y,
                epochs=config.TRAIN_EPOCHS,
                lr=0.01,
                dropout=config.DEFAULT_DROPOUT,
                mesh=mesh,
                seed=0,
            )
            for p, c in train_refs:
                net.record_training_file(c, p)
            if losses:
                print(f"Initial training loss: {float(np.mean(losses)):.4f}")

    if audio.CHECKSUM_TRIGGERED.is_set():
        if encode_path:
            print(f"Hiding {encode_path} in neural network")
            try:
                enc_net = codec.encode_file(encode_path)
                enc = enc_net.encoding_layer()
                if enc is not None:
                    net.set_encoding_layer(*enc)
                else:
                    net.set_encoding_layer(*enc_net.output_layer())
            except Exception as e:
                print(f"Encoding failed: {e}", file=sys.stderr)
            # training continues after encoding (src/main.rs:699)

    with timer.phase("incremental"):
        result = run_incremental(
            net,
            train_files,
            feature_map,
            burn_in_limit=burn_in_limit_val,
            conf_threshold=conf_threshold,
            max_speakers=max_speakers_val,
            mesh=mesh,
            device_store=device_store,
        )
    with timer.phase("finalize"):
        finalize_and_save(
            net, result, feature_map=feature_map, store=device_store,
            mesh=mesh,
        )
    if device_store is not None:
        device_store.release()  # free the device feature copies
    if profile:
        print(timer.report())

    updated = list(zip(original_paths, (c for _, c in train_files)))
    # Multi-host: every process writes its OWN working directory's lists
    # (the per-host layout the two-process e2e pins).  On a SHARED
    # working directory the writes race, but they are atomic
    # (filelists._atomic_write_text) and every process computes identical
    # labels (SPMD + psum), so the race is last-writer-wins with
    # identical content — never a torn file.
    fl.write_train_files(config.TRAIN_FILE_LIST, updated)
    fl.write_target_files(config.TARGET_FILE_LIST, train_files)
    print("Updated training file labels:")
    for p, c in updated:
        if c is not None:
            print(f"{p} -> speaker {c + 1}")
        else:
            print(f"{p} -> speaker unknown")
    print(f"Processed {fl.count_speakers(train_files)} speakers in this batch.")
    print(f"Number of speakers discovered: {net.output_size()}")
    for i in range(net.output_size()):
        n = len(result.speaker_features.get(i, []))
        print(f"Speaker {i}: {n} samples")
    return 0


def _serve_mode(args: List[str], threshold: float, mesh) -> int:
    """``--serve [port]``: run the TCP live-identification daemon.

    Loads ``model.npz`` (required, like ``--eval``), serves
    ``--serve-streams`` concurrent streams batched into shared device
    dispatches (:mod:`streamz_tpu.app.server`), and hot-swaps the model
    whenever the checkpoint file changes — so a training run writing
    ``model.npz`` next door continuously upgrades the live fleet.
    """
    from streamz_tpu.app.server import SpeakerServer

    port = 7071
    maybe = _flag_value(args, "--serve", warn=False)
    if maybe and not maybe.startswith("--"):
        try:
            port = int(maybe)
        except ValueError:
            print(
                f"Invalid value for --serve '{maybe}', using default {port}",
                file=sys.stderr,
            )
    n_streams = _parse_int(args, "--serve-streams")
    if n_streams is None:
        n_streams = 64
    elif n_streams < 1:
        # `or 64` would silently turn an explicit 0 into 64 and a negative
        # count into a raw constructor traceback; warn + default instead,
        # matching _parse_int's handling of unparseable values.
        print(
            f"Invalid value for --serve-streams '{n_streams}', using "
            "default 64",
            file=sys.stderr,
        )
        n_streams = 64
    # Per-slot host-buffer cap (transport backpressure): seconds of 44.1 kHz
    # audio a client may have queued ahead of the ticker before FEEDs are
    # rejected.  Default 30 s matches SpeakerServer's constructor default.
    max_buffer_s = _parse_float(args, "--serve-max-buffer", 30.0)
    if max_buffer_s <= 0:
        # A non-positive cap would reject every FEED with a backlog error.
        print(
            f"Invalid value for --serve-max-buffer '{max_buffer_s}', using "
            "default 30.0",
            file=sys.stderr,
        )
        max_buffer_s = 30.0
    # Idle reaping: drop a connection (and release its slot) after this
    # many seconds without a frame.  Unset/<=0 keeps slots for the life of
    # the connection — an idle fleet cannot then be reclaimed from silent
    # peers, so production deployments should set it.
    idle_timeout = _parse_float(args, "--serve-idle-timeout", 0.0)
    try:
        net = checkpoint.load(config.MODEL_PATH)
    except Exception as e:
        print(f"Failed to load model: {e}", file=sys.stderr)
        return 1
    srv = SpeakerServer(
        net,
        port=port,
        n_streams=n_streams,
        threshold=threshold,
        mesh=mesh,
        watch_model=config.MODEL_PATH,
        max_buffered_samples=int(max_buffer_s * config.DEFAULT_SAMPLE_RATE),
        idle_timeout=idle_timeout if idle_timeout > 0 else None,
    )
    srv.start()
    print(
        f"Serving {n_streams} stream slots on 127.0.0.1:{srv.port} "
        f"({net.output_size()} speakers; watching {config.MODEL_PATH})"
    )
    srv.serve_forever()
    return 0


def _identify_mode(
    paths: List[str], extractor, threshold: float, mesh, timer
) -> int:
    """One-shot identification of the given clips against the saved model.

    Uses the discovery loop's adaptive cosine gate (src/lib.rs:1634-1661) on
    embeddings computed in one bucketed batched device call — the same
    pipeline stage as ``--eval``, minus the metric bookkeeping.
    """
    from streamz_tpu.infer.cosine import cosine_matrix_many, identify_sims_cosine
    from streamz_tpu.infer.embed import batch_clip_embeddings

    try:
        net = checkpoint.load(config.MODEL_PATH)
    except Exception as e:
        print(f"Failed to load model: {e}", file=sys.stderr)
        return 1
    if not net.embeddings:
        # Older checkpoints may lack stored embeddings: rebuild from the
        # per-speaker training file lists, exactly like resume does.
        net.set_embeddings(
            compute_speaker_embeddings(net, extractor, mesh=mesh) or []
        )
    if not net.embeddings:
        print("Model has no speaker embeddings to match against", file=sys.stderr)
        return 1
    print(
        f"Loaded {config.MODEL_PATH} "
        f"({net.output_size()} speakers, {len(net.embeddings)} embeddings)"
    )

    feature_map, store = build_feature_map(
        paths, extractor, timer=timer, mesh=mesh, keep_device=True
    )
    present = [p for p in paths if feature_map.get(p) is not None]
    embeddings = batch_clip_embeddings(
        net, [feature_map[p] for p in present], mesh=mesh,
        store=store, keys=present,
    )
    if store is not None:
        store.release()
    centroids = np.stack(
        [np.asarray(m, np.float32) for m, _, _ in net.embeddings]
    )
    sims = (
        cosine_matrix_many(np.stack(embeddings), centroids)
        if present
        else np.zeros((0, len(net.embeddings)), np.float32)
    )
    sims_by_path = {p: s for p, s in zip(present, sims)}

    for p in paths:
        if p not in sims_by_path:
            print(f"{p}: failed to load", file=sys.stderr)
            continue
        sim_row = sims_by_path[p]
        # One batched GEMM produced the sims; gate each row without
        # recomputing the per-clip cosines.
        sid = identify_sims_cosine(sim_row, net.embeddings, threshold)
        best = int(np.argmax(sim_row))
        if sid is not None:
            print(f"{p}: speaker {sid} (similarity {float(sim_row[sid]):.3f})")
        else:
            print(
                f"{p}: unknown (best similarity {float(sim_row[best]):.3f} "
                f"to speaker {best})"
            )
    if not present:
        # Every input failed to load: distinguishable from a successful
        # run for scripts checking the exit code.
        print("No input file could be loaded", file=sys.stderr)
        return 1
    return 0


def _standalone_decode(out_path: str) -> int:
    try:
        net = checkpoint.load(config.MODEL_PATH)
    except Exception as e:
        print(f"Failed to load model: {e}", file=sys.stderr)
        return 1
    print(f"Loaded model from {config.MODEL_PATH}")
    data = codec.extract_file_from_classifier(net)
    try:
        with open(out_path, "wb") as f:
            f.write(data)
        print(f"Decoded {len(data)} bytes")
    except OSError as e:
        print(f"Failed to create {out_path}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
