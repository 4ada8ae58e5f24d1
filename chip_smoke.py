#!/usr/bin/env python3
"""StreamZ smoke test on one NVIDIA GPU: the main paths at full width.

    python chip_smoke.py           # phases a-e on one GPU
    python chip_smoke.py --four    # the multi-device paths on four GPUs only

One process owns the card(s).  Every input is made from a seed: the corpus
is synthetic speech-like WAV (a source-filter voice per speaker) written
with ``streamz_tpu.io.wav`` into a temporary directory.  Phases:

  a. device: JAX devices, the card's name and power limit, versions, flags,
     the compile cache in use, whether MP3 decoding is available;
  b. frontend parity at 32 clips x 10 s (the identify shape) and on a
     ragged batch, against the float64 golden spec (gate 1e-3);
  c. classifier parity: the forward on 65,536 windows at capacity 128
     against a float64 forward, and one corpus-step gradient against the
     reference delta rule;
  d. the CLI end to end (discovery, ``--eval``, ``--identify``,
     ``--check-embeddings``) on 16 speakers x 4 clips x 10 s, with the
     discovery labels held to the per-file host oracle and ``--identify``
     to the library's gate in this process;
  e. serving: a 64-speaker model trained on one clip per speaker serves
     64 slots on the i16 and mu-law wires, each verdict held to offline
     ``identify_speaker``; then the TCP daemon over localhost.

Each phase prints its numbers on its own lines; any failure raises, and the
script exits non-zero without printing a result.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
There is no CPU fallback: without a GPU the script exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RATE = 44100
FRONTEND_GATE = 1e-3  # the repo's feature-parity gate vs the golden spec
# Classifier tolerances.  Its GEMMs run in float32 (Precision.HIGHEST,
# streamz_tpu/precision.py): softmax probabilities land within a few 1e-6
# of a float64 forward, so the gate is 2e-5 absolute, and the summed
# gradient of a 4096-window batch within a few 1e-6 of the largest entry of
# each parameter's gradient, so that gate is 1e-4.  (TF32, the GPU's
# default for float32, misses both; see the table in precision.py.)
PROBS_ATOL = 2e-5
GRAD_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(AssertionError):
    """A phase's result disagrees with its reference."""


def check(ok, detail) -> None:
    """Fail the phase unless ``ok`` (an explicit raise: ``python -O`` strips
    ``assert`` statements, and the smoke test must never pass by default)."""
    if not ok:
        raise SmokeFailure(detail)


# ---------------------------------------------------------------------------
# Seeded synthetic corpus
# ---------------------------------------------------------------------------


def voice_params(speaker: int) -> dict:
    """The fixed voice of synthetic speaker ``speaker`` (any index), drawn
    from a seeded generator: pitch 80-300 Hz, three formants and their
    bandwidths in the ranges of adult vowels, spectral tilt, breathiness."""
    rng = np.random.default_rng([7, speaker])
    return {
        "f0": float(np.exp(rng.uniform(np.log(80.0), np.log(300.0)))),
        "formants": (rng.uniform(250, 900), rng.uniform(900, 2400),
                     rng.uniform(2400, 3600)),
        "bandwidths": (rng.uniform(50, 150), rng.uniform(70, 200),
                       rng.uniform(100, 300)),
        "tilt": rng.uniform(-0.9, 0.95),
        "breath": rng.uniform(0.02, 0.5),
    }


def speaker_voice(speaker: int, n_samples: int, rate: int = RATE,
                  seed: int = 0) -> np.ndarray:
    """int16 speech-like signal of one synthetic speaker (source-filter): a
    glottal pulse train at the speaker's own pitch, with vibrato, plus the
    speaker's breath noise, through the speaker's spectral tilt and three
    resonators at its formants, at a syllable-rate loudness.  ``seed``
    varies the utterance, not the speaker."""
    from scipy.signal import lfilter

    voice = voice_params(speaker)
    rng = np.random.default_rng([speaker, seed])
    t = np.arange(n_samples) / rate
    vib = 1.0 + 0.03 * np.sin(2 * np.pi * (4.0 + 0.5 * rng.random()) * t
                              + rng.uniform(0, 2 * np.pi))
    cycles = np.cumsum(voice["f0"] * vib / rate) + rng.random()
    source = np.diff(np.floor(cycles), prepend=np.floor(cycles[0]))
    sig = source + rng.normal(0, voice["breath"], n_samples)
    sig = lfilter([1.0], [1.0, -voice["tilt"]], sig)
    for freq, bw in zip(voice["formants"], voice["bandwidths"]):
        r = np.exp(-np.pi * bw / rate)
        a = [1.0, -2.0 * r * np.cos(2 * np.pi * freq / rate), r * r]
        sig = lfilter([1.0 - r], a, sig)
    syll = 0.3 + 0.7 * np.sin(np.pi * (3.0 + rng.random()) * t
                              + rng.uniform(0, np.pi)) ** 2
    sig = sig * syll
    sig /= np.abs(sig).max() + 1e-12
    return np.clip(sig * 16000.0, -32768, 32767).astype(np.int16)


def build_corpus(root: str, n_speakers: int = 16, clips_per_speaker: int = 4,
                 seconds: float = 10.0, low_rate: int = 16000,
                 seed: int = 0):
    """Write ``n_speakers x clips_per_speaker`` WAV clips under ``root`` and
    ``root/train_files.txt``.  Clip 0 and 1 of every speaker carry the
    speaker's label; the rest are unlabeled.  The last clip of every fourth
    speaker is written at ``low_rate`` so ingest resamples it.  Files are
    listed speaker-interleaved.  Returns the ``(path, label)`` list."""
    from streamz_tpu.io.wav import write_wav

    os.makedirs(os.path.join(root, "clips"), exist_ok=True)
    entries = []
    for c in range(clips_per_speaker):
        for s in range(n_speakers):
            rate = (low_rate if s % 4 == 0 and c == clips_per_speaker - 1
                    else RATE)
            path = os.path.join("clips", f"spk{s:02d}_c{c}.wav")
            pcm = speaker_voice(s, int(seconds * rate), rate, seed=seed + c)
            write_wav(os.path.join(root, path), pcm, sample_rate=rate)
            entries.append((path, s if c < 2 else None))
    with open(os.path.join(root, "train_files.txt"), "w") as f:
        for path, label in entries:
            f.write(path if label is None else f"{path},{label}")
            f.write("\n")
    return entries


# ---------------------------------------------------------------------------
# Plain float64 references
# ---------------------------------------------------------------------------


def _f64(params):
    return {k: np.asarray(v, np.float64) for k, v in params.items()}


def probs_f64(params, x, num_speakers: int) -> np.ndarray:
    """Softmax over the live classes of the reference MLP
    (ReLU -> tanh -> softmax, ``src/lib.rs:880-891``); padded columns 0."""
    p = _f64(params)
    h1 = np.maximum(np.asarray(x, np.float64) @ p["w1"] + p["b1"], 0.0)
    h2 = np.tanh(h1 @ p["w2"] + p["b2"])
    z = h2 @ p["w3"][:, :num_speakers] + p["b3"][:num_speakers]
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    out = np.zeros((len(z), p["b3"].shape[0]))
    out[:, :num_speakers] = e / e.sum(axis=-1, keepdims=True)
    return out


def delta_rule_grads_f64(params, x, labels, weights, num_speakers: int):
    """Summed reference gradients over the weighted batch: output delta
    ``softmax - target`` (target zero for an out-of-range label), back
    through tanh and ReLU (``src/lib.rs:1002-1060``)."""
    p = _f64(params)
    x = np.asarray(x, np.float64)
    w = np.asarray(weights, np.float64)[:, None]
    h1_pre = x @ p["w1"] + p["b1"]
    h1 = np.maximum(h1_pre, 0.0)
    h2 = np.tanh(h1 @ p["w2"] + p["b2"])
    out = probs_f64(params, x, num_speakers)
    target = np.zeros_like(out)
    live = np.asarray(labels) < num_speakers
    target[np.arange(len(x))[live], np.asarray(labels)[live]] = 1.0
    delta = (out - target) * w
    delta[:, num_speakers:] = 0.0
    dh2 = (delta @ p["w3"].T) * (1.0 - h2 ** 2)
    dh1 = (dh2 @ p["w2"].T) * (h1_pre > 0)
    return {
        "w3": h2.T @ delta, "b3": delta.sum(0),
        "w2": h1.T @ dh2, "b2": dh2.sum(0),
        "w1": x.T @ dh1, "b1": dh1.sum(0),
    }


def max_feature_error(got, clips) -> float:
    """Largest |feature - golden| over a batch; shapes must match."""
    from streamz_tpu.dsp.mfcc_ref import extract_features_np

    err = 0.0
    for g, clip in zip(got, clips):
        want = extract_features_np(clip)
        check(g.shape == want.shape, f"shape {g.shape} != golden {want.shape}")
        if len(want):
            err = max(err, float(np.abs(np.asarray(g, np.float64) - want).max()))
    return err


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> None:
    import jax

    from streamz_tpu.runtime.compile_cache import enable_compile_cache
    from streamz_tpu.runtime.measure import card_name_and_power_limit

    cache = enable_compile_cache()
    log(f"devices: {jax.devices()}")
    log(f"card: {card_name_and_power_limit()}")
    log(f"jax {jax.__version__}, python {sys.version.split()[0]}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    try:
        from streamz_tpu.io import mp3

        mp3._load_lib()
        log("mp3 decode: available (libmpg123)")
    except Exception as e:  # reported, not required: the corpus is WAV
        log(f"mp3 decode: unavailable ({e})")


def phase_frontend(n_clips: int = 32, seconds: float = 10.0) -> float:
    from streamz_tpu.dsp.features import FeatureExtractor
    from streamz_tpu.precision import MATMUL

    ext = FeatureExtractor("auto")
    clips = [speaker_voice(i % 16, int(seconds * RATE), seed=100 + i)
             for i in range(n_clips)]
    t0 = time.perf_counter()
    got = ext.extract_batch(clips)
    dt = time.perf_counter() - t0
    n_win = sum(len(g) for g in got)
    err = max_feature_error(got, clips)
    log(f"frontend: {n_clips} x {seconds:g} s, {n_win} windows, max abs err "
        f"{err:.3g} vs float64 golden (gate {FRONTEND_GATE:g}), precision "
        f"{MATMUL}, first call {dt:.2f} s incl. compile")
    check(err <= FRONTEND_GATE, err)
    # Ragged: 0 blocks, 1 block (no window), an odd block count plus a
    # partial block, and a clip of exactly two blocks (one window).
    rng = np.random.default_rng(7)
    lens = [0, 399, 400, 799, 800, 7 * 400 + 123, 41 * 400]
    ragged = [rng.normal(0, 3000, n).astype(np.int16) for n in lens]
    got = ext.extract_batch(ragged)
    err_r = max_feature_error(got, ragged)
    log(f"frontend ragged lengths {lens}: windows "
        f"{[len(g) for g in got]}, max abs err {err_r:.3g}")
    check(err_r <= FRONTEND_GATE, err_r)
    return max(err, err_r)


def phase_classifier(n_windows: int = 65536, n_speakers: int = 64,
                     grad_batch: int = 4096):
    import jax
    import jax.numpy as jnp

    from streamz_tpu.nn import train
    from streamz_tpu.nn.model import SpeakerNet, forward
    from streamz_tpu.precision import MATMUL

    net = SpeakerNet.new(output=n_speakers, seed=0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n_windows, 60)).astype(np.float32)
    xd = jnp.asarray(x)
    fwd = jax.jit(forward, static_argnums=2)
    got = np.asarray(fwd(net.params, xd, n_speakers))
    want = probs_f64(net.params, x, n_speakers)
    err = float(np.abs(got - want).max())
    agree = float(np.mean(got.argmax(1) == want.argmax(1)))
    t_prod = _time(fwd, net.params, xd, n_speakers)
    log(f"classifier forward: {n_windows} windows, capacity {net.capacity}, "
        f"{MATMUL}: max |p - p64| {err:.3g} (gate {PROBS_ATOL:g}), argmax "
        f"agreement {agree:.5f}, {1e3 * t_prod:.3f} ms")
    check(net.capacity == 128 or n_speakers != 64, net.capacity)
    check(err <= PROBS_ATOL, err)

    xb = x[:grad_batch]
    labels = rng.integers(0, n_speakers + 2, grad_batch).astype(np.int32)
    weights = (rng.random(grad_batch) > 0.1).astype(np.float32)
    grads, _, count = jax.jit(train.corpus_grads, static_argnums=4)(
        net.params, jnp.asarray(xb), jnp.asarray(labels),
        jnp.asarray(weights), n_speakers)
    want_g = delta_rule_grads_f64(net.params, xb, labels, weights, n_speakers)
    worst = 0.0
    for k, g_ref in want_g.items():
        scale = max(float(np.abs(g_ref).max()), 1e-12)
        worst = max(worst, float(np.abs(np.asarray(grads[k]) - g_ref).max())
                    / scale)
    log(f"corpus-step gradient: batch {grad_batch} ({int(count)} weighted), "
        f"max |g - g64| / max|g64| {worst:.3g} (gate {GRAD_RTOL:g})")
    check(worst <= GRAD_RTOL, worst)
    return err, worst


def _time(fn, *args, reps: int = 20) -> float:
    """Median seconds per call of a warmed-up device function."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / reps)
    return sorted(times)[2]


def _snapshot(net):
    """An independent copy of ``net`` (the trainers donate their params)."""
    import jax
    import jax.numpy as jnp

    return dataclasses.replace(
        net, params=jax.tree.map(jnp.copy, net.params),
        file_lists=[list(f) for f in net.file_lists],
        embeddings=list(net.embeddings),
    )


def _cli(args):
    """``streamz_tpu.cli.main(args)`` with its stdout captured and echoed."""
    from streamz_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    out = buf.getvalue()
    tail = "\n".join(out.strip().splitlines()[-6:])
    shown = " ".join(args[:3]) + (f" ... ({len(args)} args)"
                                  if len(args) > 3 else "")
    log(f"$ streamz {shown} -> rc {rc}\n{tail}")
    if rc != 0:
        raise AssertionError(f"cli {args} exited {rc}:\n{out[-3000:]}")
    return out


def run_cli_discovery(workdir: str, n_speakers: int = 16,
                      clips_per_speaker: int = 4, seconds: float = 10.0):
    """Build the corpus in ``workdir`` and run the CLI's discovery there.
    Returns (entries, final labels, the loop's input state, loop seconds,
    files processed)."""
    from streamz_tpu import cli
    from streamz_tpu.io import filelists
    from streamz_tpu.nn import drivers

    os.makedirs(workdir, exist_ok=True)
    entries = build_corpus(workdir, n_speakers, clips_per_speaker, seconds)
    spy = {}
    real = cli.run_incremental

    def spying(net, train_files, feature_map, **kw):
        # The loop draws its per-file PRNG keys from the next fresh key.
        spy.update(net=_snapshot(net), files=list(train_files),
                   fmap=dict(feature_map), kw=kw,
                   key_seed=drivers._key_counter[0] + 1)
        t0 = time.perf_counter()
        res = real(net, train_files, feature_map, **kw)
        spy["seconds"] = time.perf_counter() - t0
        spy["processed"] = res.processed
        return res

    cwd = os.getcwd()
    os.chdir(workdir)
    cli.run_incremental = spying
    try:
        _cli([])
        labels = [c for _, c in filelists.load_train_files("train_files.txt")]
    finally:
        cli.run_incremental = real
        os.chdir(cwd)
    return entries, labels, spy


def phase_cli(workdir: str, n_speakers: int = 16, clips_per_speaker: int = 4,
              seconds: float = 10.0):
    import jax

    from streamz_tpu import config
    from streamz_tpu.app.device_loop import run_incremental_device
    from streamz_tpu.app.incremental import run_incremental_host
    from streamz_tpu.nn import checkpoint, drivers

    entries, labels, spy = run_cli_discovery(
        workdir, n_speakers, clips_per_speaker, seconds)
    n = len(entries)
    log(f"discovery: {spy['processed']} files in {spy['seconds']:.2f} s "
        f"(first call, incl. compile) = "
        f"{1e3 * spy['seconds'] / max(spy['processed'], 1):.1f} ms/file")
    check(len(labels) == n and all(c is not None for c in labels), labels)

    # The per-file host oracle on the loop's own input state, drawing the
    # loop's per-file PRNG keys (fold_in(base, k) for the k-th trained
    # file), so both train identically and only arithmetic order differs.
    kw = spy["kw"]
    host_files = list(spy["files"])
    base = jax.random.PRNGKey(spy["key_seed"])
    keys = (jax.random.fold_in(base, k) for k in itertools.count())
    real_fresh = drivers._fresh_key
    drivers._fresh_key = lambda seed=None: next(keys)
    try:
        run_incremental_host(
            _snapshot(spy["net"]), host_files, spy["fmap"],
            burn_in_limit=kw["burn_in_limit"],
            conf_threshold=kw["conf_threshold"],
            max_speakers=kw["max_speakers"], show_progress=False,
        )
    finally:
        drivers._fresh_key = real_fresh
    host_labels = [c for _, c in host_files]
    log(f"discovery labels: {labels}")
    check(labels == host_labels, (labels, host_labels))
    log(f"discovery labels equal the host oracle's ({n} files, "
        f"{len(set(labels))} speakers)")

    # Warm per-file cost of the fused XLA loop on the same inputs.
    warm_files = list(spy["files"])
    t0 = time.perf_counter()
    run_incremental_device(
        _snapshot(spy["net"]), warm_files, spy["fmap"],
        burn_in_limit=kw["burn_in_limit"],
        conf_threshold=kw["conf_threshold"], dropout=config.DEFAULT_DROPOUT,
        batch_size=config.BATCH_SIZE, epochs=config.INCREMENTAL_EPOCHS,
        max_speakers=kw["max_speakers"], show_progress=False,
        mesh=kw.get("mesh"),
    )
    dt = time.perf_counter() - t0
    log(f"discovery loop (XLA lax.scan), warm: {1e3 * dt / n:.2f} ms/file "
        f"({n} files, {dt:.3f} s)")

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        net = checkpoint.load(config.MODEL_PATH)
        with np.load(config.MODEL_PATH) as z:
            keys = set(z.files)
        need = {"w1", "b1", "w2", "b2", "sample_rate", "bits",
                "num_speakers", "speaker_embeddings"}
        need |= {f"w3_{i + 1}" for i in range(net.num_speakers)}
        check(need <= {k.removesuffix(".npy") for k in keys}, need - keys)
        log(f"model.npz: {net.num_speakers} speakers, {len(keys)} arrays, "
            f"reference schema keys present")
        _cli(["--eval"])
        check_identify(net, entries, labels, spy["fmap"])
        _cli(["--check-embeddings"])
    finally:
        os.chdir(cwd)
    return net


def gate_margin(row, stats, threshold: float) -> float:
    """How far the adaptive cosine gate's decision on one similarity row
    (:func:`~streamz_tpu.infer.cosine.identify_sims_cosine`) is from
    flipping: the smallest gap between a similarity and any bound the gate
    compares it with, or between the winner and the next accepted
    candidate."""
    row = np.asarray(row, np.float64)
    mean = np.array([m for _, m, _ in stats], np.float64)
    std = np.array([s for _, _, s in stats], np.float64)
    dynamic = mean + (0.3 if len(stats) < 200 else 1.0) * std
    reject = mean - 2.0 * std
    margin = min(float(np.abs(row - bound).min())
                 for bound in (reject, dynamic, 0.5, 0.35, threshold))
    accepted = ((row > 0.35) & ((row > dynamic) | (row > 0.5))
                & (row >= reject) & (row > threshold))
    top = np.sort(row[accepted])[::-1]
    if len(top) > 1:
        margin = min(margin, float(top[0] - top[1]))
    return margin


def check_identify(net, entries, labels, fmap, eps: float = 1e-5) -> None:
    """``--identify`` on every clip of the corpus, against the saved model's
    adaptive gate computed in this process on the clips' training features.
    Every clip whose in-process decision is more than ``eps`` from flipping
    (re-extracting features moves a cosine by far less) must get the same
    answer from the CLI, and at least one of them its trained label.  On
    this corpus discovery folds most clips into one class, so the answers
    are mostly that class: this checks the CLI against the library, not
    the quality of discovery."""
    from streamz_tpu import config
    from streamz_tpu.infer.cosine import cosine_matrix_many, identify_sims_cosine
    from streamz_tpu.infer.embed import batch_clip_embeddings

    paths = [p for p, _ in entries]
    out = _cli(["--identify", *paths])
    got = {}
    for p in paths:
        m = re.search(rf"^{re.escape(p)}: (?:speaker (\d+)|unknown) ", out,
                      re.MULTILINE)
        check(m, f"--identify printed no answer for {p}")
        got[p] = None if m.group(1) is None else int(m.group(1))
    embs = batch_clip_embeddings(net, [fmap[p] for p in paths])
    cent = np.stack([np.asarray(m, np.float32) for m, _, _ in net.embeddings])
    sims = cosine_matrix_many(np.stack(embs), cent)
    threshold = config.DEFAULT_CONF_THRESHOLD
    settled, trained = 0, set()
    for p, label, row in zip(paths, labels, sims):
        if gate_margin(row, net.embeddings, threshold) <= eps:
            continue
        settled += 1
        want = identify_sims_cosine(row, net.embeddings, threshold)
        check(got[p] == want, f"--identify {p}: {got[p]}, in process {want}")
        if want == label:
            trained.add(p)
    answers = [got[p] for p in paths]
    log(f"--identify on {len(paths)} clips: {settled} settled (gate margin "
        f"> {eps:g}) agree with the in-process gate; {len(trained)} return "
        f"their trained label (classes "
        f"{sorted({labels[paths.index(p)] for p in trained})}); answers "
        f"{sorted(set(map(str, answers)))}, {answers.count(None)} unknown")
    check(trained, "no clip's trained label came back from --identify")


def serving_model(n_speakers: int = 64, seconds: float = 5.0,
                  epochs: int = 100, mesh=None):
    """A model whose verdicts differ from speaker to speaker: the reference
    MLP at ``n_speakers`` outputs (64 pads to capacity 128), trained by the
    batched corpus trainer on one clip of each synthetic speaker."""
    from streamz_tpu.app import corpus
    from streamz_tpu.dsp.features import FeatureExtractor
    from streamz_tpu.nn.model import SpeakerNet

    feats = FeatureExtractor().extract_batch(
        [speaker_voice(s, int(seconds * RATE), seed=50)
         for s in range(n_speakers)])
    net = SpeakerNet.new(output=n_speakers, seed=0)
    t0 = time.perf_counter()
    losses = corpus.train_corpus(
        net, np.concatenate(feats),
        np.concatenate([np.full(len(f), s, np.int32)
                        for s, f in enumerate(feats)]),
        epochs=epochs, batch_size=1024, lr=0.05, dropout=0.2, mesh=mesh)
    log(f"serving model: {n_speakers} speakers (capacity {net.capacity}), "
        f"{epochs} epochs over {sum(map(len, feats))} windows, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"{time.perf_counter() - t0:.2f} s")
    return net


def _offline_verdicts(net, pcms):
    from streamz_tpu.infer.identify import identify_speaker

    return [identify_speaker(net, p) for p in pcms]


def phase_serving(net, n_slots: int = 64, seconds: float = 3.0,
                  chunk_s: float = 0.25):
    """Slot i carries an utterance of speaker ``i % num_speakers``; even
    slots on the i16 wire, odd slots on mu-law.  Every verdict must equal
    offline ``identify_speaker`` on what the server heard, and the verdicts
    must differ across slots (a quarter of the slots distinct at least,
    and the two wires' halves not alike), so that a swapped slot, a wire
    decoded as the other or a constant answer cannot pass."""
    from streamz_tpu.app.serve import MultiStreamIdentifier
    from streamz_tpu.app.server import SpeakerServer, StreamClient
    from streamz_tpu.io import g711

    n = int(seconds * RATE)
    speakers = [i % net.num_speakers for i in range(n_slots)]
    pcms = [speaker_voice(s, n, seed=200 + i) for i, s in enumerate(speakers)]
    wires = ["i16" if i % 2 == 0 else "ulaw" for i in range(n_slots)]
    codes = {i: g711.ulaw_encode(p) for i, p in enumerate(pcms)
             if wires[i] == "ulaw"}
    # What the server hears on each wire (mu-law is lossy).
    heard = [pcms[i] if wires[i] == "i16" else g711.decode(codes[i], "ulaw")
             for i in range(n_slots)]
    want = _offline_verdicts(net, heard)
    halves = {w: [want[i] for i in range(n_slots) if wires[i] == w]
              for w in ("i16", "ulaw")}
    own = sum(v == s for v, s in zip(want, speakers))
    log(f"offline verdicts: {len(set(want))} distinct over {n_slots} slots, "
        f"{own} name the slot's own speaker")
    check(len(set(want)) >= max(2, n_slots // 4), want)
    check(set(halves["i16"]) != set(halves["ulaw"]), halves)

    srv = MultiStreamIdentifier(net, n_streams=n_slots, threshold=0.0)
    sids = [srv.open() for _ in range(n_slots)]
    step = int(chunk_s * RATE)
    t0 = time.perf_counter()
    ticks = 0
    for off in range(0, n, step):
        for i, sid in enumerate(sids):
            if wires[i] == "i16":
                srv.feed(sid, pcms[i][off:off + step])
            else:
                srv.feed(sid, codes[i][off:off + step], encoding="ulaw")
        srv.tick()
        ticks += 1
    got = [srv.finalize(sid) for sid in sids]
    dt = time.perf_counter() - t0
    got_ids = [g[0] for g in got]
    for w in ("i16", "ulaw"):
        idx = [i for i in range(n_slots) if wires[i] == w]
        bad = [i for i in idx if got_ids[i] != want[i]]
        check(not bad, (w, [(i, got_ids[i], want[i]) for i in bad]))
    log(f"serving: {n_slots} slots ({wires.count('i16')} i16, "
        f"{wires.count('ulaw')} mu-law), {ticks} ticks of {chunk_s:g} s, "
        f"{dt:.2f} s incl. compile; every verdict equals offline "
        f"identify_speaker ({len(set(got_ids))} distinct speakers)")

    # The TCP daemon: FEED / CURRENT / FINALIZE on two connections, an i16
    # slot and the first mu-law slot with another verdict.
    pair = (0, next(i for i in range(n_slots)
                    if wires[i] == "ulaw" and want[i] != want[0]))
    server = SpeakerServer(net, port=0, n_streams=4, threshold=0.0,
                           tick_interval=0.005)
    server.start()
    try:
        results = []
        for i in pair:
            wire = wires[i]
            with StreamClient("127.0.0.1", server.port) as c:
                for off in range(0, n, step):
                    c.feed(pcms[i][off:off + step], wire=wire)
                cur = c.current()
                fin = c.finalize()
                results.append((wire, cur, fin))
                check(fin is not None and fin[0] == want[i],
                      (wire, fin, want[i]))
        log(f"daemon over TCP: {results} (offline "
            f"{[want[i] for i in pair]})")
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# Four devices
# ---------------------------------------------------------------------------


def four_devices(workdir: str) -> None:
    """Each multi-device program against its single-device result, in this
    process, on a 1-D mesh over four devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from streamz_tpu.app import device_loop as dl
    from streamz_tpu.app.serve import MultiStreamIdentifier
    from streamz_tpu.dsp.mfcc import extract_features
    from streamz_tpu.infer.identify import identify_speaker
    from streamz_tpu.nn import drivers, train
    from streamz_tpu.nn.model import SpeakerNet
    from streamz_tpu.parallel import comm, data_parallel as dp
    from streamz_tpu.parallel import window_parallel as wp
    from streamz_tpu.parallel import mesh as meshmod

    devs = jax.devices()
    check(len(devs) == 4, devs)
    net = SpeakerNet.new(output=64, seed=0)

    # Data-parallel corpus step vs the single-device step.
    mesh = comm.make_mesh(4, axis=comm.DATA_AXIS)
    rng = np.random.default_rng(11)
    B = 8192
    x = rng.normal(size=(B, 60)).astype(np.float32)
    y = rng.integers(0, 64, B).astype(np.int32)
    w = np.ones(B, np.float32)
    sh = NamedSharding(mesh, P(comm.DATA_AXIS))
    step = dp.make_dp_train_step(mesh)
    p4, l4 = step(net.params, *(jax.device_put(a, sh) for a in (x, y, w)),
                  jnp.int32(64), jnp.float32(0.05))
    p1, l1 = jax.jit(train.corpus_step, static_argnums=4)(
        net.params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), 64, 0.05)
    dparam = max(float(jnp.abs(p4[k] - p1[k]).max()) for k in p1)
    log(f"dp_train: loss {float(l4):.6f} vs {float(l1):.6f}, max |dparam| "
        f"{dparam:.3g} (gate 1e-5: float32 psum order), params on "
        f"{len(p4['w1'].sharding.device_set)} devices")
    check(abs(float(l4) - float(l1)) < 1e-5 and dparam < 1e-5, "dp_train")

    # A model trained on one device whose verdicts differ across speakers,
    # for the identify and serving comparisons.
    net = serving_model(16, seconds=3.0, mesh=comm.make_mesh(1))
    # Uncommitted copies, so each program below places them on its own mesh.
    net.params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                              net.params)

    # PCM-halo frontend and fused identify on the window mesh.
    wmesh = comm.make_mesh(4, axis=comm.WINDOW_AXIS)
    clip = speaker_voice(5, 20 * RATE, seed=9)
    f1 = extract_features(clip)
    f4 = np.asarray(wp.mfcc_features_pcm_sharded(clip, wmesh))
    herr = float(np.abs(f4 - f1).max())
    log(f"halo_frontend: {f1.shape}, max |f4 - f1| {herr:.3g} (gate 1e-5)")
    check(f4.shape == f1.shape and herr <= 1e-5, "halo_frontend")
    s4 = wp.identify_speaker_pcm_sharded(net, clip, wmesh)
    s1 = identify_speaker(net, clip)
    log(f"identify_psum: {s4} vs {s1}")
    check(s4 == s1, "identify_psum")

    # Slot-sharded serving vs single-device serving.
    pcms = [speaker_voice(i, 2 * RATE, seed=300 + i) for i in range(16)]
    verdicts = []
    for m in (comm.make_mesh(4), None):
        srv = MultiStreamIdentifier(net, n_streams=16, threshold=0.0, mesh=m)
        sids = [srv.open() for _ in pcms]
        for sid, p in zip(sids, pcms):
            srv.feed(sid, p)
        srv.tick()
        verdicts.append([srv.finalize(sid)[0] for sid in sids])
    log(f"serve_shard: {verdicts[0]} vs {verdicts[1]}")
    check(verdicts[0] == verdicts[1], "serve_shard")
    check(len(set(verdicts[1])) >= 4, "serve_shard: too few distinct verdicts")

    # Sharded discovery scan vs the single-device scan.
    files, fm = [], {}
    for i in range(24):
        path = f"clip_{i}.wav"
        feats = extract_features(speaker_voice(i % 6, 4 * RATE, seed=i))
        files.append((path, 0 if i == 0 else None))
        fm[path] = feats
    labels = []
    old = os.environ.get("STREAMZ_SHARD_DISCOVERY")
    try:
        for env, m in (("1", mesh), ("0", None)):
            os.environ["STREAMZ_SHARD_DISCOVERY"] = env
            drivers._key_counter[0] = 0
            fs = list(files)
            dl.run_incremental_device(
                SpeakerNet.new(output=1, seed=0), fs, fm, burn_in_limit=4,
                conf_threshold=0.8, dropout=0.0, batch_size=8, epochs=1,
                max_speakers=None, show_progress=False, mesh=m,
            )
            labels.append([c for _, c in fs])
    finally:
        if old is None:
            os.environ.pop("STREAMZ_SHARD_DISCOVERY", None)
        else:
            os.environ["STREAMZ_SHARD_DISCOVERY"] = old
    log(f"discovery_scan: sharded {labels[0]}\n  single  {labels[1]}")
    check(labels[0] == labels[1], "discovery_scan")

    # The CLI's automatic data mesh vs the same CLI run on one device, both
    # drawing the same PRNG keys.
    cli_labels = []
    for tag, kill in (("mesh", "1"), ("single", "0")):
        os.environ["STREAMZ_TPU_MESH"] = kill
        meshmod._ACTIVE[0] = meshmod._UNSET  # rebuild under the new switch
        drivers._key_counter[0] = 0
        try:
            _, got, spy = run_cli_discovery(
                os.path.join(workdir, tag), n_speakers=8,
                clips_per_speaker=4, seconds=5.0)
            m = spy["kw"].get("mesh")
            log(f"cli discovery ({tag}): mesh "
                f"{None if m is None else m.devices.size} devices")
            check((m is not None and m.devices.size == 4) == (tag == "mesh"),
                  f"cli {tag}: mesh {m}")
            cli_labels.append(got)
        finally:
            os.environ.pop("STREAMZ_TPU_MESH", None)
    from streamz_tpu.runtime import autotune

    log("discovery scan chosen for the mesh: " + str({
        k: v for k, v in autotune._memory.items()
        if k.startswith("discovery_scan_")}))
    log(f"cli labels: mesh {cli_labels[0]}\n  single {cli_labels[1]}")
    check(cli_labels[0] == cli_labels[1], "cli discovery labels")

    if devs[0].platform == "gpu":  # the CPU rehearsal has no memory stats
        used = [d.memory_stats()["peak_bytes_in_use"] for d in devs]
        log(f"peak bytes in use per device: {used}")
        check(all(u > 0 for u in used), used)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); nothing "
              "was run", file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) != want:
        print(f"chip_smoke: needs exactly {want} GPU(s), JAX sees "
              f"{len(devs)}", file=sys.stderr)
        return 2

    with tempfile.TemporaryDirectory(prefix="streamz_smoke_") as tmp:
        if args.four:
            phases = [("a. device", phase_device),
                      ("f. four devices", lambda: four_devices(tmp))]
        else:
            phases = [
                ("a. device", phase_device),
                ("b. frontend", phase_frontend),
                ("c. classifier", phase_classifier),
                ("d. cli", lambda: phase_cli(os.path.join(tmp, "cli"))),
                ("e. serving", lambda: phase_serving(serving_model())),
            ]
        for name, fn in phases:
            log(f"== phase {name}")
            t0 = time.perf_counter()
            fn()
            log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
