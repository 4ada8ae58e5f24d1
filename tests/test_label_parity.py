"""Quantified 1-vs-8-device label-parity contract for the discovery loop.

``app/device_loop.py`` documents that the sharded scan's labels match the
single-device scan "up to floating-point near-ties" (the psum's reduction
order differs from the single-device sum).  This property test runs
RANDOMIZED corpora — including clusters
deliberately placed close enough to produce small cosine margins — on
1 vs 8 devices and pins the bounded claim:

    every label divergence's FIRST flip coincides with a decision margin
    below EPS (the argmax gap between the top two centroid sims, or the
    distance of the best sim to the acceptance threshold),

where the margin is recomputed in float64 by replaying the single-device
run's own embeddings through the loop's exact decision rule
(cosine-vs-running-sums, <20-id 0.7 relaxation, burn-in/new-class rules —
``app/device_loop.py:_file_body``).  The observed flip rate and minimum
flip margin are printed.
"""

import numpy as np
import pytest

from streamz_tpu.app.incremental import run_incremental
from streamz_tpu.nn import drivers
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.parallel import comm

EPS = 1e-3        # the documented near-tie band
BURN = 2
CONF = 0.6
N_SEEDS = 8


def _random_corpus(rng, n_files=24, dim=60, windows=8):
    """Clusters at three separations: far, mid, and a NEAR-TIE pair whose
    centers differ by a small random perturbation — files drawn from the
    near pair produce top-2 sims separated by ~the perturbation scale,
    exercising the regime the contract is about."""
    base = rng.normal(size=(3, dim)).astype(np.float32) * 2.0
    # Two near pairs at different tightness (cosine gaps ~5e-5 and ~5e-7)
    # so the margin distribution actually enters the near-tie band.
    near = base[2] + rng.normal(0, 0.02, size=(dim,)).astype(np.float32)
    near2 = base[1] + rng.normal(0, 0.002, size=(dim,)).astype(np.float32)
    centers = np.stack([base[0], base[1], base[2], near, near2])
    files, fm = [], {}
    for i in range(n_files):
        c = int(rng.integers(0, len(centers)))
        wins = (
            centers[c] + rng.normal(0, 0.25, size=(windows, dim))
        ).astype(np.float32)
        files.append((f"clip_{i}.wav", None))
        fm[f"clip_{i}.wav"] = wins
    return files, fm


def _run(files, fm, mesh):
    drivers._key_counter[0] = 7777
    net = SpeakerNet.new(output=1, seed=0)
    fs = [tuple(f) for f in files]
    res = run_incremental(
        net, fs, dict(fm), burn_in_limit=BURN, conf_threshold=CONF,
        epochs=1, show_progress=False, mesh=mesh,
    )
    labels = [c for _, c in fs]
    # Per-file embeddings in file order: speaker_features[sid] accumulates
    # embeddings in processing order, so popping front-to-front per label
    # stream reconstructs emb_i exactly.
    queues = {
        sid: list(v) for sid, v in res.speaker_features.items()
    }
    embs = [np.asarray(queues[sid].pop(0), np.float64) for sid in labels]
    return labels, embs


def _first_flip_margin(labels, embs):
    """Replay the device loop's decision rule in float64 over the
    single-device run's own (labels, embeddings) stream; return the margin
    at each file (np.inf where the decision is margin-free: burn-in or
    forced growth)."""
    h2 = len(embs[0])
    cap = 1 + len(labels)
    run_sum = np.zeros((cap, h2))
    run_cnt = np.zeros(cap)
    ns = 0
    margins = []
    for i, (sid, emb) in enumerate(zip(labels, embs)):
        burn = i < BURN
        if burn:
            margins.append(np.inf)  # always a fresh class: no decision
        else:
            thr = CONF
            seen = run_cnt > 0
            n_ids = int(seen.sum())
            dyn = 0.7 * thr if n_ids < 20 else thr
            if n_ids == 0:
                margins.append(np.inf)
            else:
                cent = run_sum[seen]
                ne = np.linalg.norm(emb)
                nc = np.linalg.norm(cent, axis=1)
                sims = (cent @ emb) / np.maximum(ne * nc, 1e-30)
                order = np.argsort(sims)[::-1]
                top = sims[order[0]]
                gap_thr = abs(top - dyn)
                gap_argmax = (
                    top - sims[order[1]] if len(sims) > 1 else np.inf
                )
                margins.append(min(gap_thr, gap_argmax))
        run_sum[sid] += emb
        run_cnt[sid] += 1
        ns = max(ns, sid + 1)
    return margins


@pytest.mark.slow
def test_label_flips_only_at_sub_eps_margins():
    mesh = comm.make_mesh(8)
    total_files = 0
    flips = []
    min_margin = np.inf
    for seed in range(N_SEEDS):
        rng = np.random.default_rng(1000 + seed)
        files, fm = _random_corpus(rng)
        labels_1, embs_1 = _run(files, fm, mesh=None)
        labels_8, _ = _run(files, fm, mesh=mesh)
        total_files += len(files)
        m = [x for x in _first_flip_margin(labels_1, embs_1)
             if np.isfinite(x)]
        if m:
            min_margin = min(min_margin, min(m))
        if labels_8 == labels_1:
            continue
        first = next(
            i for i, (a, b) in enumerate(zip(labels_1, labels_8)) if a != b
        )
        margins = _first_flip_margin(labels_1, embs_1)
        flips.append((seed, first, margins[first]))
        # The bounded claim: the FIRST divergence sits inside the near-tie
        # band.  (Later divergences cascade from the changed centroids and
        # carry no independent information.)
        assert margins[first] < EPS, (
            f"seed {seed}: labels diverged at file {first} with margin "
            f"{margins[first]:.2e} >= {EPS} — NOT a floating-point near-tie"
        )
    rate = len(flips) / total_files
    print(
        f"\nlabel-parity property: {len(flips)} first-flips over "
        f"{total_files} files ({rate:.4%}); min decision margin seen "
        f"{min_margin:.1e}; "
        + (
            "margins at flips: "
            + ", ".join(f"{m:.1e}" for _, _, m in flips)
            if flips else "no divergence observed"
        )
    )


def test_margin_replay_matches_decision_rule():
    """The float64 replay must agree with the actual loop's labels when
    margins are wide — otherwise the property above tests the wrong rule."""
    rng = np.random.default_rng(4242)
    # Wide-margin corpus: distinct far-apart clusters only.
    centers = rng.normal(size=(3, 60)).astype(np.float32) * 4.0
    files, fm = [], {}
    for i in range(15):
        c = i % 3
        fm[f"c_{i}.wav"] = (
            centers[c] + rng.normal(0, 0.1, size=(8, 60))
        ).astype(np.float32)
        files.append((f"c_{i}.wav", None))
    labels, embs = _run(files, fm, mesh=None)
    margins = _first_flip_margin(labels, embs)
    # Every post-burn-in matched file decision had a wide margin.
    finite = [m for m in margins if np.isfinite(m)]
    assert finite and min(finite) > EPS
