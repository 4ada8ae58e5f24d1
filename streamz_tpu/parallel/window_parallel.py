"""Window-axis sharding for very long recordings — the MFCC analogue of
context/sequence parallelism (SURVEY.md §5.7).

The reference has no attention; its "long sequence" story is chunking audio
into i.i.d. 800-sample windows and aggregating per-clip statistics
(``streamz-rs/src/lib.rs:1285-1303`` vote sums, ``:1450-1471`` embedding
means).  The only cross-window coupling is the radius-1 Δ/ΔΔ stencil
(``src/lib.rs:212-228``) and the per-clip pooling — so a long clip shards its
*window axis* across devices, each device runs the forward on its shard,
and a single ``psum`` merges the vote sums / pooled-embedding statistics.

For the MFCC frontend itself the delta stencil at shard edges is handled by
giving each shard a small halo of PCM blocks (the BlockSpec-style overlap),
exchanged once with ``ppermute``: 2 blocks from the left neighbour
and 3 from the right cover both the window overlap (window ``w`` spans blocks
``w`` and ``w+1``) and the radius-2 Δ/ΔΔ dependency.  See
:func:`mfcc_features_pcm_sharded` and the fused
:func:`identify_speaker_pcm_sharded` / :func:`extract_embedding_pcm_sharded`
programs below.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from streamz_tpu import config
from streamz_tpu.nn.model import forward, forward_embedding
from streamz_tpu.parallel import comm
from streamz_tpu.parallel.mesh import pad_rows_to_mesh


@lru_cache(maxsize=8)
def make_sharded_vote_step(mesh: Mesh):
    """Vote-sum aggregation with windows sharded across chips.

    ``step(params, windows, valid, num_speakers) -> (prob_sums, count)``:
    the device-local softmax sums are psum-merged, reproducing
    ``identify_speaker``'s global sum (src/lib.rs:1290-1297) exactly.
    """

    axis = mesh.axis_names[0]  # "window", or the CLI's "data" mesh reused

    def _local(params, windows, valid, num_speakers):
        probs = forward(params, windows, num_speakers)  # [w_local, capacity]
        probs = probs * valid[:, None]
        sums = comm.psum(jnp.sum(probs, axis=0), axis)
        count = comm.psum(jnp.sum(valid), axis)
        return sums, count

    shard = partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(shard(_local))


@lru_cache(maxsize=8)
def make_sharded_embedding_step(mesh: Mesh):
    """Mean ReLU-h2 clip embedding with windows sharded across chips.

    Reproduces ``extract_embedding_from_features`` (src/lib.rs:1450-1471):
    psum of the per-shard embedding sums and window counts, then the global
    mean (L2 normalization stays on the host caller, matching the reference's
    separate ``normalize`` call sites).
    """

    axis = mesh.axis_names[0]  # "window", or the CLI's "data" mesh reused

    def _local(params, windows, valid):
        emb = forward_embedding(params, windows)  # [w_local, h2]
        emb = emb * valid[:, None]
        total = comm.psum(jnp.sum(emb, axis=0), axis)
        count = comm.psum(jnp.sum(valid), axis)
        return total / jnp.maximum(count, 1.0)

    shard = partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(shard(_local))


def make_window_mesh(n_devices=None) -> Mesh:
    return comm.make_mesh(n_devices, axis=comm.WINDOW_AXIS)


# A 10-minute 44.1 kHz clip is ~66k hop-400 windows; below ~16k windows the
# single-device forward is expected to beat paying the collective (not yet
# measured on a GPU mesh).  The
# app layers (incremental loop, identify voting, ingest) route clips at or
# above this many windows through the sharded programs here.
LONG_CLIP_WINDOW_THRESHOLD = 16384


# ---------------------------------------------------------------------------
# Host-level conveniences: pad a clip's window set to the mesh and run the
# sharded aggregations.
# ---------------------------------------------------------------------------


def _pad_to_mesh(windows, mesh: Mesh):
    """Ceil-to-mesh leading-axis padding + a valid-row mask.

    The padding itself is :func:`streamz_tpu.parallel.mesh.pad_rows_to_mesh`
    (one policy for the vote/embedding shards and the batch-sharded ingest);
    this wrapper only adds the float mask the masked reductions consume.
    An empty input keeps its feature width (so the forward GEMM shapes stay
    model-consistent) and yields an all-zero mask.
    """
    windows = np.asarray(windows, np.float32)
    if windows.ndim == 1:
        # A bare [F] vector is ONE window's features; an empty input takes
        # the model's feature width so the forward GEMM shapes stay
        # consistent (reshape(len, -1) would instead reinterpret [60] as
        # 60 one-feature windows and trace a garbage [60,1] GEMM).
        windows = (
            windows.reshape(1, -1)
            if windows.size
            else windows.reshape(0, config.FEATURE_SIZE)
        )
    n, (padded,) = pad_rows_to_mesh(mesh, windows)
    valid = (np.arange(len(padded)) < n).astype(np.float32)
    return padded, valid


def vote_sums_sharded(net, windows, mesh: Mesh):
    """Global softmax vote sums over mesh-sharded windows: the engine behind
    :func:`identify_speaker_sharded` and the ``mesh`` path of
    ``identify_speaker_with_threshold_feats``.  Returns a ``[num_speakers]``
    numpy array."""
    padded, valid = _pad_to_mesh(windows, mesh)
    step = make_sharded_vote_step(mesh)
    sums, _ = step(
        net.params, jnp.asarray(padded), jnp.asarray(valid),
        jnp.int32(net.num_speakers),
    )
    return np.asarray(sums)[: net.num_speakers]


def identify_speaker_sharded(net, windows, mesh: Mesh) -> int:
    """``identify_speaker`` with the window axis sharded across the mesh."""
    if len(windows) == 0 or net.num_speakers == 0:
        # num_speakers == 0 is a loadable checkpoint state (model.py): the
        # vote sums are then empty and argmax would raise where the
        # unsharded identify_speaker returns 0 (src/lib.rs:1302
        # unwrap_or(0)).
        return 0
    return int(vote_sums_sharded(net, windows, mesh).argmax())


def extract_embedding_sharded(net, windows, mesh: Mesh):
    """Mean ReLU-h2 clip embedding sharded over the mesh, L2-normalized
    (the ``extract_embedding_from_features`` call-site contract)."""
    from streamz_tpu.infer.embed import normalize

    if len(windows) == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    padded, valid = _pad_to_mesh(windows, mesh)
    step = make_sharded_embedding_step(mesh)
    emb = step(net.params, jnp.asarray(padded), jnp.asarray(valid))
    return normalize(np.asarray(emb))


# ---------------------------------------------------------------------------
# PCM-halo sharded frontend: the MFCC frontend itself SPMD over the mesh.
#
# A long clip's PCM block axis (400-sample blocks, ``config.HOP_SIZE``) is
# sharded across the mesh; one ``ppermute`` exchanges the halo blocks each
# shard needs from its neighbours, and every device runs the same block-GEMM
# frontend as :func:`streamz_tpu.dsp.mfcc.mfcc_base` on its slice.  Window
# ``w`` spans blocks ``w`` and ``w+1`` (``streamz-rs/src/lib.rs:288-318``) and
# the Δ/ΔΔ stencil reaches 2 base frames to each side
# (``src/lib.rs:212-228``), so a shard owning frames ``[s, s+wl)`` needs
# blocks ``[s-2, s+wl+3)``: its own ``wl`` plus a 2-block left halo and a
# 3-block right halo.  The reference's per-clip edge clamping is reproduced
# with clamped gathers into the extended frame range, which makes the sharded
# output *bit-equal* to the unsharded frontend.
# ---------------------------------------------------------------------------


def _frontend_local_factory(axis: str, n_dev: int, wl: int):
    """Device-local frontend on ``wl`` owned PCM blocks (+ ppermute halo).

    Returns a function ``(pcm_local[wl*400], n_win[]) -> (feats[wl, 60],
    valid[wl])`` computing this shard's frames ``g in [d*wl, (d+1)*wl)``.
    """
    from streamz_tpu.dsp.mfcc import _constants
    from streamz_tpu.precision import MATMUL

    dft_top, sign, fb_t, dct_t = _constants()
    nbins = config.N_FFT_BINS
    block = config.HOP_SIZE

    def _local(pcm_local, n_win):
        d = jax.lax.axis_index(axis)
        blocks = pcm_local.reshape(wl, block)
        if n_dev > 1:
            # Single bidirectional halo exchange.  The cyclic wrap
            # at the global edges delivers garbage blocks, but the clamped
            # gathers below never source frames computed from them.
            fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
            left = jax.lax.ppermute(blocks[-2:], axis, fwd)
            right = jax.lax.ppermute(blocks[:3], axis, bwd)
        else:
            left = jnp.zeros((2, block), pcm_local.dtype)
            right = jnp.zeros((3, block), pcm_local.dtype)
        ext = jnp.concatenate([left, blocks, right], axis=0)  # blocks s-2..s+wl+2

        # Same GEMM pipeline as mfcc_base (parity-sign trick included).
        parts = jnp.dot(ext, dft_top, precision=MATMUL)
        cos_p, sin_p = parts[:, :nbins], parts[:, nbins:]
        re = cos_p[:-1] + sign * cos_p[1:]
        im = sin_p[:-1] + sign * sin_p[1:]
        power = re * re + im * im  # [wl+4, 401]
        mel_log = jnp.log(
            jnp.maximum(jnp.dot(power, fb_t, precision=MATMUL), 1e-12)
        )
        base_ext = jnp.dot(mel_log, dct_t, precision=MATMUL)  # frames s-2..s+wl+1

        # Edge-clamped base frames B[g] = base[clip(g, 0, n_win-1)] — exactly
        # the unsharded clamp_tail + edge-replicated central_diff semantics.
        s = d * wl
        top = jnp.maximum(n_win - 1, 0)
        g_ext = s - 2 + jnp.arange(wl + 4)
        src = jnp.clip(g_ext, 0, top)
        b_ext = base_ext[jnp.clip(src - (s - 2), 0, wl + 3)]
        d1_raw = (b_ext[2:] - b_ext[:-2]) / 2.0  # index j -> frame g = s-1+j

        g_own = s + jnp.arange(wl)

        def d1c(h):
            loc = jnp.clip(jnp.clip(h, 0, top) - (s - 1), 0, wl + 1)
            return d1_raw[loc]

        base_own = b_ext[2 : wl + 2]
        d1_own = d1c(g_own)
        d2_own = (d1c(g_own + 1) - d1c(g_own - 1)) / 2.0
        feats = jnp.concatenate([base_own, d1_own, d2_own], axis=-1)

        mean = feats.mean(axis=-1, keepdims=True)
        var = ((feats - mean) ** 2).mean(axis=-1, keepdims=True)
        std = jnp.maximum(jnp.sqrt(var), 1e-6)
        feats = (feats - mean) / std

        valid = g_own < n_win
        return jnp.where(valid[:, None], feats, 0.0), valid.astype(jnp.float32)

    return _local


@lru_cache(maxsize=32)
def _make_sharded_frontend_programs(mesh: Mesh, wl: int):
    """The three jitted SPMD programs for ``wl`` blocks per device:
    features (sharded out), vote sums (psum), mean embedding (psum)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    local = _frontend_local_factory(axis, n_dev, wl)

    def _feats(pcm_local, n_win):
        return local(pcm_local, n_win)[0]

    def _votes(params, pcm_local, n_win, num_speakers):
        feats, valid = local(pcm_local, n_win)
        probs = forward(params, feats, num_speakers) * valid[:, None]
        sums = comm.psum(probs.sum(axis=0), axis)
        return sums

    def _embed(params, pcm_local, n_win):
        feats, valid = local(pcm_local, n_win)
        emb = forward_embedding(params, feats) * valid[:, None]
        total = comm.psum(emb.sum(axis=0), axis)
        count = comm.psum(valid.sum(), axis)
        return total / jnp.maximum(count, 1.0)

    shard = partial(jax.shard_map, mesh=mesh, check_vma=False)
    feats_fn = jax.jit(
        shard(_feats, in_specs=(P(axis), P()), out_specs=P(axis))
    )
    votes_fn = jax.jit(
        shard(_votes, in_specs=(P(), P(axis), P(), P()), out_specs=P())
    )
    embed_fn = jax.jit(
        shard(_embed, in_specs=(P(), P(axis), P()), out_specs=P())
    )
    return feats_fn, votes_fn, embed_fn


def _shard_pcm(samples, mesh: Mesh):
    """Pad a clip to a whole number of power-of-two-sized block shards and
    device_put it block-sharded across the mesh.  Returns
    ``(pcm_sharded, n_win_host, wl)``; ``wl`` is bucketed to bound
    recompiles across clip lengths."""
    from streamz_tpu.dsp.mfcc import _to_f32

    f32 = _to_f32(np.asarray(samples))
    n = len(f32)
    n_win = (n - config.WINDOW_SIZE) // config.HOP_SIZE + 1 if n >= config.WINDOW_SIZE else 0
    n_dev = mesh.devices.size
    # Each shard needs >= 3 blocks (the right-halo depth); n_win + 1 blocks
    # must fit so the last window's second half exists.
    wl = 4
    while n_dev * wl < n_win + 1:
        wl *= 2
    pcm = np.zeros((n_dev * wl * config.HOP_SIZE,), np.float32)
    # The buffer holds n_win+1 blocks — enough for every window — but the
    # clip's trailing partial block may push n past it; those samples never
    # feed any window, so copy only what fits.
    m = min(n, pcm.size)
    pcm[:m] = f32[:m]
    pcm_s = jax.device_put(pcm, NamedSharding(mesh, P(mesh.axis_names[0])))
    return pcm_s, n_win, wl


def mfcc_features_pcm_sharded(samples, mesh: Mesh):
    """The full MFCC+Δ+ΔΔ frontend with the PCM block axis sharded across
    the mesh — bit-equal to :func:`streamz_tpu.dsp.mfcc.extract_features`.

    Returns ``[n_windows, 60]`` float32 (host)."""
    pcm_s, n_win, wl = _shard_pcm(samples, mesh)
    if n_win == 0:
        return np.zeros((0, config.FEATURE_SIZE), np.float32)
    feats_fn, _, _ = _make_sharded_frontend_programs(mesh, wl)
    feats = feats_fn(pcm_s, jnp.int32(n_win))
    from streamz_tpu.parallel.mesh import fetch

    return fetch(feats)[:n_win].copy()


def identify_speaker_pcm_sharded(net, samples, mesh: Mesh) -> int:
    """``identify_speaker`` (src/lib.rs:1285-1303) as ONE fused SPMD program:
    sharded frontend → forward → psum vote sums."""
    if net.num_speakers == 0:
        return 0  # empty vote sums: argmax would raise (see the feats twin)
    pcm_s, n_win, wl = _shard_pcm(samples, mesh)
    if n_win == 0:
        return 0  # src/lib.rs:1302 unwrap_or(0)
    _, votes_fn, _ = _make_sharded_frontend_programs(mesh, wl)
    sums = votes_fn(
        net.params, pcm_s, jnp.int32(n_win), jnp.int32(net.num_speakers)
    )
    return int(np.asarray(sums)[: net.num_speakers].argmax())


def extract_embedding_pcm_sharded(net, samples, mesh: Mesh):
    """Mean ReLU-h2 clip embedding (src/lib.rs:1450-1471) as ONE fused SPMD
    program over the sharded frontend, L2-normalized on the host."""
    from streamz_tpu.infer.embed import normalize

    pcm_s, n_win, wl = _shard_pcm(samples, mesh)
    if n_win == 0:
        return np.zeros((net.embedding_size(),), np.float32)
    _, _, embed_fn = _make_sharded_frontend_programs(mesh, wl)
    emb = embed_fn(net.params, pcm_s, jnp.int32(n_win))
    return normalize(np.asarray(emb))
