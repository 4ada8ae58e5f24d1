"""JAX/XLA MFCC frontend: batched and jitted, its DFT on the tensor cores.

A batched redesign of the reference's per-window scalar loop
(``streamz-rs/src/lib.rs:279-345``).  The hop being exactly half the window
lets the 800-point real DFT be computed from *non-overlapping* 400-sample
blocks with one GEMM and a shifted add (see
:func:`streamz_tpu.dsp.mel.dft_block_matrices`), so the whole frontend is:

    PCM [B, T] → blocks [B, nb, 400]
      → DFT GEMM (cuBLAS) → parity-signed shifted add → power [B, W, 401]
      → mel GEMM → log → DCT GEMM → [B, W, 20]
      → Δ/ΔΔ stencil + per-frame z-norm (elementwise, fused by XLA)

All shapes are static; ragged clip lengths are handled with a per-clip window
count and masking, with host-side bucketing of the padded length to bound
recompiles.  Golden-tested against :mod:`streamz_tpu.dsp.mfcc_ref`.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu import config
from streamz_tpu.dsp import mel as melmod
from streamz_tpu.precision import MATMUL

_BLOCK = config.HOP_SIZE  # 400


def _constants():
    ct, st = melmod.dft_block_matrices()
    fb = melmod.mel_filterbank()
    dct = melmod.dct2_matrix()
    # One fused [400, 2*401] projection: the bottom-role bases are just
    # parity-signed copies (Cb = (-1)^k Ct), so each block needs a single
    # cos|sin GEMM — half the FLOPs of projecting both roles.
    dft_top = np.concatenate([ct, st], axis=1)
    sign = melmod.bin_parity_sign()
    return (
        jnp.asarray(dft_top, jnp.float32),  # [400, 802]
        jnp.asarray(sign, jnp.float32),     # [401]
        jnp.asarray(fb.T, jnp.float32),     # [401, 26]
        jnp.asarray(dct.T, jnp.float32),    # [26, 20]
    )


def window_count(n_samples) -> jnp.ndarray:
    """Number of hop-400 windows in a clip (src/lib.rs:288-291)."""
    n = jnp.asarray(n_samples)
    return jnp.where(
        n >= config.WINDOW_SIZE,
        (n - config.WINDOW_SIZE) // config.HOP_SIZE + 1,
        0,
    )


def window_count_host(n_samples: int) -> int:
    """Host-side (pure Python) twin of :func:`window_count` for routing
    decisions that must not touch the device."""
    if n_samples < config.WINDOW_SIZE:
        return 0
    return (n_samples - config.WINDOW_SIZE) // config.HOP_SIZE + 1


def mfcc_base(pcm: jax.Array) -> jax.Array:
    """Base MFCCs for every candidate window. pcm: [B, T] f32 → [B, W, 20]
    where W = T//400 - 1.  No masking/deltas — the FLOP-heavy GEMM stage."""
    dft_top, sign, fb_t, dct_t = _constants()
    B, T = pcm.shape
    nb = T // _BLOCK
    nbins = config.N_FFT_BINS
    blocks = pcm[:, : nb * _BLOCK].reshape(B, nb, _BLOCK)

    parts = jnp.einsum("bnj,jk->bnk", blocks, dft_top, precision=MATMUL)
    cos_p = parts[..., :nbins]
    sin_p = parts[..., nbins:]

    # Window t = block_t (top role) + block_{t+1} (bottom role); the bottom
    # role is the parity-signed top projection.
    re = cos_p[:, :-1] + sign * cos_p[:, 1:]
    im = sin_p[:, :-1] + sign * sin_p[:, 1:]
    power = re * re + im * im  # [B, W, 401]

    mel_e = jnp.einsum("bwk,km->bwm", power, fb_t, precision=MATMUL)
    mel_log = jnp.log(jnp.maximum(mel_e, 1e-12))
    return jnp.einsum("bwm,mc->bwc", mel_log, dct_t, precision=MATMUL)


def deltas_and_norm(base: jax.Array, n_win: jax.Array) -> jax.Array:
    """Δ/ΔΔ stencil + per-frame z-norm with per-clip edge clamping.

    base: [B, W, 20]; n_win: [B] valid-window counts.  Returns [B, W, 60]
    with invalid frames zeroed.
    """
    B, W, C = base.shape
    idx = jnp.arange(W)[None, :]  # [1, W]
    valid = (idx < n_win[:, None])[..., None]  # [B, W, 1]
    last = jnp.maximum(n_win - 1, 0)[:, None, None]  # [B, 1, 1]

    def clamp_tail(x):
        # Replicate each clip's last valid frame into the padding region so a
        # plain edge-padded central difference is automatically edge-clamped
        # at the per-clip boundary (one [B, 1, C] gather instead of full
        # take_along_axis gathers).
        last_frame = jnp.take_along_axis(x, jnp.broadcast_to(last, (B, 1, C)), axis=1)
        return jnp.where(valid, x, last_frame)

    def central_diff(x):
        xp = jnp.concatenate([x[:, :1], x, x[:, -1:]], axis=1)
        return (xp[:, 2:] - xp[:, :-2]) / 2.0

    base_c = clamp_tail(base)
    d1 = clamp_tail(central_diff(base_c))
    d2 = central_diff(d1)
    feats = jnp.concatenate([base_c, d1, d2], axis=-1)  # [B, W, 60]

    mean = feats.mean(axis=-1, keepdims=True)
    var = ((feats - mean) ** 2).mean(axis=-1, keepdims=True)
    std = jnp.maximum(jnp.sqrt(var), 1e-6)
    feats = (feats - mean) / std

    return jnp.where(valid, feats, 0.0)


@partial(jax.jit, static_argnames=())
def mfcc_features(pcm: jax.Array, n_samples: jax.Array) -> jax.Array:
    """Full frontend: [B, T] f32 PCM + [B] lengths → [B, W, 60] features."""
    base = mfcc_base(pcm)
    return deltas_and_norm(base, window_count(n_samples))


# ---------------------------------------------------------------------------
# Host-side ragged-batch wrapper with length bucketing.
# ---------------------------------------------------------------------------


def _bucket_len(n: int) -> int:
    """Round a sample count up to a power-of-two number of 400-blocks."""
    return config.next_pow2(max(4, -(-n // _BLOCK))) * _BLOCK


def _to_f32(samples: np.ndarray) -> np.ndarray:
    samples = np.asarray(samples)
    if np.issubdtype(samples.dtype, np.integer):
        return samples.astype(np.float32) / 32767.0
    return samples.astype(np.float32)


def extract_features(samples: np.ndarray) -> np.ndarray:
    """Single clip → [n_windows, 60] float32 (device-computed)."""
    return extract_features_batch([samples])[0]


class DeviceFeatureStore:
    """Device-resident frontend outputs, indexed for device-side reuse.

    :func:`extract_features_batch` computes features ON the device and
    fetches host copies (the feature-cache / eval contract, SURVEY §2.1).
    When handed a store it ALSO keeps the per-bucket device arrays alive and
    records where each clip's rows live, so downstream device consumers —
    the fused discovery loop (:mod:`streamz_tpu.app.device_loop`) — can
    assemble their batches with a device-side gather instead of re-uploading
    the same floats through the host (the reference's hot loop C consumes
    features straight from the in-process map with zero copies,
    ``streamz-rs/src/main.rs:750-835``).

    Bit-parity note: :func:`deltas_and_norm` zeroes every frame beyond a
    clip's window count, so a gathered row equals the host-packed
    (zero-padded) row bit-for-bit.

    Holding the store keeps every bucket's [B, W, 60] f32 features in device memory
    (~110 KB per 10 s clip); call :meth:`release` when the consumer is done.
    ``max_bytes`` bounds that residency: a bucket that would push the total
    over the cap is simply not registered — its clips miss and every
    consumer falls back to host packing for them, so a corpus too big for
    device memory degrades to host packing instead of running out of memory.  (On a sharded
    store the count is global bytes; per-device residency is 1/n_dev.)
    """

    def __init__(self, mesh=None, max_bytes: int | None = None):
        self.mesh = mesh
        self.max_bytes = max_bytes
        self._bytes = 0
        self._buckets: List[jax.Array] = []
        self._index = {}  # key -> (bucket_id, row, n_win)
        # host_pack_*: host→device feature bytes consumers moved to repair
        # store misses (scatter_rows) — lets tests/probes assert partial
        # gathers upload only the missing rows.  dropped_*: buckets refused
        # by the max_bytes cap (their clips miss and host-pack).
        self.stats = {
            "host_pack_bytes": 0, "host_pack_rows": 0,
            "dropped_buckets": 0, "dropped_bytes": 0,
        }

    def add_bucket(self, feats_dev, keys, n_wins) -> None:
        """Register one bucket's device output.  ``keys[row]`` identifies
        the clip in row ``row``; rows beyond ``len(keys)`` (mesh padding)
        carry no clip.  Over-budget buckets (``max_bytes``) are dropped:
        their clips miss and consumers host-pack them."""
        nb = int(getattr(feats_dev, "nbytes", 0) or 0)
        if self.max_bytes is not None and self._bytes + nb > self.max_bytes:
            self.stats["dropped_buckets"] += 1
            self.stats["dropped_bytes"] += nb
            return
        self._bytes += nb
        bid = len(self._buckets)
        self._buckets.append(feats_dev)
        for row, key in enumerate(keys):
            self._index[key] = (bid, row, int(n_wins[row]))

    def rekey(self, mapping) -> None:
        """Replace each key ``k`` by ``mapping[k]`` (e.g. clip index →
        file path, the discovery loop's key space)."""
        self._index = {
            mapping[k]: v for k, v in self._index.items() if k in mapping
        }

    def lookup(self, key):
        """``(bucket_id, row, n_win)`` for a clip, or None."""
        return self._index.get(key)

    def bucket(self, bid: int) -> jax.Array:
        return self._buckets[bid]

    def release(self) -> None:
        """Drop the device references (frees device memory; lookups miss afterwards,
        so consumers fall back to host-packed features)."""
        self._buckets = []
        self._index = {}
        self._bytes = 0

    def gather(
        self, keys, w_pad: int, *, mesh=None, rows_sharded: bool = False,
        n_rows: int | None = None,
    ):
        """All-or-nothing gather: the assembled window tensor when every key
        hits, else None (the caller host-packs the whole batch).  See
        :meth:`gather_partial` for the contract; this wrapper exists for
        callers without a per-row fallback path."""
        # Pre-check misses with the pure-Python index scan: running the
        # per-bucket gather programs and then discarding the assembled
        # tensor on a single miss would waste every dispatch (and possibly
        # a compile) on the all-or-nothing path.
        if any(self._index.get(k) is None for k in keys):
            return None
        wins, _ = self.gather_partial(
            keys, w_pad, mesh=mesh, rows_sharded=rows_sharded, n_rows=n_rows
        )
        return wins

    def gather_partial(
        self, keys, w_pad: int, *, mesh=None, rows_sharded: bool = False,
        n_rows: int | None = None,
    ):
        """Assemble an ``[n_rows, w_pad, feat]`` window tensor ON the device
        from the stored frontend outputs, row ``r`` holding ``keys[r]``'s
        windows — the device-side replacement for host zero-pack + upload.

        Returns ``(wins, missing)`` where ``missing`` is the list of
        ``(row, key)`` pairs not found in the store; their rows in ``wins``
        are left all-zero for the caller to fill via :meth:`scatter_rows`
        (host-packing ONLY the misses — one store-missed clip does not
        forfeit device residency for its whole chunk).
        ``wins`` is None when NO key hits (a full host pack is cheaper than
        scattering everything) — ``missing`` then lists every row.

        Hit rows are bit-identical to host zero-padded packing: valid frames
        are the frontend's own outputs, frames beyond each clip's window
        count are exact zeros (:func:`deltas_and_norm`), and rows beyond
        ``len(keys)`` stay all-zero.  With ``mesh`` the result is replicated
        (``rows_sharded=False`` — e.g. the fused discovery scan's in_spec)
        or sharded over the mesh axis on the row dim (``rows_sharded=True``
        — e.g. the bucketed embedding kernels, whose host path shards the
        clip axis); ``n_rows`` must then be a mesh multiple, exactly as
        :func:`streamz_tpu.parallel.mesh.pad_rows_to_mesh` would pad it.
        """
        hits = []     # (row, (bucket_id, src_row, n_win))
        missing = []  # (row, key)
        for row, key in enumerate(keys):
            h = self._index.get(key)
            if h is None:
                missing.append((row, key))
            else:
                hits.append((row, h))
        if not hits:
            return None, missing
        R = len(keys) if n_rows is None else int(n_rows)
        feat = int(self._buckets[hits[0][1][0]].shape[2])
        wins = jnp.zeros((R, w_pad, feat), jnp.float32)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            spec = (
                P(mesh.axis_names[0], None, None) if rows_sharded else P()
            )
            wins = jax.device_put(wins, NamedSharding(mesh, spec))
        groups: dict = {}
        for row, (bid, srow, _) in hits:
            groups.setdefault(bid, ([], []))
            groups[bid][0].append(row)
            groups[bid][1].append(srow)
        for bid, (dsts, srcs) in groups.items():
            bucket = self._buckets[bid]
            m_pad = config.next_pow2(len(dsts))
            # Pad the index arrays by REPEATING entry 0: the duplicate
            # scatter rewrites the same row with the same value, so the
            # result is order-independent and no write-off row is needed.
            dst = np.full((m_pad,), dsts[0], np.int32)
            dst[: len(dsts)] = dsts
            src = np.full((m_pad,), srcs[0], np.int32)
            src[: len(srcs)] = srcs
            prog = _gather_prog(
                int(bucket.shape[1]), w_pad, feat, m_pad, mesh, rows_sharded
            )
            wins = prog(wins, bucket, jnp.asarray(src), jnp.asarray(dst))
        return wins, missing

    def scatter_rows(
        self, wins, rows_host: np.ndarray, dst_rows, *, mesh=None,
        rows_sharded: bool = False,
    ):
        """Fill ``wins[dst_rows[j]] = rows_host[j]`` on the device — the
        miss-repair half of :meth:`gather_partial`.  ``rows_host`` is the
        host-packed ``[n_miss, w_pad, feat]`` windows of the missing clips
        only; every other row keeps its device-resident gathered content.
        Sharding of ``wins`` is preserved (same spec rules as gather).
        ``stats['host_pack_bytes']`` meters the unpadded ``rows_host.nbytes``
        — misses only; the dispatch itself may carry up to 2x that in
        duplicate rows from the pow2 program-variant padding."""
        n = len(dst_rows)
        if n == 0:
            return wins
        m_pad = config.next_pow2(n)
        dst = np.full((m_pad,), dst_rows[0], np.int32)
        dst[:n] = dst_rows
        # Meter BEFORE the pow2 padding below: the metric's contract is
        # "misses only" (what host packing genuinely owes), while the wire
        # payload of this one dispatch includes up to 2x duplicate rows
        # from the power-of-two program-variant bound.
        self.stats["host_pack_bytes"] += int(rows_host.nbytes)
        self.stats["host_pack_rows"] += n
        if m_pad > n:  # repeat row 0: duplicate writes of identical values
            rows_host = np.concatenate(
                [rows_host, np.repeat(rows_host[:1], m_pad - n, axis=0)]
            )
        prog = _scatter_prog(mesh, rows_sharded)
        return prog(wins, jnp.asarray(rows_host), jnp.asarray(dst))


@lru_cache(maxsize=128)
def _gather_prog(
    bucket_w: int, w_pad: int, feat: int, m_pad: int, mesh, rows_sharded: bool
):
    """One store bucket's contribution to a gathered window tensor
    (:meth:`DeviceFeatureStore.gather`).  ``wins`` is [R, w_pad, feat];
    ``bucket`` is a frontend output [B, bucket_w, feat] whose frames beyond
    each clip's window count are exact zeros, so slicing/padding the window
    axis to ``w_pad`` (callers guarantee w_pad >= every gathered clip's
    window count) reproduces host zero-packing bit-for-bit."""

    def g(wins, bucket, src, dst):
        rows = bucket[src]  # [m_pad, bucket_w, feat]
        w = min(bucket_w, w_pad)
        rows = rows[:, :w]
        if w < w_pad:
            rows = jnp.pad(rows, ((0, 0), (0, w_pad - w), (0, 0)))
        return wins.at[dst].set(rows)

    if mesh is None:
        return jax.jit(g)
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(mesh.axis_names[0], None, None) if rows_sharded else P()
    return jax.jit(g, out_shardings=NamedSharding(mesh, spec))


@lru_cache(maxsize=32)
def _scatter_prog(mesh, rows_sharded: bool):
    """Jitted miss-repair scatter for :meth:`DeviceFeatureStore.scatter_rows`
    — shapes vary per call (jit retraces per shape), sharding is the cache
    key.  Duplicate ``dst`` entries (index padding) write identical values,
    so the scatter stays order-independent."""

    def s(wins, rows_data, dst):
        return wins.at[dst].set(rows_data)

    if mesh is None:
        return jax.jit(s)
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(mesh.axis_names[0], None, None) if rows_sharded else P()
    return jax.jit(s, out_shardings=NamedSharding(mesh, spec))


def extract_features_batch(
    clips: Sequence[np.ndarray], mesh=None,
    store: "DeviceFeatureStore | None" = None,
) -> List[np.ndarray]:
    """Many ragged clips → list of [n_windows_i, 60] arrays.

    Clips are grouped by padded-length bucket and each group runs as one
    batched device call — the device replacement for the reference's rayon
    fan-out over files (src/main.rs:500-508).

    With ``mesh`` (a 1-D ``"data"`` mesh), each bucket's clip axis is
    zero-padded to the mesh size and the frontend runs under ``shard_map``
    with the clip axis sharded, with device-count-invariant results (the
    frontend is elementwise per clip).  Very long clips route through the
    PCM-halo window-sharded frontend instead.

    With ``store`` (a :class:`DeviceFeatureStore`) each bucket's device
    output is registered under the clip's position in ``clips`` before the
    host fetch, so device consumers can reuse it without re-uploading.
    Long clips taking the PCM-sharded route are not stored (host arrays) —
    store consumers fall back per miss.
    """
    if not clips:
        return []
    f32 = [_to_f32(c) for c in clips]
    out: List[np.ndarray] = [None] * len(clips)  # type: ignore[list-item]

    shard_long = mesh is not None and mesh.devices.size > 1
    if shard_long:
        # A clip long enough to dwarf the batch runs through the PCM-halo
        # sharded frontend instead: all devices cooperate on its window
        # axis rather than idling on this bucket's padding.
        from streamz_tpu.parallel.window_parallel import (
            LONG_CLIP_WINDOW_THRESHOLD,
            mfcc_features_pcm_sharded,
        )

    buckets: dict[int, list[int]] = {}
    for i, c in enumerate(f32):
        if shard_long:
            if window_count_host(len(c)) >= LONG_CLIP_WINDOW_THRESHOLD:
                out[i] = mfcc_features_pcm_sharded(c, mesh)
                continue
        buckets.setdefault(_bucket_len(len(c)), []).append(i)
    for tlen, idxs in buckets.items():
        batch = np.zeros((len(idxs), tlen), np.float32)
        lens = np.zeros((len(idxs),), np.int32)
        for row, i in enumerate(idxs):
            batch[row, : len(f32[i])] = f32[i]
            lens[row] = len(f32[i])
        if mesh is not None:
            from streamz_tpu.parallel.mesh import (
                fetch,
                pad_rows_to_mesh,
                put_batch_sharded,
            )

            _, (batch_p, lens_p) = pad_rows_to_mesh(mesh, batch, lens)
            batch_d, lens_d = put_batch_sharded(mesh, batch_p, lens_p)
            feats_dev = sharded_frontend(mesh)(batch_d, lens_d)
            feats = fetch(feats_dev)
        else:
            feats_dev = mfcc_features(jnp.asarray(batch), jnp.asarray(lens))
            feats = np.asarray(feats_dev)
        # Host arithmetic, NOT the device twin: window_count(lens) would
        # add a blocking upload+compute+fetch round trip per bucket just
        # to evaluate (n-800)//400+1 on a tiny int vector.
        n_wins = np.asarray([window_count_host(int(n)) for n in lens],
                            np.int32)
        if store is not None:
            store.add_bucket(feats_dev, list(idxs), n_wins)
        for row, i in enumerate(idxs):
            out[i] = feats[row, : int(n_wins[row])].copy()
    return out


@lru_cache(maxsize=32)
def sharded_frontend(mesh):
    """The frontend wrapped in ``shard_map`` with the clip axis sharded over
    the mesh (each shard runs the frontend on its ``B/n_dev`` clips).
    Cached per mesh so repeat calls reuse the compiled program."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    return jax.jit(
        jax.shard_map(
            mfcc_features,
            mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=P(axis),
            check_vma=False,
        )
    )
