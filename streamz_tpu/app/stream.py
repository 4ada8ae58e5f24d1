"""Real streaming mode: hop-400 chunked live speaker identification.

Upgrades the reference's stub example (``streamz-rs/examples/live_stream.rs:1-9``,
which only prints that mic streaming is disabled) into a working capability:
PCM arrives in arbitrary-size chunks; features, forward passes and vote sums
are maintained *incrementally* on device, and the rolling identification is
available at any time with ``identify_speaker_with_threshold`` semantics
(``src/lib.rs:1307-1343``: confidence = best vote sum / window count).

Design (static shapes):

- The hop (400) being half the window (800) means every new 400-sample block
  yields exactly one new analysis window — the same split-block GEMM
  formulation as :func:`streamz_tpu.dsp.mfcc.mfcc_base`, so the streaming
  step stays a GEMM.  The carry holds the previous block's DFT
  projection, so no PCM is ever re-projected.
- The Δ/ΔΔ stencil reaches 2 base frames ahead (``src/lib.rs:212-228``), so a
  frame is *finalized* (features emitted, vote counted) once 2 further frames
  exist — a fixed 2-frame (800-sample, ~18 ms) lookahead latency.  The carry
  keeps the last 4 base MFCC frames.
- ``finalize()`` flushes the 2 pending frames with the end-of-clip edge
  clamp, which makes the streamed feature sequence **identical to the
  offline frontend** on the same PCM (tested in
  ``tests/test_streaming.py``) — streaming is a latency mode, not an
  approximation.
- Each step processes up to ``block_batch`` blocks in ONE fixed-shape
  dispatch (padding + count masking), so chunk-size jitter never recompiles.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu import config
from streamz_tpu.nn.model import forward


def _make_stream_step(capacity: int, k: int):
    """Jitted streaming step for ``k`` blocks per dispatch.

    carry = (proj [802], has_prev, tail [4, 20], n_base, votes [capacity],
    votes_comp [capacity], count); returns (carry', feats [k, 60],
    valid [k]).  ``count`` is int32 (exact forever) and the vote sums use
    Kahan-compensated f32 accumulation — a plain f32 += stops absorbing
    new windows once the sums reach ~2^24x the increment (~42 h of
    continuous audio), silently freezing a long-running live stream's
    confidence.
    """
    from streamz_tpu.dsp.mfcc import _constants
    from streamz_tpu.precision import MATMUL

    dft_top, sign, fb_t, dct_t = _constants()
    nbins = config.N_FFT_BINS

    def step(params, carry, blocks, n_new, num_speakers):
        proj, has_prev, tail, n_base, votes, vcomp, count = carry

        proj_new = jnp.dot(blocks, dft_top, precision=MATMUL)  # [k, 802]
        all_proj = jnp.concatenate([proj[None], proj_new])  # [k+1, 802]
        cos_p, sin_p = all_proj[:, :nbins], all_proj[:, nbins:]
        re = cos_p[:-1] + sign * cos_p[1:]
        im = sin_p[:-1] + sign * sin_p[1:]
        power = re * re + im * im  # [k, 401]
        mel_log = jnp.log(
            jnp.maximum(jnp.dot(power, fb_t, precision=MATMUL), 1e-12)
        )
        new_base = jnp.dot(mel_log, dct_t, precision=MATMUL)  # [k, 20]

        # Frame j pairs all_proj[j] with all_proj[j+1]; without a previous
        # block the j=0 pair is bogus, so the first valid frame starts at
        # ``start``.  m = number of genuinely new base frames.
        start = jnp.where(has_prev > 0, 0, 1)
        m = jnp.maximum(n_new - start, 0)

        # Left-align the valid new frames, then stitch them after the tail:
        # seq position p holds global frame g = n_base - 4 + p.
        rolled = new_base[(jnp.arange(k) + start) % k]
        seq = jnp.concatenate([tail, rolled])  # [4 + k, 20]

        # Frames finalized this step: g in [n_base - 2, n_base + m - 2),
        # i.e. the static seq window [2, 2 + k) with a validity mask.
        g = n_base - 2 + jnp.arange(k)
        valid = (g >= 0) & (g < n_base + m - 2)

        def b_at(x):  # edge-clamped base frame at global index x
            pos = jnp.clip(x, 0, n_base + m - 1) - (n_base - 4)
            return seq[jnp.clip(pos, 0, k + 3)]

        base_own = b_at(g)

        def d1_at(x):  # Δ at global x, bottom-clamped like the offline path
            xc = jnp.maximum(x, 0)
            return (b_at(xc + 1) - b_at(xc - 1)) / 2.0

        d1 = d1_at(g)
        d2 = (d1_at(g + 1) - d1_at(g - 1)) / 2.0
        feats = jnp.concatenate([base_own, d1, d2], axis=-1)

        mean = feats.mean(axis=-1, keepdims=True)
        var = ((feats - mean) ** 2).mean(axis=-1, keepdims=True)
        std = jnp.maximum(jnp.sqrt(var), 1e-6)
        feats = jnp.where(valid[:, None], (feats - mean) / std, 0.0)

        probs = forward(params, feats, num_speakers)
        vmask = valid.astype(jnp.float32)
        step_sum = (probs * vmask[:, None]).sum(axis=0)
        # Kahan step: add the (compensation-corrected) increment, carry the
        # rounding residue forward.
        y = step_sum - vcomp
        t = votes + y
        vcomp = (t - votes) - y
        votes = t
        count = count + valid.sum().astype(jnp.int32)

        new_tail = jax.lax.dynamic_slice(seq, (m, 0), (4, seq.shape[1]))
        last_proj = all_proj[jnp.clip(n_new, 0, k)]
        carry_out = (
            last_proj,
            jnp.maximum(has_prev, (n_new > 0).astype(jnp.float32)),
            new_tail,
            n_base + m,
            votes,
            vcomp,
            count,
        )
        return carry_out, feats, vmask

    return jax.jit(step)


def _make_finalize_step(capacity: int):
    """Flush the <=2 pending frames with the end-of-stream edge clamp."""

    def fin(params, carry, num_speakers):
        _, _, tail, n_base, votes, vcomp, count = carry
        n_t = n_base  # total base frames in the stream

        g = n_t - 2 + jnp.arange(2)
        valid = (g >= 0) & (g < n_t)

        def b_at(x):  # tail[i] holds global frame n_t - 4 + i
            pos = jnp.clip(x, 0, n_t - 1) - (n_t - 4)
            return tail[jnp.clip(pos, 0, 3)]

        base_own = b_at(g)
        d1 = (b_at(g + 1) - b_at(g - 1)) / 2.0
        # Mirror the offline pipeline exactly: Δ is edge-clamped *before* ΔΔ
        # (clamp_tail between the two stencils in deltas_and_norm), so ΔΔ at
        # the last frames uses Δ(clip(g±1, 0, n_t-1)).
        def d1_at(x):
            xc = jnp.clip(x, 0, n_t - 1)
            return (b_at(xc + 1) - b_at(xc - 1)) / 2.0

        d2 = (d1_at(g + 1) - d1_at(g - 1)) / 2.0
        feats = jnp.concatenate([base_own, d1, d2], axis=-1)
        mean = feats.mean(axis=-1, keepdims=True)
        var = ((feats - mean) ** 2).mean(axis=-1, keepdims=True)
        std = jnp.maximum(jnp.sqrt(var), 1e-6)
        feats = jnp.where(valid[:, None], (feats - mean) / std, 0.0)

        probs = forward(params, feats, num_speakers)
        vmask = valid.astype(jnp.float32)
        votes = votes + ((probs * vmask[:, None]).sum(axis=0) - vcomp)
        count = count + valid.sum().astype(jnp.int32)
        return votes, count, feats, vmask

    return jax.jit(fin)


@lru_cache(maxsize=16)
def _programs(capacity: int, k: int):
    return _make_stream_step(capacity, k), _make_finalize_step(capacity)


def check_capacity_growth(old_cap: int, new_cap: int) -> int:
    """Validate a hot-swap capacity change; returns the pad width (>= 0).

    Shared swap rule for the single-stream and fleet identifiers: growth
    only appends output columns (src/lib.rs:797-821), so speaker ids stay
    stable; a shrink would drop accumulated votes and is refused.
    """
    if new_cap < old_cap:
        raise ValueError(
            f"model capacity shrank ({old_cap} -> {new_cap}); votes "
            "for existing speakers would be dropped"
        )
    return new_cap - old_cap


def grow_vote_carry(carry, pad: int, batched: bool = False):
    """Zero-pad the capacity-wide carry slots (4 = vote sums, 5 = their
    Kahan compensation) to a grown capacity; all other slots pass through.
    ``batched`` pads the trailing axis of fleet-shaped ``[S, cap]`` slots."""
    widths = ((0, 0), (0, pad)) if batched else (0, pad)
    return carry[:4] + (
        jnp.pad(carry[4], widths),
        jnp.pad(carry[5], widths),
        carry[6],
    )


def vote_verdict(
    votes: np.ndarray, count: float, output_size: int, threshold: float
) -> Optional[Tuple[int, float]]:
    """``identify_speaker_with_threshold`` semantics on accumulated vote
    sums (src/lib.rs:1307-1343): ``None`` for single-speaker nets, empty
    streams, or below-threshold confidence.  Shared by the single-stream
    and multi-stream identifiers."""
    if output_size <= 1 or count <= 0:
        return None  # src/lib.rs:1311-1315
    sums = votes[:output_size]
    best = int(sums.argmax())
    conf = float(sums[best]) / count
    if conf < threshold:
        return None
    return best, conf


class StreamingIdentifier:
    """Hop-400 chunked live identification over a PCM stream.

    >>> sid = StreamingIdentifier(net, threshold=0.5)
    >>> for chunk in microphone():      # arbitrary chunk sizes
    ...     sid.feed(chunk)
    ...     print(sid.current())        # rolling (speaker, confidence)
    >>> sid.finalize()                  # exact offline-parity result
    """

    def __init__(self, net, threshold: float = config.DEFAULT_CONF_THRESHOLD,
                 block_batch: int = 16, collect_features: bool = False):
        self.net = net
        self.threshold = float(threshold)
        self.k = int(block_batch)
        self.collect_features = collect_features
        self.features: List[np.ndarray] = []
        self._rem = np.zeros((0,), np.float32)
        self._finalized = False
        cap = net.capacity
        self._step, self._fin = _programs(cap, self.k)
        self._carry = (
            jnp.zeros((2 * config.N_FFT_BINS,), jnp.float32),
            jnp.float32(0.0),
            jnp.zeros((4, config.MFCC_SIZE), jnp.float32),
            jnp.int32(0),
            jnp.zeros((cap,), jnp.float32),
            jnp.zeros((cap,), jnp.float32),
            jnp.int32(0),
        )

    # -- model hot-swap --------------------------------------------------------

    def update_model(self, net) -> None:
        """Swap in an updated model without dropping the stream.

        The serving counterpart of the app's incremental discovery: training
        grows the classifier while streams are live, and speaker ids are
        stable (growth only appends output columns —
        ``src/lib.rs:797-821``), so votes already accumulated keep their
        meaning.  Same-capacity swaps are free (params are an argument of
        every dispatch); capacity growth zero-pads the vote carries to the
        new width.  Frames already finalized were scored by the old model —
        inherent to any online update, not an approximation of this one.
        """
        if self._finalized:
            raise RuntimeError("stream already finalized")
        pad = check_capacity_growth(self.net.capacity, net.capacity)
        if pad:
            self._carry = grow_vote_carry(self._carry, pad)
            self._step, self._fin = _programs(net.capacity, self.k)
        self.net = net

    # -- feeding -------------------------------------------------------------

    def feed(self, pcm, encoding: Optional[str] = None) -> None:
        """Accept the next PCM chunk (i16, f32, or G.711 bytes with
        ``encoding='ulaw'``/``'alaw'`` — expanded to exact i16 on host;
        the batched multi-stream server ships the bytes to the device
        instead, see :mod:`streamz_tpu.app.serve`)."""
        if self._finalized:
            # RuntimeError, not assert: under python -O the assert would
            # vanish and a post-finalize feed would re-finalize the
            # already-flushed lookahead frames (finalize never advances
            # n_base), silently double-counting votes.
            raise RuntimeError("stream already finalized")
        from streamz_tpu.dsp.mfcc import _to_f32

        if encoding is not None:
            from streamz_tpu.io import g711

            if isinstance(pcm, (bytes, bytearray)):
                pcm = np.frombuffer(pcm, np.uint8)
            pcm = g711.decode(pcm, encoding)
        pcm = _to_f32(np.asarray(pcm))
        self._rem = np.concatenate([self._rem, pcm])
        block = config.HOP_SIZE
        while len(self._rem) >= block:
            n_blocks = min(len(self._rem) // block, self.k)
            take = n_blocks * block
            blocks = np.zeros((self.k, block), np.float32)
            blocks[:n_blocks] = self._rem[:take].reshape(n_blocks, block)
            self._rem = self._rem[take:]
            self._carry, feats, vmask = self._step(
                self.net.params,
                self._carry,
                jnp.asarray(blocks),
                jnp.int32(n_blocks),
                jnp.int32(self.net.num_speakers),
            )
            if self.collect_features:
                self._collect(feats, vmask)

    def _collect(self, feats, vmask) -> None:
        f = np.asarray(feats)
        m = np.asarray(vmask) > 0
        if m.any():
            self.features.append(f[m])

    # -- results -------------------------------------------------------------

    def _verdict(self, votes, count) -> Optional[Tuple[int, float]]:
        return vote_verdict(
            votes, count, self.net.output_size(), self.threshold
        )

    def current(self) -> Optional[Tuple[int, float]]:
        """Rolling identification over the frames finalized so far
        (``identify_speaker_with_threshold`` semantics)."""
        votes = np.asarray(self._carry[4])
        count = float(self._carry[6])
        return self._verdict(votes, count)

    def finalize(self) -> Optional[Tuple[int, float]]:
        """Flush the lookahead frames and return the final identification —
        identical to running the offline pipeline on the whole stream."""
        if not self._finalized:
            self._finalized = True
            votes, count, feats, vmask = self._fin(
                self.net.params, self._carry, jnp.int32(self.net.num_speakers)
            )
            self._carry = self._carry[:4] + (
                votes, jnp.zeros_like(votes), count,
            )
            if self.collect_features:
                self._collect(feats, vmask)
        return self.current()

    def streamed_features(self) -> np.ndarray:
        """All finalized feature frames (requires ``collect_features``)."""
        if not self.features:
            return np.zeros((0, config.FEATURE_SIZE), np.float32)
        return np.concatenate(self.features)
