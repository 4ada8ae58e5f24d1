"""Mel filterbank and DCT-II constants for the MFCC frontend.

The reference builds its filterbank with the ``mel_filter`` crate (a librosa
port) using ``mel(44100, 800, Some(26), None, None, false, NormalizationFactor::One)``
(``streamz-rs/src/lib.rs:240-248``): Slaney mel scale (htk=false), default
fmin=0 / fmax=sr/2, Slaney area normalization.  The DCT is rustdct's plain
unnormalized DCT-II (``src/lib.rs:251-252``, ``:313``):
``X_k = sum_n x_n * cos(pi/N * (n + 1/2) * k)``.

Everything here is host-side constant construction (float64, cast to f32 at
the device boundary).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from streamz_tpu import config


def hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freqs - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freqs >= min_log_hz
    mels = np.where(
        log_t,
        min_log_mel + np.log(np.maximum(freqs, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(
        log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@lru_cache(maxsize=8)
def mel_filterbank(
    sr: int = config.DEFAULT_SAMPLE_RATE,
    n_fft: int = config.WINDOW_SIZE,
    n_mels: int = config.N_MELS,
) -> np.ndarray:
    """librosa-compatible triangular filterbank [n_mels, 1 + n_fft//2]."""
    fmin, fmax = 0.0, sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization (NormalizationFactor::One).
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights


@lru_cache(maxsize=8)
def dct2_matrix(n: int = config.N_MELS, keep: int = config.MFCC_SIZE) -> np.ndarray:
    """Unnormalized DCT-II matrix [keep, n] (rustdct convention)."""
    k = np.arange(keep)[:, None]
    m = np.arange(n)[None, :]
    return np.cos(np.pi / n * (m + 0.5) * k)


@lru_cache(maxsize=8)
def dft_block_matrices(window: int = config.WINDOW_SIZE):
    """Real-DFT basis matrices for the split-block GEMM formulation.

    A hop of window/2 means every analysis window is the concatenation of two
    *non-overlapping* half-window blocks, so the per-window DFT can be
    computed from per-block GEMMs without duplicating PCM:

        frame_t = [block_t ; block_{t+1}]                      (b = window/2)
        Re[t,k] = block_t · Ct[:,k] + block_{t+1} · Cb[:,k]
        Im[t,k] = block_t · St[:,k] + block_{t+1} · Sb[:,k]

    with ``Ct[j,k] = cos(2*pi*k*j/W)``, ``Cb[j,k] = cos(2*pi*k*(j+b)/W)`` and
    the negated-sine equivalents.  This keeps the FLOP-heavy stage a pure
    matmul (the batched replacement for the reference's per-window rustfft
    call at ``src/lib.rs:296``).

    Moreover the bottom-role bases are parity-signed copies of the top ones —
    shifting by half a period flips odd bins:

        Cb[:,k] = (-1)^k Ct[:,k],   Sb[:,k] = (-1)^k St[:,k]

    so only ONE [b x (b+1)] cos + ONE sin projection per block is needed;
    the window assembly is a sign-flipped shifted add
    (see :func:`streamz_tpu.dsp.mfcc.mfcc_base`).  Halves the DFT GEMM FLOPs.

    Returns (Ct, St), each [window/2, window/2 + 1] float64; the
    bottom-role bases are ``bin_parity_sign() * Ct/St`` and are never
    materialized (every consumer applies the sign trick itself).
    """
    b = window // 2
    n_bins = b + 1
    j = np.arange(b)[:, None]
    k = np.arange(n_bins)[None, :]
    ang_top = 2.0 * np.pi * k * j / window
    ct = np.cos(ang_top)
    st = -np.sin(ang_top)
    return ct, st


@lru_cache(maxsize=8)
def bin_parity_sign(window: int = config.WINDOW_SIZE) -> np.ndarray:
    """(-1)^k per one-sided bin — the half-window shift phase factor."""
    n_bins = window // 2 + 1
    return np.where(np.arange(n_bins) % 2 == 0, 1.0, -1.0)
