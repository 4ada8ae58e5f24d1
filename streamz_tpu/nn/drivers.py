"""Host-side training drivers mirroring the reference's L3 orchestration API.

- ``pretrain_from_features`` (``streamz-rs/src/lib.rs:582-628``)
- ``pretrain_network`` — per-epoch augmentation on raw PCM (``src/lib.rs:348-397``)
- ``train_from_feature_map`` (``src/lib.rs:632-665``)
- ``train_from_files`` with the 0.99^step lr decay (``src/lib.rs:668-732``) —
  rebuilt as a *deterministic sequential* loop (the reference's rayon ordering
  is nondeterministic; see SURVEY.md §7.7): same capability, reproducible
  results.

Each driver pads the window set to a power-of-two bucket (bounding XLA
recompiles) and runs the fused :func:`streamz_tpu.nn.train.train_on_windows`
scan on device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu import config
from streamz_tpu.dsp.augment import augment
from streamz_tpu.dsp.features import FeatureExtractor
from streamz_tpu.io.audio import load_and_resample_file
from streamz_tpu.nn import train as T
from streamz_tpu.nn.model import SpeakerNet

_key_counter = [0]


def _fresh_key(seed: Optional[int] = None) -> jax.Array:
    if seed is None:
        _key_counter[0] += 1
        seed = _key_counter[0]
    return jax.random.PRNGKey(seed)


def _pad_windows(windows: np.ndarray, batch_size: int) -> Tuple[np.ndarray, int]:
    """Pad [N, F] windows up to batch_size * next_pow2(ceil(N/bs)) rows.

    ``batch_size`` is clamped to >= 1 like the reference's
    ``chunks(batch_size.max(1))`` (src/lib.rs:371, :602)."""
    batch_size = max(1, int(batch_size))
    n = len(windows)
    chunks = max(1, -(-n // batch_size))
    n_pad = config.next_pow2(chunks) * batch_size
    if n_pad == n:
        return np.asarray(windows, np.float32), n
    out = np.zeros((n_pad, windows.shape[1] if n else config.FEATURE_SIZE), np.float32)
    if n:
        out[:n] = windows
    return out, n


def _target_vec(capacity: int, target_class: int, num_classes: int) -> np.ndarray:
    """One-hot iff target_class < num_classes, else all-zero (src/lib.rs:592-594)."""
    v = np.zeros((capacity,), np.float32)
    if 0 <= target_class < min(num_classes, capacity):
        v[target_class] = 1.0
    return v


def pretrain_from_features(
    net: SpeakerNet,
    windows: np.ndarray,
    target_class: int,
    num_classes: int,
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    *,
    key: Optional[jax.Array] = None,
) -> float:
    """Train on cached feature windows; returns the mean reported loss."""
    windows = np.asarray(windows, np.float32)
    if windows.ndim != 2 or len(windows) == 0:
        return 0.0
    if 0 <= target_class < num_classes and target_class >= net.num_speakers:
        # The logit mask blocks gradients to columns >= num_speakers, so a
        # target there would silently train as a no-target pure-softmax
        # update (the class can never be learned) while reporting
        # -ln(1e-12) losses.  The caller must grow the net first.
        raise ValueError(
            f"target_class {target_class} is masked: net has "
            f"{net.num_speakers} live speakers (grow with "
            "add_output_class/ensure before training this class)"
        )
    batch_size = max(1, int(batch_size))  # reference clamp (src/lib.rs:602)
    padded, n_valid = _pad_windows(windows, batch_size)
    tvec = _target_vec(net.capacity, target_class, num_classes)
    params, mean_loss = T.train_on_windows(
        net.params,
        jnp.asarray(padded),
        jnp.int32(n_valid),
        jnp.asarray(tvec),
        jnp.int32(net.num_speakers),
        key if key is not None else _fresh_key(),
        jnp.float32(lr),
        jnp.float32(dropout),
        epochs=int(epochs),
        batch_size=int(batch_size),
    )
    net.params = params
    return float(mean_loss)


def pretrain_network(
    net: SpeakerNet,
    samples: np.ndarray,
    target_class: int,
    num_classes: int,
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    extractor: Optional[FeatureExtractor] = None,
    *,
    key: Optional[jax.Array] = None,
) -> float:
    """Raw-PCM trainer with fresh augmentation every epoch (src/lib.rs:348-397)."""
    extractor = extractor or FeatureExtractor()
    base_key = key if key is not None else _fresh_key()
    # One upload for all epochs: the clip is identical every iteration,
    # and re-transferring multi-second PCM per epoch costs a host→device
    # copy per epoch.
    samples_j = jnp.asarray(np.asarray(samples), jnp.float32)
    total, count = 0.0, 0
    for e in range(int(epochs)):
        ekey = jax.random.fold_in(base_key, e)
        k_aug, k_train = jax.random.split(ekey)
        aug = np.asarray(augment(k_aug, samples_j))
        windows = extractor.extract(aug.astype(np.int16))
        if len(windows) == 0:
            continue
        loss = pretrain_from_features(
            net, windows, target_class, num_classes, 1, lr, dropout, batch_size,
            key=k_train,
        )
        total += loss
        count += 1
    return total / count if count else 0.0


def train_from_feature_map(
    net: SpeakerNet,
    feature_map: Dict[str, np.ndarray],
    files: Sequence[Tuple[str, int]],
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    *,
    key: Optional[jax.Array] = None,
) -> float:
    """Per-(path, class) training loop (src/lib.rs:632-665)."""
    base_key = key if key is not None else _fresh_key()
    total, count = 0.0, 0
    for i, (path, cls) in enumerate(files):
        wins = feature_map.get(path)
        if wins is None:
            continue
        loss = pretrain_from_features(
            net, wins, cls, net.output_size(), epochs, lr, dropout, batch_size,
            key=jax.random.fold_in(base_key, i),
        )
        net.record_training_file(cls, path)
        total += loss
        count += 1
    return total / count if count else 0.0


def train_from_files(
    net: SpeakerNet,
    files: Sequence[Tuple[str, int]],
    num_speakers: int,
    epochs: int,
    lr: float,
    dropout: float,
    batch_size: int,
    extractor: Optional[FeatureExtractor] = None,
    *,
    key: Optional[jax.Array] = None,
) -> None:
    """Deterministic rebuild of the rayon file loop (src/lib.rs:668-732).

    The lr decays as ``lr * 0.99**step`` with one global step per
    (file, epoch), matching the reference's atomic counter (``:709``) under
    the deterministic sequential order.
    """
    extractor = extractor or FeatureExtractor()
    base_key = key if key is not None else _fresh_key()
    step = 0
    for path, cls in files:
        try:
            _, samples = load_and_resample_file(path)
        except Exception:
            continue
        net.set_dataset_specs(config.DEFAULT_SAMPLE_RATE, 16)
        for _ in range(int(epochs)):
            lr_scaled = lr * (0.99 ** step)
            step += 1
            pretrain_network(
                net, samples, cls, num_speakers, 1, lr_scaled, dropout,
                batch_size, extractor, key=jax.random.fold_in(base_key, step),
            )
            net.record_training_file(cls, path)
