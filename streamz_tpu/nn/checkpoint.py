"""``model.npz`` checkpoint reader/writer, schema-compatible with the reference.

Writer schema (``streamz-rs/src/lib.rs:1081-1130``):

- ``w1``, ``b1``, ``w2``, ``b2``: f32 weight arrays.
- ``sample_rate``, ``bits``, ``num_speakers``: i64 arrays of length 1.
- ``w3_{i+1}`` (f32 column of length h2) and ``b3_{i+1}`` (f32 length 1) for
  each *live* speaker column — only live columns are emitted, so the
  capacity-padded device layout never leaks into checkpoints.
- optional stego layer ``w4_{i+1}``/``b4_{i+1}`` per output bit.
- ``speaker_{i}_files``: u8 bytes of newline-joined training paths.
- ``speaker_embeddings`` [S x h2] + ``speaker_mean_sims`` + ``speaker_std_sims``
  when embeddings are present.

Reader tolerances (``src/lib.rs:1132-1281``): falls back to a legacy monolithic
``w3``/``b3`` pair when no ``w3_{i}`` columns exist (``:1199-1207``), takes the
speaker count from the ``num_speakers`` scalar when available else from the
column count (``:1227-1233``), and treats every other entry as optional.
Keys are accepted with or without a trailing ``.npy`` (ndarray-npy and numpy
disagree about storing the extension; ``src/lib.rs:1238`` checks
``speaker_{i}_files.npy`` explicitly).
"""

from __future__ import annotations

import hashlib
import io
import os
import tempfile
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from streamz_tpu.nn.model import SpeakerNet, round_capacity

import jax.numpy as jnp


def save(net: SpeakerNet, path: str) -> None:
    """Serialize a :class:`SpeakerNet` to the reference npz schema."""
    arrays: Dict[str, np.ndarray] = {
        "w1": np.asarray(net.params["w1"], np.float32),
        "b1": np.asarray(net.params["b1"], np.float32),
        "w2": np.asarray(net.params["w2"], np.float32),
        "b2": np.asarray(net.params["b2"], np.float32),
        "sample_rate": np.array([net.sample_rate], np.int64),
        "bits": np.array([net.bits], np.int64),
        "num_speakers": np.array([net.num_speakers], np.int64),
    }
    w3 = np.asarray(net.params["w3"], np.float32)
    b3 = np.asarray(net.params["b3"], np.float32)
    for idx in range(net.num_speakers):
        arrays[f"w3_{idx + 1}"] = w3[:, idx].copy()
        arrays[f"b3_{idx + 1}"] = np.array([b3[idx]], np.float32)
    if net.w4 is not None and net.b4 is not None:
        for idx in range(net.b4.shape[0]):
            arrays[f"w4_{idx + 1}"] = np.asarray(net.w4[:, idx], np.float32)
            arrays[f"b4_{idx + 1}"] = np.array([net.b4[idx]], np.float32)
    for idx in range(net.num_speakers):
        files = net.file_lists[idx] if idx < len(net.file_lists) else []
        joined = "\n".join(files)
        arrays[f"speaker_{idx}_files"] = np.frombuffer(
            joined.encode("utf-8"), dtype=np.uint8
        ).copy()
    if net.embeddings:
        dim = len(net.embeddings[0][0])
        embeds = np.zeros((len(net.embeddings), dim), np.float32)
        mean_sims = np.zeros(len(net.embeddings), np.float32)
        std_sims = np.zeros(len(net.embeddings), np.float32)
        for i, (e, m, s) in enumerate(net.embeddings):
            embeds[i] = np.asarray(e, np.float32)
            mean_sims[i] = m
            std_sims[i] = s
        arrays["speaker_embeddings"] = embeds
        arrays["speaker_mean_sims"] = mean_sims
        arrays["speaker_std_sims"] = std_sims
    # Write through a file handle: np.savez(path_str) silently appends
    # '.npz' when the suffix is missing, making save/load disagree about
    # the file name for custom model paths.  The write is ATOMIC
    # (temp file + fsync + rename in the target directory): a crash
    # mid-save never corrupts the previous checkpoint, and a concurrent
    # reader — e.g. the serving daemon's hot-reload watcher
    # (app/server.py) or another process resuming — can never observe a
    # partially-written npz.  The reference writes in place
    # (src/lib.rs:1081-1130) and can corrupt model.npz on crash; this is
    # a deliberate robustness upgrade with identical on-disk content.
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".model-", suffix=".npz.tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        # mkstemp creates 0600 and os.replace keeps that mode, which would
        # silently strip group/other read from the checkpoint — breaking
        # the hot-reload watcher when the serving daemon runs as a
        # different user.  Preserve the existing file's mode, else the
        # umask-derived default an open()-based writer would have used.
        try:
            mode = os.stat(path).st_mode & 0o777
        except OSError:
            um = os.umask(0)
            os.umask(um)
            mode = 0o666 & ~um
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# Decompressed-size caps: a hostile "model.npz" must fail with a clean
# ValueError, not OOM the serving daemon that hot-reloads it (a zip
# entry's compressed form can be ~1000x smaller than what it inflates to,
# and MANY small-on-disk entries can sum past any per-entry cap).  The
# 4 GiB per-entry default leaves ~8x headroom over the largest legitimate
# checkpoint measured (the 64 KiB-stego net's ~0.5 GB output layer,
# benchmarks/report.json); the TOTAL budget is 2x that.
_DEFAULT_MAX_ENTRY_BYTES = 4 << 30


def _max_entry_bytes() -> int:
    """Read the override at CALL time (a long-running daemon operator must
    be able to set it before a retry, per the error message's own advice);
    a malformed value raises a ValueError naming the variable."""
    raw = os.environ.get("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES")
    if raw is None:
        return _DEFAULT_MAX_ENTRY_BYTES
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES={raw!r} is not an integer"
        ) from None


def _read_npz_raw(path: str) -> Dict[str, np.ndarray]:
    """Read an npz whose entries may or may not carry a ``.npy`` extension.

    Hostile inputs (truncated zips, bit flips, pickle smuggling, zip
    bombs, absolute/traversal entry names) raise cleanly — entries are
    only ever decoded in memory with ``allow_pickle=False``, never
    extracted to disk, and per-entry AND cumulative decompressed-size
    caps reject bombs before allocation (``tests/test_checkpoint.py``
    fuzzes this contract)."""
    out: Dict[str, np.ndarray] = {}
    cap = _max_entry_bytes()
    total = 0
    with zipfile.ZipFile(path, "r") as zf:
        for info in zf.infolist():
            if info.file_size > cap:
                raise ValueError(
                    f"checkpoint entry {info.filename!r} inflates to "
                    f"{info.file_size} bytes (cap {cap}; override via "
                    "STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES)"
                )
            total += info.file_size
            if total > 2 * cap:
                raise ValueError(
                    f"checkpoint inflates to {total}+ bytes across entries "
                    f"(total cap {2 * cap}; override via "
                    "STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES)"
                )
            name = info.filename
            key = name[:-4] if name.endswith(".npy") else name
            with zf.open(name) as f:
                out[key] = np.load(io.BytesIO(f.read()), allow_pickle=False)
    return out


def load(path: str) -> SpeakerNet:
    """Deserialize ``model.npz`` (src/lib.rs:1132-1281).

    Raise-or-load contract: a malformed file (truncated, bit-flipped,
    wrong dtypes/shapes, missing core entries) raises a clean Python
    exception BEFORE any state is built — load() constructs a fresh net
    from scratch, so a failed load can never partially apply (what the
    serving daemon's hot-reload watcher relies on, ``app/server.py``)."""
    data = _read_npz_raw(path)
    w1 = np.asarray(data["w1"], np.float32)
    b1 = np.asarray(data["b1"], np.float32)
    w2 = np.asarray(data["w2"], np.float32)
    b2 = np.asarray(data["b2"], np.float32)
    # Core-schema consistency: a wrong-shaped checkpoint must fail HERE
    # with a message, not mid-serve on a later dispatch.
    if w1.ndim != 2 or w2.ndim != 2 or b1.ndim != 1 or b2.ndim != 1 or (
        w1.shape[1] != b1.shape[0]
        or w2.shape[0] != w1.shape[1]
        or w2.shape[1] != b2.shape[0]
    ):
        raise ValueError(
            "inconsistent core weight shapes: "
            f"w1{w1.shape} b1{b1.shape} w2{w2.shape} b2{b2.shape}"
        )
    sample_rate = int(np.asarray(data["sample_rate"]).ravel()[0])
    bits = int(np.asarray(data["bits"]).ravel()[0])

    # Per-column w3_{i}/b3_{i} entries, 1-indexed, contiguous from 1.
    columns: List[np.ndarray] = []
    biases: List[float] = []
    idx = 1
    while f"w3_{idx}" in data and f"b3_{idx}" in data:
        columns.append(np.asarray(data[f"w3_{idx}"], np.float32).ravel())
        biases.append(float(np.asarray(data[f"b3_{idx}"]).ravel()[0]))
        idx += 1

    hidden2 = w2.shape[1]
    num_outputs = len(columns)
    if columns:
        w3_live = np.stack(columns, axis=1)
        b3_live = np.array(biases, np.float32)
    elif "w3" in data:
        # Legacy monolithic layout (src/lib.rs:1199-1207).
        w3_live = np.asarray(data["w3"], np.float32)
        b3_live = np.asarray(data["b3"], np.float32).ravel()
        num_outputs = b3_live.shape[0]
    else:
        # No stored columns at all (0-speaker checkpoint): keep ZERO live
        # columns so the first class discovered after resume exposes the
        # content-seeded random init below — the reference's
        # add_output_class also samples a fresh random column
        # (src/lib.rs:807-810); pinning a zero column here would train the
        # first speaker from an all-zero init, a distribution divergence.
        w3_live = np.zeros((hidden2, 0), np.float32)
        b3_live = np.zeros((0,), np.float32)

    # Optional stego layer columns (src/lib.rs:1169-1186, :1209-1226).
    columns4: List[np.ndarray] = []
    biases4: List[float] = []
    idx4 = 1
    while f"w4_{idx4}" in data and f"b4_{idx4}" in data:
        columns4.append(np.asarray(data[f"w4_{idx4}"], np.float32).ravel())
        biases4.append(float(np.asarray(data[f"b4_{idx4}"]).ravel()[0]))
        idx4 += 1
    w4 = np.stack(columns4, axis=1) if columns4 else None
    b4 = np.array(biases4, np.float32) if columns4 else None

    if "num_speakers" in data:
        outputs = int(np.asarray(data["num_speakers"]).ravel()[0])
        # The scalar steers allocation loops below (file_lists, the
        # [hidden2, round_capacity(outputs)] padding matrix): a hostile
        # value like 2**62 would hang/OOM the daemon's hot-reload ticker.
        # 1 M speakers is ~100x the largest corpus this stack has been
        # soaked at and keeps worst-case allocation ~1 GB.
        if not 0 <= outputs <= 1_000_000:
            raise ValueError(
                f"num_speakers={outputs} outside the sane range [0, 1e6]"
            )
    else:
        outputs = num_outputs  # src/lib.rs:1227-1233

    file_lists: List[List[str]] = []
    for i in range(outputs):
        key = f"speaker_{i}_files"
        if key in data:
            text = bytes(np.asarray(data[key], np.uint8)).decode("utf-8", "replace")
            file_lists.append(text.splitlines() if text else [])
        else:
            file_lists.append([])

    embeddings: List[Tuple[np.ndarray, float, float]] = []
    if "speaker_embeddings" in data:
        embeds = np.asarray(data["speaker_embeddings"], np.float32)
        n_emb = embeds.shape[0]

        def _sims(key: str) -> np.ndarray:
            # Optional like every other non-core entry (the module
            # contract): a foreign/older writer may omit the sims or store
            # fewer rows than embeddings.  Missing values degrade to 0.0 —
            # the adaptive gate then treats that speaker as uncalibrated
            # (reject threshold mean-2*std == 0), instead of the whole
            # checkpoint failing to load with KeyError/IndexError.
            if key in data:
                v = np.asarray(data[key], np.float32).ravel()
                if v.size >= n_emb:
                    return v
                out = np.zeros(n_emb, np.float32)
                out[: v.size] = v
                return out
            return np.zeros(n_emb, np.float32)

        mean_sims = _sims("speaker_mean_sims")
        std_sims = _sims("speaker_std_sims")
        for i in range(n_emb):
            embeddings.append((embeds[i].copy(), float(mean_sims[i]), float(std_sims[i])))

    # Re-pad the live columns into the capacity-aligned device layout. The
    # padding seed is derived from the live column *content* (not Python
    # hash(), which is salted per process) so that classes grown after a
    # resume get identical init columns on every run — the determinism
    # contract of app/incremental.py.
    cap = round_capacity(max(outputs, w3_live.shape[1], 1))
    digest = hashlib.sha256()
    digest.update(np.ascontiguousarray(w3_live).tobytes())
    digest.update(np.ascontiguousarray(b3_live).tobytes())
    seed = int.from_bytes(digest.digest()[:4], "little")
    rng = np.random.default_rng(seed)
    w3_full = rng.uniform(-0.5, 0.5, size=(hidden2, cap)).astype(np.float32)
    b3_full = np.zeros((cap,), np.float32)
    n_live = w3_live.shape[1]
    w3_full[:, :n_live] = w3_live
    b3_full[:n_live] = b3_live

    params = {
        "w1": jnp.asarray(w1),
        "b1": jnp.asarray(b1),
        "w2": jnp.asarray(w2),
        "b2": jnp.asarray(b2),
        "w3": jnp.asarray(w3_full),
        "b3": jnp.asarray(b3_full),
    }
    return SpeakerNet(
        params=params,
        num_speakers=outputs,
        file_lists=file_lists,
        sample_rate=sample_rate,
        bits=bits,
        embeddings=embeddings,
        w4=w4,
        b4=b4,
    )
