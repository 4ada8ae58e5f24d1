"""model.npz schema round-trip tests, incl. the legacy monolithic-w3 path."""

import io
import os
import zipfile

import numpy as np

from streamz_tpu.nn import checkpoint
from streamz_tpu.nn.model import SpeakerNet


def _small_net(num_speakers=3):
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=num_speakers, seed=7)
    net.record_training_file(0, "x/a.wav")
    net.record_training_file(0, "x/b.wav")
    net.record_training_file(2, "y/c.wav")
    net.set_embeddings(
        [
            (np.arange(4, dtype=np.float32) + i, 0.5 + i, 0.1 * i)
            for i in range(num_speakers)
        ]
    )
    return net


def test_npz_schema_keys(tmp_path):
    net = _small_net()
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    with np.load(path) as z:
        keys = set(z.files)
    expected = {
        "w1", "b1", "w2", "b2", "sample_rate", "bits", "num_speakers",
        "w3_1", "b3_1", "w3_2", "b3_2", "w3_3", "b3_3",
        "speaker_0_files", "speaker_1_files", "speaker_2_files",
        "speaker_embeddings", "speaker_mean_sims", "speaker_std_sims",
    }
    assert keys == expected
    with np.load(path) as z:
        assert z["sample_rate"].dtype == np.int64
        assert z["num_speakers"][0] == 3
        assert z["w3_1"].shape == (4,)  # hidden2 column vector
        assert z["b3_1"].shape == (1,)
        assert z["speaker_embeddings"].shape == (3, 4)
        files0 = bytes(z["speaker_0_files"]).decode()
        assert files0 == "x/a.wav\nx/b.wav"


def test_roundtrip_preserves_model(tmp_path):
    net = _small_net()
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    got = checkpoint.load(path)
    assert got.num_speakers == 3
    assert got.sample_rate == net.sample_rate
    assert got.bits == 16
    np.testing.assert_allclose(np.asarray(got.params["w1"]), np.asarray(net.params["w1"]))
    w3_live_in, b3_live_in = net.output_layer()
    w3_live_out, b3_live_out = got.output_layer()
    np.testing.assert_allclose(w3_live_out, w3_live_in)
    np.testing.assert_allclose(b3_live_out, b3_live_in)
    assert got.file_lists[0] == ["x/a.wav", "x/b.wav"]
    assert got.file_lists[1] == []
    assert got.file_lists[2] == ["y/c.wav"]
    assert len(got.embeddings) == 3
    np.testing.assert_allclose(got.embeddings[1][0], net.embeddings[1][0])
    assert got.embeddings[1][1] == net.embeddings[1][1]


def test_forward_identical_after_roundtrip(tmp_path):
    net = _small_net()
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    got = checkpoint.load(path)
    x = np.random.default_rng(0).normal(size=(10, 6)).astype(np.float32)
    np.testing.assert_allclose(got.forward(x), net.forward(x), rtol=1e-6)


def test_legacy_monolithic_w3(tmp_path):
    """Reference fallback path src/lib.rs:1199-1207."""
    rng = np.random.default_rng(3)
    arrays = {
        "w1": rng.normal(size=(6, 5)).astype(np.float32),
        "b1": np.zeros(5, np.float32),
        "w2": rng.normal(size=(5, 4)).astype(np.float32),
        "b2": np.zeros(4, np.float32),
        "w3": rng.normal(size=(4, 2)).astype(np.float32),
        "b3": rng.normal(size=(2,)).astype(np.float32),
        "sample_rate": np.array([44100], np.int64),
        "bits": np.array([16], np.int64),
    }
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **arrays)
    got = checkpoint.load(path)
    assert got.num_speakers == 2
    w3, b3 = got.output_layer()
    np.testing.assert_allclose(w3, arrays["w3"])
    np.testing.assert_allclose(b3, arrays["b3"])


def test_entries_without_npy_extension(tmp_path):
    """ndarray-npy may store zip entries without the .npy suffix."""
    net = _small_net()
    src = str(tmp_path / "model.npz")
    dst = str(tmp_path / "stripped.npz")
    checkpoint.save(net, src)
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            stripped = name[:-4] if name.endswith(".npy") else name
            zout.writestr(stripped, data)
    got = checkpoint.load(dst)
    assert got.num_speakers == 3
    assert got.file_lists[0] == ["x/a.wav", "x/b.wav"]


def test_stego_layer_roundtrip(tmp_path):
    net = _small_net()
    rng = np.random.default_rng(5)
    w4 = rng.normal(size=(4, 16)).astype(np.float32)
    b4 = rng.normal(size=(16,)).astype(np.float32)
    net.set_encoding_layer(w4, b4)
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    got = checkpoint.load(path)
    enc = got.encoding_layer()
    assert enc is not None
    np.testing.assert_allclose(enc[0], w4)
    np.testing.assert_allclose(enc[1], b4)


def test_checkpoint_across_capacity_boundary(tmp_path):
    """150 speakers crosses the 128-column capacity tile: all live columns
    round-trip and the padded layout never leaks into the file."""
    net = SpeakerNet.new(input_size=6, hidden1=5, hidden2=4, output=150, seed=1)
    assert net.capacity == 256
    path = str(tmp_path / "big.npz")
    checkpoint.save(net, path)
    with np.load(path) as z:
        w3_keys = [k for k in z.files if k.startswith("w3_")]
        assert len(w3_keys) == 150  # live columns only
    got = checkpoint.load(path)
    assert got.num_speakers == 150
    w_in, b_in = net.output_layer()
    w_out, b_out = got.output_layer()
    np.testing.assert_allclose(w_out, w_in)
    np.testing.assert_allclose(b_out, b_in)
    x = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    np.testing.assert_allclose(got.forward(x), net.forward(x), rtol=1e-5,
                               atol=1e-6)


def test_load_padding_deterministic_across_processes(tmp_path):
    """The capacity-padding columns created at load time
    must not depend on Python's per-process hash salt — after a resume,
    newly *grown* classes must get identical init columns in every run."""
    import subprocess
    import sys

    net = _small_net()
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)

    script = (
        "import os\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np\n"
        "from streamz_tpu.nn import checkpoint\n"
        f"net = checkpoint.load({path!r})\n"
        "net.add_output_class()\n"
        "col = np.asarray(net.params['w3'][:, net.num_speakers - 1])\n"
        "print(','.join(f'{v:.8e}' for v in col))\n"
    )
    outs = []
    for salt in ("0", "12345"):
        env = dict(
            PYTHONHASHSEED=salt,
            PATH="/usr/bin:/bin",
            PYTHONPATH="/root/repo",
            HOME=str(tmp_path),
        )
        proc = subprocess.run(
            [sys.executable, "-c", script],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout.strip().splitlines()[-1])
    assert outs[0] == outs[1], "grown column differs across hash salts"


def test_load_padding_differs_for_different_content(tmp_path):
    """Content-derived seed: different live weights -> different padding."""
    a = _small_net()
    b = _small_net()
    b.params = dict(b.params, b3=b.params["b3"] + 0.25)
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    checkpoint.save(a, pa)
    checkpoint.save(b, pb)
    la, lb = checkpoint.load(pa), checkpoint.load(pb)
    pad_a = np.asarray(la.params["w3"][:, la.num_speakers:])
    pad_b = np.asarray(lb.params["w3"][:, lb.num_speakers:])
    assert not np.array_equal(pad_a, pad_b)


def test_zero_speaker_resume_random_first_column(tmp_path):
    """A 0-speaker checkpoint must resume with a RANDOM (content-seeded)
    first column, not all-zeros — the reference samples a fresh U(-0.5,0.5)
    column in add_output_class (src/lib.rs:807-810)."""
    net = SpeakerNet.new(output=0, seed=0)
    p = str(tmp_path / "model.npz")
    checkpoint.save(net, p)
    loaded = checkpoint.load(p)
    assert loaded.num_speakers == 0
    col0 = np.asarray(loaded.params["w3"])[:, 0]
    assert np.abs(col0).max() > 0.0  # random init, not pinned zeros
    # determinism contract: reloading gives the identical padding
    again = np.asarray(checkpoint.load(p).params["w3"])[:, 0]
    np.testing.assert_array_equal(col0, again)


def test_save_respects_custom_suffix(tmp_path):
    """save(path) must write exactly `path` (np.savez silently appends
    .npz to string paths without the suffix)."""
    net = SpeakerNet.new(output=2, seed=0)
    p = str(tmp_path / "model.ckpt")
    checkpoint.save(net, p)
    assert os.path.exists(p) and not os.path.exists(p + ".npz")
    assert checkpoint.load(p).num_speakers == 2


def test_save_is_atomic(tmp_path, monkeypatch):
    """A crash mid-save must not corrupt the previous checkpoint, and no
    temp litter may remain — concurrent readers (the serving daemon's
    hot-reload watcher) can never observe a partial npz."""
    net3 = _small_net(3)
    p = str(tmp_path / "model.npz")
    checkpoint.save(net3, p)
    before = open(p, "rb").read()

    real_savez = np.savez

    def crashing_savez(f, **arrays):
        f.write(b"partial garbage")  # bytes hit the TEMP file, then crash
        raise RuntimeError("disk full")

    monkeypatch.setattr(np, "savez", crashing_savez)
    try:
        checkpoint.save(_small_net(4), p)
    except RuntimeError:
        pass
    else:
        raise AssertionError("crashing save did not raise")
    finally:
        monkeypatch.setattr(np, "savez", real_savez)

    # Previous checkpoint intact, still loadable, no temp files left.
    assert open(p, "rb").read() == before
    assert checkpoint.load(p).num_speakers == 3
    leftovers = [f for f in os.listdir(tmp_path) if f != "model.npz"]
    assert leftovers == []


def test_foreign_rust_writer_layout(tmp_path):
    """Hand-built emulation of the REFERENCE writer's npz: ndarray-npy 0.8's ``NpzWriter::new`` writes STORED zip
    entries named WITHOUT the ``.npy`` suffix (``src/lib.rs:1081-1130``),
    in the reference's exact key order and shapes (i64 [1] scalars,
    per-column ``w3_{i}``/length-1 ``b3_{i}``, u8 file-list bytes).  The
    Rust toolchain is absent here, so this fixture is constructed from
    ``np.lib.format.write_array`` payloads directly — independent of our
    own writer — to pin the reader against the foreign layout."""
    rng = np.random.default_rng(7)
    h1, h2, n_spk = 6, 4, 2
    arrays = [
        ("w1", rng.normal(size=(5, h1)).astype(np.float32)),
        ("b1", rng.normal(size=(h1,)).astype(np.float32)),
        ("w2", rng.normal(size=(h1, h2)).astype(np.float32)),
        ("b2", rng.normal(size=(h2,)).astype(np.float32)),
        ("sample_rate", np.array([44100], np.int64)),
        ("bits", np.array([16], np.int64)),
        ("num_speakers", np.array([n_spk], np.int64)),
    ]
    w3 = rng.normal(size=(h2, n_spk)).astype(np.float32)
    b3 = rng.normal(size=(n_spk,)).astype(np.float32)
    for i in range(n_spk):
        arrays.append((f"w3_{i + 1}", w3[:, i].copy()))
        arrays.append((f"b3_{i + 1}", np.array([b3[i]], np.float32)))
    lists = [["clips/a.mp3", "clips/b.mp3"], []]
    for i, fl in enumerate(lists):
        arrays.append((
            f"speaker_{i}_files",
            np.frombuffer("\n".join(fl).encode(), np.uint8).copy(),
        ))
    embeds = rng.normal(size=(n_spk, h2)).astype(np.float32)
    arrays += [
        ("speaker_embeddings", embeds),
        ("speaker_mean_sims", np.array([0.9, 0.8], np.float32)),
        ("speaker_std_sims", np.array([0.05, 0.04], np.float32)),
    ]

    path = str(tmp_path / "rust_layout.npz")
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        for name, arr in arrays:
            buf = io.BytesIO()
            np.lib.format.write_array(buf, arr, allow_pickle=False)
            zf.writestr(name, buf.getvalue())  # bare name, STORED
    with zipfile.ZipFile(path) as zf:  # the layout IS foreign
        assert all(not n.endswith(".npy") for n in zf.namelist())

    net = checkpoint.load(path)
    assert net.num_speakers == n_spk
    assert net.sample_rate == 44100 and net.bits == 16
    np.testing.assert_array_equal(np.asarray(net.params["w1"]), arrays[0][1])
    live_w3, live_b3 = net.output_layer()
    np.testing.assert_array_equal(live_w3, w3)
    np.testing.assert_array_equal(live_b3, b3)
    assert net.file_lists == lists
    assert len(net.embeddings) == n_spk
    np.testing.assert_array_equal(net.embeddings[0][0], embeds[0])
    assert net.embeddings[1][1:] == (np.float32(0.8), np.float32(0.04))

    # And our writer round-trips the foreign-born net losslessly.
    out = str(tmp_path / "resaved.npz")
    checkpoint.save(net, out)
    again = checkpoint.load(out)
    np.testing.assert_array_equal(*(np.asarray(n.params["w3"])
                                    for n in (net, again)))
    assert again.file_lists == lists


def test_save_preserves_existing_file_mode(tmp_path):
    """Atomic save must not flip the checkpoint to mkstemp's 0600: the
    hot-reload watcher may run as another user and needs the mode the
    operator set (or the umask default for a fresh file)."""
    net = SpeakerNet.new(output=2, seed=0)
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    assert os.stat(path).st_mode & 0o044, "fresh save lost read bits"
    os.chmod(path, 0o664)
    checkpoint.save(net, path)
    assert os.stat(path).st_mode & 0o777 == 0o664


def test_load_tolerates_missing_sims_entries(tmp_path):
    """speaker_embeddings without speaker_mean/std_sims (foreign or
    truncated writer) must load with 0.0 calibration, not KeyError."""
    net = SpeakerNet.new(output=2, seed=0)
    net.set_embeddings([
        (np.ones(128, np.float32), 0.9, 0.1),
        (np.ones(128, np.float32) * 2, 0.8, 0.2),
    ])
    path = str(tmp_path / "model.npz")
    checkpoint.save(net, path)
    # strip the sims entries, keep everything else
    import zipfile

    src = zipfile.ZipFile(path)
    stripped = str(tmp_path / "stripped.npz")
    with zipfile.ZipFile(stripped, "w") as out:
        for name in src.namelist():
            if "mean_sims" in name or "std_sims" in name:
                continue
            out.writestr(name, src.read(name))
    src.close()
    got = checkpoint.load(stripped)
    assert len(got.embeddings) == 2
    for emb, m, s in got.embeddings:
        assert m == 0.0 and s == 0.0
    np.testing.assert_array_equal(got.embeddings[0][0], np.ones(128))


# ---- adversarial reader fuzz ------------------------------------------------
#
# The serving daemon hot-reloads model.npz from disk while serving
# (app/server.py watcher), so the reader's contract is raise-or-load: any
# malformed input must produce a clean Python exception before any state is
# built — never a hang, a crash, or a partially-applied model.  load()
# builds a fresh net from scratch, so partial application is impossible by
# construction; these tests pin the "clean exception" half on truncations,
# bit flips, schema mutations, hostile entry names, pickle smuggling and
# zip bombs.  (The ingest layer got the same treatment in
# test_ingest_fuzz.py.)  Reader tolerance ref: src/lib.rs:1132-1281.


def _ckpt_bytes(tmp_path):
    path = str(tmp_path / "fuzz_base.npz")
    checkpoint.save(_small_net(), path)
    with open(path, "rb") as f:
        return f.read()


def _try_load(tmp_path, blob, name="fuzzed.npz"):
    """load() must return a SpeakerNet or raise a clean exception."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    try:
        net = checkpoint.load(p)
    except Exception:
        return None  # clean raise: acceptable
    assert isinstance(net, SpeakerNet)
    return net


def test_fuzz_truncations(tmp_path):
    blob = _ckpt_bytes(tmp_path)
    cuts = sorted({int(len(blob) * f) for f in np.linspace(0.0, 0.999, 25)})
    loaded = 0
    for cut in cuts:
        if _try_load(tmp_path, blob[:cut]) is not None:
            loaded += 1
    # A zip's central directory lives at the end: no truncation can load.
    assert loaded == 0


def test_fuzz_bit_flips(tmp_path):
    blob = bytearray(_ckpt_bytes(tmp_path))
    rng = np.random.default_rng(42)
    for _ in range(60):
        mutated = bytearray(blob)
        for pos in rng.integers(0, len(blob), size=rng.integers(1, 8)):
            mutated[pos] ^= 1 << int(rng.integers(0, 8))
        _try_load(tmp_path, bytes(mutated))  # load-or-clean-raise only


def _rewrite_entry(blob, key, value):
    """The base checkpoint with one npz entry replaced by ``value``."""
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for name in src.namelist():
            base = name[:-4] if name.endswith(".npy") else name
            if base == key:
                buf = io.BytesIO()
                np.save(buf, value, allow_pickle=False)
                dst.writestr(name, buf.getvalue())
            else:
                dst.writestr(name, src.read(name))
    return out.getvalue()


def _drop_entry(blob, key):
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for name in src.namelist():
            base = name[:-4] if name.endswith(".npy") else name
            if base != key:
                dst.writestr(name, src.read(name))
    return out.getvalue()


def test_fuzz_schema_mutations(tmp_path):
    import pytest

    blob = _ckpt_bytes(tmp_path)
    # Wrong-shaped cores must fail AT LOAD with the shape message, not
    # mid-serve on a later dispatch.
    for key, bad in [
        ("w1", np.zeros((30,), np.float32)),            # 1-D
        ("b1", np.zeros((99,), np.float32)),            # mismatched h1
        ("w2", np.zeros((9, 9), np.float32)),           # mismatched h1 x h2
        ("b2", np.zeros((2, 2), np.float32)),           # 2-D bias
    ]:
        p = str(tmp_path / "mut.npz")
        with open(p, "wb") as f:
            f.write(_rewrite_entry(blob, key, bad))
        with pytest.raises(ValueError, match="inconsistent core"):
            checkpoint.load(p)
    # Missing cores, empty scalars, ragged w3 columns, garbage dtypes:
    # clean raise (exact type is reader-internal) or a well-formed load.
    variants = [
        _drop_entry(blob, "w2"),
        _rewrite_entry(blob, "sample_rate", np.zeros((0,), np.int64)),
        _rewrite_entry(blob, "w3_1", np.zeros((17,), np.float32)),
        _rewrite_entry(blob, "b3_1", np.zeros((0,), np.float32)),
        _rewrite_entry(blob, "w1", np.array(["a", "b"], dtype="<U1")),
        _rewrite_entry(blob, "speaker_embeddings", np.float32(3.0)),
    ]
    for i, v in enumerate(variants):
        _try_load(tmp_path, v, name=f"mut_{i}.npz")


def test_fuzz_hostile_entry_names(tmp_path):
    out = io.BytesIO()
    buf = io.BytesIO()
    np.save(buf, np.zeros((3,), np.float32), allow_pickle=False)
    with zipfile.ZipFile(out, "w") as z:
        for name in ("../../escape.npy", "/abs/path.npy", "a\x00b.npy"):
            z.writestr(name, buf.getvalue())
    before = set(os.listdir(tmp_path.parent))
    _try_load(tmp_path, out.getvalue(), name="hostile.npz")
    # Entries are decoded in memory only — nothing is ever extracted.
    assert set(os.listdir(tmp_path.parent)) == before
    assert not os.path.exists("/abs")


def test_fuzz_pickle_smuggling_rejected(tmp_path):
    import pytest

    blob = _ckpt_bytes(tmp_path)
    buf = io.BytesIO()
    np.save(buf, np.array([{"x": 1}], dtype=object), allow_pickle=True)
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as dst:
        for name in src.namelist():
            base = name[:-4] if name.endswith(".npy") else name
            dst.writestr(
                name, buf.getvalue() if base == "w1" else src.read(name)
            )
    p = str(tmp_path / "pickled.npz")
    with open(p, "wb") as f:
        f.write(out.getvalue())
    with pytest.raises(ValueError):
        checkpoint.load(p)


def test_fuzz_zip_bomb_rejected(tmp_path, monkeypatch):
    import pytest

    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", str(1 << 20))
    blob = _ckpt_bytes(tmp_path)
    big = _rewrite_entry(blob, "w1", np.zeros((1 << 19,), np.float32))  # 2 MiB
    p = str(tmp_path / "bomb.npz")
    with open(p, "wb") as f:
        f.write(big)
    with pytest.raises(ValueError, match="inflates"):
        checkpoint.load(p)


def test_fuzz_hostile_num_speakers_rejected(tmp_path):
    """A tiny num_speakers entry steering huge allocation loops (the
    hot-reload ticker would hang/OOM) must fail with a clean ValueError."""
    import pytest

    blob = _ckpt_bytes(tmp_path)
    for bad in (np.array([2 ** 62], np.int64), np.array([-3], np.int64),
                np.array([10_000_000], np.int64)):
        p = str(tmp_path / "ns.npz")
        with open(p, "wb") as f:
            f.write(_rewrite_entry(blob, "num_speakers", bad))
        with pytest.raises(ValueError, match="sane range"):
            checkpoint.load(p)


def test_fuzz_multi_entry_zip_bomb_rejected(tmp_path, monkeypatch):
    """Many under-the-per-entry-cap entries summing past the total budget
    must be rejected before cumulative allocation."""
    import pytest

    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", str(1 << 20))
    blob = _ckpt_bytes(tmp_path)
    src = zipfile.ZipFile(io.BytesIO(blob))
    out = io.BytesIO()
    buf = io.BytesIO()
    np.save(buf, np.zeros((200_000,), np.float32), allow_pickle=False)  # 0.8 MB
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as dst:
        for name in src.namelist():
            dst.writestr(name, src.read(name))
        for i in range(8):  # 8 x 0.8 MB > 2 x 1 MB total budget
            dst.writestr(f"junk_{i}.npy", buf.getvalue())
    p = str(tmp_path / "multibomb.npz")
    with open(p, "wb") as f:
        f.write(out.getvalue())
    with pytest.raises(ValueError, match="across entries"):
        checkpoint.load(p)


def test_entry_cap_env_read_at_call_time(tmp_path, monkeypatch):
    """The override must take effect without re-importing the module (the
    error message tells a live daemon operator to set it), and a malformed
    value must raise an error naming the variable."""
    import pytest

    path = str(tmp_path / "m.npz")
    checkpoint.save(_small_net(), path)
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", "8")
    with pytest.raises(ValueError, match="inflates"):
        checkpoint.load(path)
    monkeypatch.setenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES", "4GB")
    with pytest.raises(ValueError, match="STREAMZ_CHECKPOINT_MAX_ENTRY"):
        checkpoint.load(path)
    monkeypatch.delenv("STREAMZ_CHECKPOINT_MAX_ENTRY_BYTES")
    assert isinstance(checkpoint.load(path), SpeakerNet)
