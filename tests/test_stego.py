"""Steganography subsystem tests: encode/decode round trip, trigger, npz."""

import numpy as np
import pytest

from streamz_tpu import config
from streamz_tpu.nn import checkpoint
from streamz_tpu.nn.model import SpeakerNet
from streamz_tpu.stego import codec


def test_hex_to_bytes_lenient():
    assert codec.hex_to_bytes("00ff10") == b"\x00\xff\x10"
    assert codec.hex_to_bytes("zzff") == b"\xff"  # invalid pairs skipped
    assert codec.hex_to_bytes("") == b""


def test_bits_roundtrip():
    data = bytes(range(256))
    bits = codec.bytes_to_bits(data)
    assert bits.shape == (2048,)
    assert bits[:8].tolist() == [0, 0, 0, 0, 0, 0, 0, 0]
    assert bits[8:16].tolist() == [0, 0, 0, 0, 0, 0, 0, 1]  # MSB-first
    assert codec.bits_to_bytes(bits) == data


def test_checksum_input_bits():
    bits = codec.checksum_input_bits()
    assert bits.shape == (512,)  # 128 hex chars = 64 bytes = 512 bits


def test_encode_decode_roundtrip(tmp_path):
    payload = b"StreamZ hidden payload \x00\x01\xfe!"
    src = tmp_path / "secret.bin"
    src.write_bytes(payload)
    enc_net = codec.encode_file(str(src), max_epochs=200_000)
    got = codec.extract_file_from_classifier(enc_net)
    assert got[: len(payload)] == payload


def test_encode_decode_4kb_payload(tmp_path):
    """Scale: a 4 KiB payload (32768 bits -> a [256, 32768] output layer)
    round-trips bit-exactly."""
    payload = np.random.default_rng(4096).bytes(4096)
    src = tmp_path / "big.bin"
    src.write_bytes(payload)
    enc_net = codec.encode_file(str(src), max_epochs=500_000)
    got = codec.extract_file_from_classifier(enc_net)
    assert got[: len(payload)] == payload


def test_encode_rejects_oversized_payload(tmp_path):
    """Past STEGO_MAX_PAYLOAD_BYTES the encoder fails fast with the sizing
    math instead of attempting a multi-GB device allocation."""
    from streamz_tpu import config as cfg

    src = tmp_path / "huge.bin"
    with open(src, "wb") as f:
        f.truncate(cfg.STEGO_MAX_PAYLOAD_BYTES + 1)
    with pytest.raises(ValueError, match="capped at"):
        codec.encode_file(str(src))


def test_encode_attach_to_classifier_and_checkpoint(tmp_path):
    payload = b"hi!"
    src = tmp_path / "s.bin"
    src.write_bytes(payload)
    enc_net = codec.encode_file(str(src), max_epochs=200_000)

    clf = SpeakerNet.new(input_size=8, hidden1=4, hidden2=4, output=2, seed=0)
    w4, b4 = enc_net.encoding_layer()
    clf.set_encoding_layer(w4, b4)
    path = str(tmp_path / "model.npz")
    checkpoint.save(clf, path)
    loaded = checkpoint.load(path)
    got = codec.extract_file_from_classifier(loaded)
    assert got[: len(payload)] == payload


def test_decode_respects_checksum_override(tmp_path):
    payload = b"xyz"
    src = tmp_path / "s.bin"
    src.write_bytes(payload)
    enc_net = codec.encode_file(str(src), max_epochs=200_000)
    w4, b4 = enc_net.encoding_layer()
    # Different checksum -> different hidden key -> garbage out.
    codec.config.set_checksum_constant_override("ab" * 64)
    try:
        wrong = codec.extract_file(w4, b4)
    finally:
        codec.config.set_checksum_constant_override(config.CHECKSUM_CONSTANT)
    right = codec.extract_file(w4, b4)
    assert right[: len(payload)] == payload
    assert wrong[: len(payload)] != payload


def test_sha512_trigger(tmp_path, monkeypatch):
    from streamz_tpu.io import audio
    monkeypatch.chdir(tmp_path)
    audio.CHECKSUM_TRIGGERED.clear()
    blob = b"not really an mp3"
    import hashlib
    config.set_checksum_constant_override(hashlib.sha512(blob).hexdigest())
    try:
        p = tmp_path / "trigger.mp3"
        p.write_bytes(blob)
        audio.cache_mp3_as_wav(str(p))  # decode fails but trigger still fires?
        # decode failure returns None before the hash check in the reference;
        # write a valid-enough flow: hash check happens after conversion, so
        # use the direct checker.
        audio._check_stego_trigger(str(p))
        assert audio.CHECKSUM_TRIGGERED.is_set()
    finally:
        config.set_checksum_constant_override(config.CHECKSUM_CONSTANT)
        audio.CHECKSUM_TRIGGERED.clear()


def test_encode_non_convergence_raises(tmp_path):
    """A run that exhausts max_epochs without bit-exact convergence must
    raise — it used to print success and store weights whose decode
    returned garbage, silently losing the payload."""
    src = tmp_path / "payload.bin"
    src.write_bytes(b"hello stego world, this will not converge instantly")
    with pytest.raises(RuntimeError, match="did not converge"):
        codec.encode_file(str(src), max_epochs=0)


def test_hex_to_bytes_rejects_whitespace_pairs():
    """int(' f', 16) would accept what Rust's from_str_radix rejects; the
    derived stego key must skip the same pairs the reference skips."""
    assert codec.hex_to_bytes("0a f") == b"\x0a"      # ' f' skipped
    assert codec.hex_to_bytes(" a0b") == b"\x0b"       # ' a' skipped, '0b' kept
    assert codec.hex_to_bytes("aabb") == b"\xaa\xbb"
