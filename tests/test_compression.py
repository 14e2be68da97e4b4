"""Tagged compression container and delta codec tests."""

import numpy as np
import pytest

from audio_modem_radio.utils.compression import (
    IntelligentCompressor,
    adaptive_compress,
    compress_data,
    decompress_data,
    delta_compress,
    delta_decompress,
    intelligent_compress,
    intelligent_decompress,
    super_compress,
    super_decompress,
)


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"x",
        b"hello world " * 100,
        bytes(range(256)) * 20,
        np.random.default_rng(0).integers(0, 256, 5000, dtype=np.uint8).tobytes(),
    ],
)
def test_intelligent_roundtrip(data):
    assert intelligent_decompress(intelligent_compress(data)) == data


def test_small_payloads_ship_raw():
    blob = intelligent_compress(b"tiny")
    assert blob.startswith(b"RAW")
    assert intelligent_decompress(blob) == b"tiny"


@pytest.mark.parametrize("mode", ["lzma", "delta+lzma", "zlib"])
def test_explicit_modes_roundtrip(mode):
    data = b"some compressible data, repeated. " * 50
    blob = intelligent_compress(data, mode=mode)
    tag = {"lzma": b"LZMA", "delta+lzma": b"DLZM", "zlib": b"ZLIB"}[mode]
    assert blob.startswith(tag)
    assert intelligent_decompress(blob) == data


def test_unknown_tag_falls_back():
    import zlib

    data = b"fallback payload " * 20
    assert intelligent_decompress(zlib.compress(data)) == data  # bare zlib
    assert intelligent_decompress(b"\x01\x02\x03not-compressed") == b"\x01\x02\x03not-compressed"


def test_delta_codec_roundtrip(rng):
    for n in (0, 1, 2, 17, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert delta_decompress(delta_compress(data)) == data


def test_delta_helps_monotone_data():
    import zlib

    ramp = bytes((i // 7) & 0xFF for i in range(10000))
    assert len(zlib.compress(delta_compress(ramp), 9)) <= len(zlib.compress(ramp, 9))


def test_super_compress_roundtrip():
    for data in (b"short", b"A" * 10_000, bytes(range(256)) * 64):
        assert super_decompress(super_compress(data)) == data


def test_adaptive_compress_roundtrip():
    data = b"payload " * 1000
    for mode in ("8PSK", "FSK19200", "QPSK", "FSK1200"):
        blob = adaptive_compress(data, mode)
        if mode in ("8PSK", "FSK19200"):
            assert super_decompress(blob) == data
        else:
            assert decompress_data(blob) == data


def test_plain_zlib_helpers():
    data = b"plain zlib " * 100
    assert decompress_data(compress_data(data)) == data
    assert decompress_data(b"not zlib at all") == b"not zlib at all"


def test_analyzer_recommendations():
    c = IntelligentCompressor()
    assert c.analyze_data_pattern(b"x" * 50)["recommended"] == "none"
    assert c.analyze_data_pattern(b"\x00" * 5000)["recommended"] == "lzma"  # low entropy
    text = ("the quick brown fox jumps over the lazy dog %d\n" % 7).encode() * 200
    assert c.analyze_data_pattern(text)["recommended"] in ("zlib", "lzma")
    noise = np.random.default_rng(3).integers(0, 256, 8192, dtype=np.uint8).tobytes()
    assert c.analyze_data_pattern(noise)["recommended"] == "delta+lzma"
