"""Property-based tests (hypothesis) for the wire formats.

The framing and compression containers define bit-exactness for everything
downstream (SURVEY.md §7 step 1); these properties fuzz them far beyond the
fixed-vector tests: random payloads round-trip, random garbage never crashes
the parser, frames embedded in noise are always found, and the native
scanner agrees with the Python parser on arbitrary byte streams
(differential fuzzing — TODO.md round-1 testing lead).
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from audio_modem_radio.framing import crc32, pack_frame, parse_frames_detailed
from audio_modem_radio.utils.compression import (
    delta_compress,
    delta_decompress,
    intelligent_compress,
    intelligent_decompress,
    super_compress,
)

# dlen=0 frames are rejected by the parser BY DESIGN (the reference's sanity
# bound is dlen in (0, 50MB], decoder.py:184) — so payloads start at 1 byte.
payloads = st.binary(min_size=1, max_size=4096)
names = st.text(
    alphabet=st.characters(min_codepoint=32, max_codepoint=126), min_size=1, max_size=40
)


@settings(max_examples=60, deadline=None)
@given(payloads, names)
def test_frame_roundtrip(payload, name):
    framed = pack_frame(name, payload, 0, 1, len(payload), crc32(payload))
    frames, damaged = parse_frames_detailed(framed)
    assert damaged == []
    assert len(frames) == 1
    assert frames[0].data == payload
    assert frames[0].name == name


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=0, max_size=8192))
def test_parser_never_crashes_on_garbage(blob):
    frames, damaged = parse_frames_detailed(blob)
    for f in frames:
        assert crc32(f.data) == f.part_crc


@settings(max_examples=40, deadline=None)
@given(payloads, st.binary(max_size=256), st.binary(max_size=256))
def test_frame_found_inside_noise(payload, prefix, suffix):
    framed = pack_frame("f.bin", payload, 0, 1, len(payload), crc32(payload))
    frames, _damaged = parse_frames_detailed(prefix + framed + suffix)
    assert any(f.data == payload for f in frames)


@settings(max_examples=80, deadline=None)
@given(payloads)
def test_compression_container_roundtrip(data):
    assert intelligent_decompress(intelligent_compress(data)) == data


@settings(max_examples=80, deadline=None)
@given(payloads)
def test_delta_roundtrip(data):
    assert delta_decompress(delta_compress(data)) == data


@settings(max_examples=40, deadline=None)
@given(payloads)
def test_super_compress_roundtrip(data):
    assert intelligent_decompress(super_compress(data)) == data


@settings(max_examples=40, deadline=None)
@given(st.binary(min_size=0, max_size=4096))
def test_native_scanner_matches_python(blob):
    """Differential fuzzing: the C++ scanner and the Python parser must agree
    on arbitrary byte streams (frames AND damaged-frame sets)."""
    from audio_modem_radio.native import NATIVE_AVAILABLE, scan_frames

    if not NATIVE_AVAILABLE:
        import pytest

        pytest.skip("native library not built")
    nf, nd = scan_frames(blob)
    pf, pd = parse_frames_detailed(blob)
    assert [(f.name, f.data) for f in nf] == [(f.name, f.data) for f in pf]
    assert [(f.name, f.data) for f in nd] == [(f.name, f.data) for f in pd]


@settings(max_examples=30, deadline=None)
@given(st.binary(min_size=1, max_size=1024), st.integers(0, 1 << 30))
def test_fec_roundtrip_and_bitflip(data, flip_pos):
    from audio_modem_radio.fec import unwrap_fec, wrap_fec

    blob = wrap_fec(data, "convolutional")
    assert unwrap_fec(blob) == data
    # A single corrupted mid-payload byte still decodes (rate-1/2 K=7
    # Viterbi); skip tiny blobs whose middle would hit the header/trailer.
    if len(blob) > 32:
        corrupt = bytearray(blob)
        idx = 12 + (flip_pos % (len(blob) - 24))
        corrupt[idx] ^= 0x10
        assert unwrap_fec(bytes(corrupt)) == data


def test_empty_payload_frame_rejected_like_reference():
    """dlen=0 frames never parse — the reference's own sanity bound
    (decoder.py:184) excludes them, preserved as wire-format parity."""
    framed = pack_frame("x", b"", 0, 1, 0, crc32(b""))
    frames, damaged = parse_frames_detailed(framed)
    assert frames == [] and damaged == []
