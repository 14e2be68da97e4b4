"""FBPC wire-format golden and round-trip tests."""

import struct

import pytest

from audio_modem_radio.framing import (
    MAGIC,
    Frame,
    crc32,
    pack_frame,
    parse_frames,
)


def test_pack_frame_golden_layout():
    # Byte-level layout must match the reference _frame_data exactly
    # (reference encoder.py:94-114).
    data = b"hello world"
    frame = pack_frame("a.txt", data, part_number=2, total_parts=5, file_size=999, file_crc=0xDEADBEEF)
    assert frame[:4] == b"FBPC"
    assert frame[4] == 5  # name length
    assert frame[5:10] == b"a.txt"
    part, total, fsize, fcrc, dlen, pcrc = struct.unpack("<IIIIII", frame[10:34])
    assert (part, total, fsize, fcrc) == (2, 5, 999, 0xDEADBEEF)
    assert dlen == len(data)
    assert pcrc == crc32(data)
    assert frame[34:] == data


def test_roundtrip_single():
    data = b"\x00\x01\x02" * 100
    raw = pack_frame("file.bin", data, 0, 1, len(data), crc32(data))
    frames = parse_frames(raw)
    assert len(frames) == 1
    f = frames[0]
    assert f.name == "file.bin"
    assert f.data == data
    assert not f.is_multipart
    assert f.final_crc == crc32(data)


def test_parse_skips_garbage_and_finds_frames_anywhere():
    data1, data2 = b"A" * 50, b"B" * 75
    raw = (
        b"\xaa" * 13
        + pack_frame("x", data1, 0, 2, 125, 7)
        + b"garbage FBPC not a frame"
        + pack_frame("x", data2, 1, 2, 125, 7)
        + b"\x00" * 9
    )
    frames = parse_frames(raw)
    assert [f.part_number for f in frames] == [0, 1]
    assert frames[0].data == data1 and frames[1].data == data2
    assert all(f.total_parts == 2 for f in frames)


def test_parse_rejects_corrupted_payload():
    data = b"payload-bytes" * 10
    raw = bytearray(pack_frame("f", data))
    raw[-3] ^= 0xFF  # flip a payload bit -> CRC mismatch
    assert parse_frames(bytes(raw)) == []


def test_parse_rejects_bad_headers():
    # zero name length
    bad = MAGIC + bytes([0]) + b"\x00" * 40
    assert parse_frames(bad) == []
    # zero-length payload
    raw = bytearray(pack_frame("f", b"x"))
    raw[10 + 1 + 4 * 4] = 0  # dlen low byte -> 0 (name len 1)
    assert parse_frames(bytes(raw)) == []
    # truncated payload
    good = pack_frame("f", b"0123456789")
    assert parse_frames(good[:-4]) == []


def test_name_truncated_to_255_bytes():
    raw = pack_frame("n" * 300, b"d" * 10)
    frames = parse_frames(raw)
    assert len(frames) == 1
    assert frames[0].name == "n" * 255


def test_max_payload_bound():
    # A header claiming > 50 MB payload is rejected even if bytes follow.
    hdr = MAGIC + bytes([1]) + b"f" + struct.pack("<IIIIII", 0, 1, 0, 0, 50_000_001, 0)
    assert parse_frames(hdr + b"\x00" * 64) == []


def test_multiple_overlapping_magic_candidates():
    # A payload that itself contains the magic must not confuse the parser.
    data = b"prefix" + MAGIC + b"suffix" * 5
    raw = pack_frame("tricky", data)
    frames = parse_frames(raw)
    assert len(frames) == 1
    assert frames[0].data == data


def test_absurd_total_parts_rejected_everywhere(rng):
    """A single flipped high bit in the header's ``total`` field must not
    reach the assembly layer (it once drove a ~8 GB [None]*total allocation):
    the parser bounds it (MAX_PARTS), and AssemblyRegistry.offer rejects it
    outright as defense in depth."""
    from audio_modem_radio.assembly import AssemblyRegistry
    from audio_modem_radio.framing import (
        MAX_PARTS, Frame, crc32, pack_frame, parse_frames_detailed,
    )

    import numpy as np

    payload = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    bad = pack_frame("x.bin", payload, 0, (1 << 30) + 1, len(payload), crc32(payload))
    frames, damaged = parse_frames_detailed(bad)
    assert frames == [] and damaged == []

    ok = pack_frame("x.bin", payload, 2, MAX_PARTS, len(payload), crc32(payload))
    frames, damaged = parse_frames_detailed(ok)
    assert len(frames) == 1 and frames[0].total_parts == MAX_PARTS

    reg = AssemblyRegistry()
    assert reg.offer(Frame("x.bin", payload, 0, (1 << 30) + 1, 64, 0)) is None
    assert ("x.bin", 0) not in getattr(reg, "_assemblies", {"": 0})
