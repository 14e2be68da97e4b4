"""Header-tolerant frame recovery: payload FEC heals payload bit errors, and
the tolerant scan + exact-validation ladder heals HEADER bit errors — the
case where the strict parser (and the whole reference pipeline,
/root/reference/decoder.py:142-208) loses the frame entirely."""

import os
import zlib

import numpy as np
import pytest

from audio_modem_radio.decoder import decode_from_buffer, recover_header_damaged
from audio_modem_radio.fec import wrap_fec
from audio_modem_radio.framing import (
    MAGIC,
    crc32,
    fuzzy_magic_positions,
    pack_frame,
    parse_frames_detailed,
    scan_frame_candidates,
)
from audio_modem_radio.modem import modulate
from audio_modem_radio.utils.compression import TAG_ZLIB


def _flip_bit(buf: bytes, byte_idx: int, bit: int = 0) -> bytes:
    b = bytearray(buf)
    b[byte_idx] ^= 1 << bit
    return bytes(b)


def _make_framed(seed=0, n=600, fec="convolutional"):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    compressed = TAG_ZLIB + zlib.compress(data, 9)
    payload = wrap_fec(compressed, fec)
    framed = pack_frame("tol.bin", payload, 0, 1, len(data), crc32(data))
    return framed, data, payload


def _recover(raw):
    frames, damaged = parse_frames_detailed(raw)
    # Contract: pass only VALID frames; a validated recovery supersedes the
    # damaged-path guess (callers drop the matching damaged entries).
    return frames, damaged, recover_header_damaged(raw, list(frames))


def test_fuzzy_magic_positions():
    raw = b"\x00" * 37 + MAGIC + b"\x00" * 20
    corrupted = _flip_bit(raw, 38, 3)  # second magic byte, one bit
    assert 37 in fuzzy_magic_positions(corrupted)
    assert 37 not in fuzzy_magic_positions(b"\x00" * 80)


def test_magic_corruption_payload_intact():
    """2 flipped magic bits: strict parser is blind; pcrc validates as-is."""
    framed, data, payload = _make_framed(seed=1)
    raw = b"\x55" * 11 + _flip_bit(_flip_bit(framed, 1, 2), 2, 7) + b"\x55" * 9
    frames, damaged, rec = _recover(raw)
    assert not frames and not damaged
    assert len(rec) == 1 and rec[0].data == payload


def test_name_len_corruption_fec_tag_anchor():
    """Corrupt name_len byte: the FECV tag at payload start re-anchors the
    header geometry."""
    framed, data, payload = _make_framed(seed=2)
    raw = _flip_bit(framed, 4, 6)  # name_len: 7 -> 71
    frames, damaged, rec = _recover(raw)
    assert not frames
    assert any(f.data == payload and f.name == "tol.bin" for f in rec)


def test_dlen_corruption_prefix_crc():
    """Corrupt dlen field: exact length recovered from the intact pcrc."""
    framed, data, payload = _make_framed(seed=3)
    meta_start = 4 + 1 + len("tol.bin")
    dlen_off = meta_start + 16  # 4 u32s in
    raw = _flip_bit(framed, dlen_off + 1, 5) + b"\x00" * 33  # trailing junk
    frames, damaged, rec = _recover(raw)
    assert not frames
    assert any(f.data == payload for f in rec)


def test_magic_and_payload_corruption_fec_reencode():
    """Magic AND payload bits corrupted: Viterbi heals the payload and the
    deterministic re-encode proves it against the header pcrc."""
    framed, data, payload = _make_framed(seed=4)
    hdr = len(framed) - len(payload)
    raw = _flip_bit(framed, 0, 1)
    for k in (10, 60, 111):  # payload bit errors, in the coded region
        raw = _flip_bit(raw, hdr + 4 + k, k % 8)
    frames, damaged, rec = _recover(raw)
    assert not frames and not damaged
    assert len(rec) == 1
    assert rec[0].data == payload  # healed back to the TX container bytes


def test_dlen_and_pcrc_corruption_fcrc_ladder():
    """dlen AND pcrc both corrupt: self-terminating decompress of the FEC
    output validates against the whole-file CRC."""
    framed, data, payload = _make_framed(seed=5)
    meta_start = 4 + 1 + len("tol.bin")
    raw = _flip_bit(framed, meta_start + 16, 4)  # dlen
    raw = _flip_bit(raw, meta_start + 20, 3)  # pcrc
    raw += b"\x13\x37" * 40  # trailing channel garbage in the span
    frames, damaged, rec = _recover(raw)
    assert not frames
    assert len(rec) == 1
    from audio_modem_radio.utils.compression import intelligent_decompress

    assert intelligent_decompress(rec[0].data) == data


def test_no_false_positives_on_noise():
    rng = np.random.default_rng(6)
    noise = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    assert recover_header_damaged(noise, []) == []


def test_no_duplicate_of_strict_parse():
    """An intact stream yields zero extra recoveries."""
    framed, data, payload = _make_framed(seed=7)
    frames, damaged, rec = _recover(framed)
    assert len(frames) == 1 and not damaged and rec == []


def test_candidate_scan_caps():
    """A stream dense with fuzzy magics stays bounded."""
    raw = (MAGIC + b"\x01" + b"x" * 40) * 500
    assert len(scan_frame_candidates(raw, limit=64)) <= 64


def test_retry_path_uses_recovery(tmp_path):
    """decode_with_retry applies the same recovery ladder per attempt."""
    from audio_modem_radio.decoder import decode_with_retry

    framed, data, payload = _make_framed(seed=9, n=400)
    corrupted = _flip_bit(framed, 2, 1)  # magic byte 3 (outside sync bits)
    wave = np.asarray(modulate("QPSK", corrupted, 4800), np.float32)
    saved = decode_with_retry(wave, "QPSK", 4800, recv_dir=str(tmp_path))
    assert len(saved) == 1
    with open(saved[0], "rb") as f:
        assert f.read() == data


def test_junk_candidates_do_not_starve_fec_budget(rng):
    """Untagged junk candidates (fuzzy magics over garbage headers) must not
    consume the FEC-validation budget — a real FEC recovery behind them has
    to still run (code-review regression)."""
    framed, data, payload = _make_framed(seed=13, n=500)
    # Real frame: corrupt 1 magic bit + 1 payload bit (needs the FEC rung).
    hdr = len(framed) - len(payload)
    target = _flip_bit(_flip_bit(framed, 2, 1), hdr + 40, 3)
    # Junk: 6 fuzzy-magic headers with sane-ish geometry and untagged payloads.
    rng2 = np.random.default_rng(4)
    junk = b""
    for i in range(6):
        fake = bytearray(MAGIC + bytes([4]) + b"fake")
        fake += rng2.integers(0, 256, 24, dtype=np.uint8).tobytes()  # meta
        fake += rng2.integers(0, 256, 60, dtype=np.uint8).tobytes()  # payload
        fake[1] ^= 0x01  # make the magic fuzzy (not exact)
        junk += bytes(fake)
    raw = junk + target
    frames, damaged = parse_frames_detailed(raw)
    rec = recover_header_damaged(raw, list(frames))
    assert any(f.name == "tol.bin" for f in rec), "real FEC recovery starved"


def test_random_corruption_never_emits_wrong_content(rng):
    """Property: under arbitrary random corruption, recovery either emits
    nothing or emits a frame whose content provably matches the original —
    the validation ladder is cryptographic, not heuristic."""
    from audio_modem_radio.utils.compression import intelligent_decompress

    framed, data, payload = _make_framed(seed=11, n=500)
    master = np.random.default_rng(99)
    emitted = 0
    for trial in range(40):
        b = bytearray(framed)
        n_flips = int(master.integers(1, 12))
        for _ in range(n_flips):
            pos = int(master.integers(0, len(b)))
            b[pos] ^= 1 << int(master.integers(0, 8))
        raw = bytes(b) + bytes(master.integers(0, 256, 64, dtype=np.uint8))
        frames, damaged = parse_frames_detailed(raw)
        rec = recover_header_damaged(raw, list(frames))
        for f in rec:
            emitted += 1
            final = intelligent_decompress(
                __import__("audio_modem_radio.decoder", fromlist=["_defec"])._defec(f.data)
            )
            assert final == data, f"trial {trial}: wrong recovered content"
    assert emitted >= 5  # the ladder must actually recover a decent fraction


def test_e2e_header_corruption_through_audio(tmp_path):
    """Corrupted-header frame modulated to audio round-trips to the original
    file through decode_from_buffer."""
    framed, data, payload = _make_framed(seed=8, n=400)
    corrupted = _flip_bit(_flip_bit(framed, 1, 2), 3, 4)  # 2 magic bits
    wave = np.asarray(modulate("QPSK", corrupted, 4800), np.float32)
    saved = decode_from_buffer(wave, "QPSK", 4800, recv_dir=str(tmp_path))
    assert len(saved) == 1
    with open(saved[0], "rb") as f:
        assert f.read() == data


def test_destroyed_magic_standalone_tag_anchor(tmp_path):
    """Round 3: when ALL four magic bytes die (8 flipped bits — beyond the
    fuzzy-magic tolerance), the FEC-container tag anchors the header
    geometry STANDALONE and the frame still recovers through real audio via
    the no-sync re-pack sweep. Exactly the case the sweep exists for."""
    framed, data, payload = _make_framed(seed=21, n=400)
    b = bytearray(framed)
    b[0] ^= 0x5A
    b[1] ^= 0xA5
    wave = np.asarray(modulate("QPSK", bytes(b), 4800), np.float32)
    saved = decode_from_buffer(wave, "QPSK", 4800, recv_dir=str(tmp_path))
    assert len(saved) == 1, "destroyed-magic frame not recovered"
    with open(saved[0], "rb") as f:
        assert f.read() == data


def test_tag_anchor_no_duplicate_names(tmp_path):
    """The standalone tag anchor admits every printable truncation of the
    name; the payload-identity dedupe must emit the frame ONCE, under its
    full name."""
    framed, data, payload = _make_framed(seed=22, n=300)
    b = bytearray(framed)
    b[0] ^= 0xFF
    b[1] ^= 0xFF
    raw = bytes(b)
    rec = recover_header_damaged(raw, [])
    assert [f.name for f in rec] == ["tol.bin"]


def test_multi_mb_fec_part_recovers_within_budget():
    """Round-4 ceiling raise (VERDICT #8): a 2 MB FEC-wrapped part with a
    corrupt magic recovers through the native C++ ACS Viterbi in seconds —
    the old 512 KB _MAX_FEC_VALIDATE cap skipped any such span outright."""
    import time

    from audio_modem_radio import native

    if not native.viterbi_available():
        pytest.skip("native Viterbi unavailable (no compiler); cap stays 512 KB")
    rng = np.random.default_rng(31)
    # 1 MB of incompressible data -> a ~2.1 MB coded FEC container span
    # (rate-1/2), 4x the old cap and within the new 4 MB one.
    data = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    payload = wrap_fec(TAG_ZLIB + zlib.compress(data, 1), "convolutional")
    framed = pack_frame("big.bin", payload, 0, 1, len(data), crc32(data))
    hdr = len(framed) - len(payload)
    raw = _flip_bit(framed, 0, 1)  # kill the magic
    for k in (100, 5000, 90001):  # plus coded-payload bit errors
        raw = _flip_bit(raw, hdr + 4 + k, k % 8)
    t0 = time.time()
    frames, damaged, rec = _recover(raw)
    dt = time.time() - t0
    assert not frames and len(rec) == 1
    assert rec[0].data == payload  # healed back to the TX container bytes
    assert dt < 5.0, f"2 MB header recovery took {dt:.1f}s (budget 5s)"
