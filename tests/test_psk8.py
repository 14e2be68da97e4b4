"""Real D8PSK mode: tribit wire format, CFO-rotation sync, alias fallback.

The reference's "8PSK" transmits DQPSK and discards the third bit its own
efficiency map promises (/root/reference/modem.py:345, encoder.py:66-73);
ours is a real 8-phase differential mode (ops/psk.py) with the alias kept
behind ``modem.psk8_compat_alias`` plus a probe-gated receive fallback —
the same deviation pattern as real OFDM (COMPAT.md).
"""

import numpy as np
import pytest

import audio_modem_radio as amr
from audio_modem_radio.config import CONFIG
from audio_modem_radio.framing import crc32
from audio_modem_radio.ops.psk import (
    _GRAY8,
    _GRAY8_INV,
    PSK8_PREAMBLE_BITS,
    psk8_real_demodulate,
    psk8_real_modulate,
)

RNG = np.random.default_rng(7)


def _framed(n=400, name="p8.bin"):
    payload = RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
    return payload, amr.pack_frame(name, payload, 0, 1, n, crc32(payload))


def test_gray8_tables_consistent():
    assert sorted(_GRAY8.tolist()) == list(range(8))
    for t in range(8):
        assert _GRAY8[_GRAY8_INV[t]] == t
    # Reflected Gray: adjacent sectors differ in exactly one bit, so a
    # one-sector decision error costs one bit, not three.
    for k in range(8):
        assert bin(int(_GRAY8[k]) ^ int(_GRAY8[(k + 1) % 8])).count("1") == 1
    # Tribit-aligned magic: the preamble must be a whole number of tribits.
    assert len(PSK8_PREAMBLE_BITS) % 3 == 0


def test_psk8_throughput_is_three_bits_per_symbol():
    payload, framed = _framed(600)
    w8 = psk8_real_modulate(framed, 2400, 3000.0, 96000)
    wq = amr.modulate("QPSK", framed, 2400)
    # Same payload at the same baud: 2/3 the symbols (+ preamble delta).
    assert len(w8) < 0.72 * len(wq)


def test_psk8_roundtrip_clean_and_noisy():
    payload, framed = _framed()
    wave = np.asarray(psk8_real_modulate(framed, 1200, 3000.0, 96000), np.float32)
    frames = amr.parse_frames(psk8_real_demodulate(wave, 1200, 3000.0, 96000))
    assert frames and frames[0].data == payload

    cap = np.concatenate([np.zeros(9999, np.float32), wave, np.zeros(4096, np.float32)])
    cap = cap + 0.05 * RNG.normal(size=len(cap)).astype(np.float32)
    frames = amr.parse_frames(psk8_real_demodulate(cap, 1200, 3000.0, 96000))
    assert frames and frames[0].data == payload


def test_psk8_cfo_rotation_sync():
    """A carrier offset appears as a constant differential rotation on this
    wire format; the 8th-power derotation + 8-hypothesis rotation sync must
    absorb a few-Hz offset (the π/4 sector ambiguity relabels every Gray
    sector — undecodable without the rotation retry)."""
    payload, framed = _framed(300)
    wave = np.asarray(psk8_real_modulate(framed, 1200, 3000.0, 96000), np.float32)
    for off in (2.0, -3.0):
        frames = amr.parse_frames(
            psk8_real_demodulate(wave, 1200, 3000.0 + off, 96000)
        )
        assert frames and frames[0].data == payload, f"offset {off} Hz"


def test_psk8_noise_only_yields_nothing():
    noise = 0.1 * RNG.normal(size=1 << 18).astype(np.float32)
    assert amr.parse_frames(psk8_real_demodulate(noise, 1200, 3000.0, 96000)) == []


def test_registry_mode_real_by_default():
    payload, framed = _framed(512)
    wave = amr.modulate("8PSK", framed, 9600)
    frames = amr.parse_frames(amr.demodulate("8PSK", np.asarray(wave), 9600))
    assert frames and frames[0].data == payload


def test_alias_capture_decodes_via_probe_fallback():
    """A reference-style alias capture (DQPSK wire labeled 8PSK) must still
    decode: the real demod finds no magic, the short DQPSK probe does, and
    the alias demodulator reruns — the real-OFDM fallback pattern."""
    payload, framed = _framed(256)
    CONFIG.set("modem.psk8_compat_alias", True)
    try:
        wave_alias = amr.modulate("8PSK", framed, 9600)
    finally:
        CONFIG.set("modem.psk8_compat_alias", False)
    frames = amr.parse_frames(amr.demodulate("8PSK", np.asarray(wave_alias), 9600))
    assert frames and frames[0].data == payload


def test_compat_alias_wire_format_is_dqpsk():
    payload, framed = _framed(128)
    CONFIG.set("modem.psk8_compat_alias", True)
    try:
        wave = amr.modulate("8PSK", framed, 9600)
    finally:
        CONFIG.set("modem.psk8_compat_alias", False)
    ref = amr.modulate("QPSK", framed, 9600)
    # Alias at carrier 12 kHz vs QPSK registry at 3 kHz: same LENGTH (same
    # dibit count), different carrier — compare against the direct call.
    from audio_modem_radio.modem import psk8_modulate

    np.testing.assert_array_equal(
        np.asarray(wave), np.asarray(psk8_modulate(framed, 9600, 12000.0))
    )
    assert len(wave) == len(ref)


def test_psk8_batched_decode():
    payload, framed = _framed(500, name="b8.bin")
    wave = np.asarray(amr.modulate("8PSK", framed, 9600), np.float32)
    from audio_modem_radio.parallel.batch import decode_sample_batch

    n = 1 << 21
    batch = np.zeros((2, n), np.float32)
    batch[0, 1000 : 1000 + len(wave)] = wave[: n - 1000]
    batch[1, 37 : 37 + len(wave)] = wave[: n - 37]
    batch += 0.02 * RNG.normal(size=batch.shape).astype(np.float32)
    raws = decode_sample_batch(batch, "8PSK", 9600)
    for raw in raws:
        frames = amr.parse_frames(raw)
        assert frames and frames[0].data == payload


def test_psk8_nosync_streams_carry_the_frame():
    """The 8 relabeled no-sync streams must contain the frame bytes at SOME
    (stream, bit shift) — the rescue sweep's search space (the packed
    alignment is offset by the differential stream's bit phase, here 3·39
    preamble bits ≡ 5 mod 8)."""
    from audio_modem_radio.ops.psk import psk8_nosync_streams

    payload, framed = _framed(200, name="r8.bin")
    wave = np.asarray(psk8_real_modulate(framed, 1200, 3000.0, 96000), np.float32)
    streams = psk8_nosync_streams(wave, 1200, 3000.0, 96000)
    assert len(streams) == 8
    hits = []
    for i, s in enumerate(streams):
        bits = np.unpackbits(np.frombuffer(s, np.uint8))
        for k in range(8):
            if framed[4:40] in np.packbits(bits[k:]).tobytes():
                hits.append((i, k))
    assert hits


def test_psk8_magic_damage_rescue_e2e(tmp_path):
    """2 corrupted magic bits through real 8PSK audio recover bit-exact via
    the decoder's no-sync rescue ladder (decode_from_buffer ->
    _nosync_streams -> recover_header_damaged), the DQPSK header-tolerant
    guarantee extended to the tribit mode."""
    from audio_modem_radio.decoder import decode_from_buffer

    payload, framed = _framed(200, name="h8.bin")
    bad = bytearray(framed)
    bad[1] ^= 0x20
    bad[2] ^= 0x01
    wave = np.asarray(amr.modulate("8PSK", bytes(bad), 1200), np.float32)
    saved = decode_from_buffer(wave, "8PSK", 1200, recv_dir=str(tmp_path / "recv"))
    assert saved, "rescue ladder recovered nothing"
    assert open(saved[0], "rb").read() == payload


def test_psk8_encode_decode_pipeline(tmp_path):
    """encoder.encode_file -> decoder.decode_wav_file, the user surface."""
    from audio_modem_radio.decoder import decode_wav_file
    from audio_modem_radio.encoder import encode_file

    payload = RNG.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    src = tmp_path / "doc8.bin"
    src.write_bytes(payload)
    wav = encode_file(str(src), mode="8PSK", cache_dir=str(tmp_path / "cache"))
    saved = decode_wav_file(wav, "8PSK", 9600, recv_dir=str(tmp_path / "recv"))
    assert saved, "no file recovered"
    assert open(saved[0], "rb").read() == payload
