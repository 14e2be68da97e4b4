"""Sequence-parallel (sharded single capture) tests on the 8-device CPU mesh."""

import numpy as np
import pytest

from audio_modem_radio.framing import crc32, pack_frame, parse_frames
from audio_modem_radio.modem import modulate
from audio_modem_radio.parallel.mesh import get_mesh
from audio_modem_radio.parallel.sequence import decode_capture_sharded

PAYLOAD = bytes(b"sequence parallel decode across the mesh " * 24)


def _tx(mode="QPSK", rate=4800, data=PAYLOAD):
    framed = pack_frame("sp.bin", data, 0, 1, len(data), crc32(data))
    return np.asarray(modulate(mode, framed, rate), np.float32)


@pytest.mark.parametrize("mode,rate", [("QPSK", 4800), ("QPSK", 9600), ("BPSK", 4800)])
def test_sharded_capture_roundtrip(mode, rate):
    wave = _tx(mode, rate)
    raw = decode_capture_sharded(wave, mode, rate, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_matches_single_device():
    from audio_modem_radio.ops.psk import qpsk_demodulate

    wave = _tx("QPSK", 4800)
    sharded = decode_capture_sharded(wave, "QPSK", 4800, get_mesh())
    single = qpsk_demodulate(wave, 4800, 3000.0)
    n = min(len(sharded), len(single))
    # Identical content over the common prefix (pad tails differ in length).
    assert sharded[:n] == single[:n]


def test_sharded_with_leading_silence():
    # A shard of pure silence must not derail the global offset consensus.
    wave = _tx("QPSK", 4800)
    padded = np.concatenate([np.zeros(len(wave), np.float32), wave])
    raw = decode_capture_sharded(padded, "QPSK", 4800, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_hell_roundtrip():
    """HELL through the sequence-parallel path (round 5): shards are padded
    to whole pixel windows so detection has no cross-shard coupling; glyph
    segmentation runs on the gathered pixel stream. Text modes yield TEXT
    bytes, like the batched text path."""
    from audio_modem_radio.ops.hell import hellschreiber_modulate

    text = "SEQUENCE PARALLEL HELL 123"
    wave = np.asarray(hellschreiber_modulate(text), np.float32)
    out = decode_capture_sharded(wave, "HELLSCHREIBER", 1200, get_mesh())
    assert out.decode("utf-8") == text


def test_sharded_neural_roundtrip():
    """NEURAL through the sequence-parallel path (round 5): distributed
    preamble matched filter (per-shard lag spans + halo + all_gather
    consensus), uniform chip-grid extraction, per-shard codebook argmax."""
    wave = _tx("NEURAL", 1200)
    raw = decode_capture_sharded(wave, "NEURAL", 1200, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_neural_with_leading_silence():
    """The preamble landing mid-capture (even straddling a shard boundary)
    must still win the distributed sync consensus."""
    wave = _tx("NEURAL", 1200)
    padded = np.concatenate([np.zeros(31337, np.float32), wave])
    raw = decode_capture_sharded(padded, "NEURAL", 1200, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_fsk_roundtrip():
    """Dual-tone FSK through the sequence-parallel path: ppermute row-overlap
    halo + psum offset consensus, then global magic sync."""
    wave = _tx("FSK1200", 1200)
    raw = decode_capture_sharded(wave, "FSK1200", 1200, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_fsk_with_leading_silence():
    wave = _tx("FSK1200", 1200)
    capture = np.concatenate([np.zeros(40_000, np.float32), wave])
    raw = decode_capture_sharded(capture, "FSK1200", 1200, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_fsk_matches_single_device():
    from audio_modem_radio.ops.fsk import fsk_demodulate

    wave = _tx("FSK1200", 1200)
    raw_sharded = decode_capture_sharded(wave, "FSK1200", 1200, get_mesh())
    raw_single = fsk_demodulate(wave, 1200, 1200.0, 2200.0, 96000)
    f_sh, f_si = parse_frames(raw_sharded), parse_frames(raw_single)
    assert f_sh and f_si and f_sh[0].data == f_si[0].data == PAYLOAD


def test_sharded_fsk_discriminator_config_raises():
    from audio_modem_radio.parallel.sequence import demod_fsk_capture_sharded

    with pytest.raises(ValueError, match="dual-tone"):
        demod_fsk_capture_sharded(
            np.zeros(96000, np.float32), 9600.0, 1200.0, 2200.0, get_mesh()
        )


def test_sharded_ofdm_roundtrip():
    """OFDM through the sequence-parallel path: S-sample row-overlap halo,
    per-shard window scoring psum-combined, boundary-differential ppermute."""
    wave = _tx("OFDM4", 4800)
    raw = decode_capture_sharded(wave, "OFDM4", 4800, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_ofdm_with_leading_silence():
    wave = _tx("OFDM8", 4800)
    capture = np.concatenate([np.zeros(50_000, np.float32), wave])
    raw = decode_capture_sharded(capture, "OFDM8", 4800, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_psk8_roundtrip():
    """D8PSK through the sequence-parallel path: the shared halo/consensus
    front end at 8th-power timing scores, then global derotation + sector
    decisions + 8-hypothesis rotation sync (round 4)."""
    wave = _tx("8PSK", 9600)
    raw = decode_capture_sharded(wave, "8PSK", 9600, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_psk8_with_leading_silence():
    wave = _tx("8PSK", 9600)
    capture = np.concatenate([np.zeros(60_000, np.float32), wave])
    raw = decode_capture_sharded(capture, "8PSK", 9600, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == PAYLOAD


def test_sharded_dsss_roundtrip():
    """DSSS through the sequence-parallel path: sharded RAW chip front end
    (chips sum coherently per bit BEFORE the differential), then global
    despread + chip-alignment consensus + DBPSK rotation sync (round 4)."""
    data = PAYLOAD[:256]
    wave = _tx("DSSS", 9600, data)
    raw = decode_capture_sharded(wave, "DSSS", 9600, get_mesh())
    frames = parse_frames(raw)
    assert frames and frames[0].data == data


def test_sharded_dsss_matches_single_device():
    from audio_modem_radio.ops.dsss import dsss_real_demodulate

    data = PAYLOAD[:256]
    wave = _tx("DSSS", 9600, data)
    raw_sharded = decode_capture_sharded(wave, "DSSS", 9600, get_mesh())
    raw_single = dsss_real_demodulate(wave, 9600, 3000.0, 96000)
    f_sh, f_si = parse_frames(raw_sharded), parse_frames(raw_single)
    assert f_sh and f_si and f_sh[0].data == f_si[0].data == data
