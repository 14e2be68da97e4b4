"""BER parity harness regression tests (benchmarks/ber_parity.py).

Validates (a) the scipy oracle is byte-exact with the actual reference
demodulators, run directly from /root/reference when present, and (b) our
receivers beat-or-match the oracle on a noisy capture.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

REFERENCE_DIR = "/root/reference"


def _framed(payload: bytes) -> bytes:
    from audio_modem_radio.framing import crc32, pack_frame

    return pack_frame("p.bin", payload, 0, 1, len(payload), crc32(payload))


@pytest.mark.skipif(
    not os.path.isdir(REFERENCE_DIR), reason="reference snapshot not present"
)
def test_oracle_byte_exact_with_reference():
    """The oracle must reproduce the reference receivers byte-for-byte on
    clean AND noisy captures (otherwise the parity claim is hollow)."""
    sys.path.insert(0, REFERENCE_DIR)
    try:
        import modem as refmodem
    finally:
        sys.path.remove(REFERENCE_DIR)
    from reference_oracle import fsk_demodulate_ref, qpsk_demodulate_ref

    rng = np.random.default_rng(0)
    framed = _framed(rng.integers(0, 256, 200, dtype=np.uint8).tobytes())

    w = refmodem.fsk_modulate(framed, 600)
    noisy = w + rng.normal(0, 0.2, len(w))
    assert refmodem.fsk_demodulate(w, 600) == fsk_demodulate_ref(w, 600)
    assert refmodem.fsk_demodulate(noisy, 600) == fsk_demodulate_ref(noisy, 600)

    w = refmodem.qpsk_modulate(framed, 1200, 3600.0)
    noisy = w + rng.normal(0, 0.2, len(w))
    assert refmodem.qpsk_demodulate(w, 1200, 3600.0) == qpsk_demodulate_ref(w, 1200, 3600.0)
    assert refmodem.qpsk_demodulate(noisy, 1200, 3600.0) == qpsk_demodulate_ref(
        noisy, 1200, 3600.0
    )


def test_ours_at_least_as_good_as_reference_cell():
    """One low-SNR cell of the parity sweep: our FSK receiver's measured BER
    must not exceed the reference oracle's on the same noisy captures."""
    from ber_parity import _ber
    from reference_oracle import fsk_demodulate_ref

    from audio_modem_radio.ops.fsk import fsk_demodulate, fsk_modulate

    rng = np.random.default_rng(7)
    framed = _framed(rng.integers(0, 256, 300, dtype=np.uint8).tobytes())
    wave = np.asarray(fsk_modulate(framed, 1000), np.float64)
    sigma = np.sqrt(np.mean(wave**2) / 10 ** (-6 / 10))  # -6 dB full-band SNR

    ours, ref = [], []
    for _ in range(3):
        noisy = wave + rng.normal(0, sigma, len(wave))
        ours.append(_ber(framed, fsk_demodulate(noisy.astype(np.float32), 1000)))
        ref.append(_ber(framed, fsk_demodulate_ref(noisy, 1000)))
    assert np.mean(ours) <= np.mean(ref) + 1e-9


def test_alignment_free_ber_metric():
    from ber_parity import _ber

    sent = bytes(np.random.default_rng(1).integers(0, 256, 100, dtype=np.uint8))
    # Perfect copy with a 3-byte garbage prefix: BER 0 after alignment.
    assert _ber(sent, b"\x55\xAA\x00" + sent) == 0.0
    # Unrelated noise: ~0.5.
    noise = bytes(np.random.default_rng(2).integers(0, 256, 200, dtype=np.uint8))
    assert _ber(sent, noise) > 0.3
    # Empty/short output: 0.5 by definition.
    assert _ber(sent, b"") == 0.5


@pytest.mark.skipif(
    not os.path.isdir(REFERENCE_DIR), reason="reference snapshot not present"
)
def test_tx_oracles_byte_exact_with_reference():
    """The transmit oracles (round 4, bidirectional interop rows) must
    reproduce the reference modulators sample-for-sample."""
    sys.path.insert(0, REFERENCE_DIR)
    try:
        import hellschreiber as refhell
        import modem as refmodem
    finally:
        sys.path.remove(REFERENCE_DIR)
    from reference_oracle import (
        bpsk_modulate_ref,
        fsk_modulate_ref,
        hellschreiber_demodulate_ref,
        hellschreiber_modulate_ref,
        qpsk_modulate_ref,
    )

    rng = np.random.default_rng(3)
    framed = _framed(rng.integers(0, 256, 150, dtype=np.uint8).tobytes())

    for mine, ref in (
        (bpsk_modulate_ref(framed, 1200, 3000.0), refmodem.bpsk_modulate(framed, 1200, 3000.0)),
        (qpsk_modulate_ref(framed, 1200, 3600.0), refmodem.qpsk_modulate(framed, 1200, 3600.0)),
        (fsk_modulate_ref(framed, 600), refmodem.fsk_modulate(framed, 600)),
        (
            hellschreiber_modulate_ref("PARITY Test 123"),
            refhell.hellschreiber_modulate("PARITY Test 123"),
        ),
    ):
        mine = np.asarray(mine, np.float64)
        ref = np.asarray(ref, np.float64)
        assert mine.shape == ref.shape
        assert np.abs(mine - ref).max() < 1e-6

    # The Hellschreiber receive oracle matches the actual reference decoder.
    w = np.asarray(refhell.hellschreiber_modulate("HELLO xyz 42"))
    assert hellschreiber_demodulate_ref(w) == refhell.hellschreiber_demodulate(w)


def test_interop_our_rx_decodes_reference_wire():
    """Wire-interop spot checks: our receivers decode reference-TX captures —
    including the ramped DBPSK wire the reference's own receiver cannot
    decode, and the DSSS/8PSK alias wire through the probe-gated production
    surfaces (reference modem.py:345-348, 380-383)."""
    from reference_oracle import bpsk_modulate_ref, qpsk_modulate_ref

    from audio_modem_radio.framing import parse_frames
    from audio_modem_radio.modem import (
        _dsss_mode_demodulate,
        _psk8_mode_demodulate,
        bpsk_demodulate,
    )

    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, 120, dtype=np.uint8).tobytes()
    framed = _framed(payload)

    # Reference DBPSK TX -> our DBPSK RX.
    w = bpsk_modulate_ref(framed, 1200, 3000.0).astype(np.float32)
    frames = parse_frames(bpsk_demodulate(w, 1200, 3000.0))
    assert frames and frames[0].data == payload

    # Reference DBPSK TX (the DSSS alias wire) -> probe-gated DSSS surface.
    frames = parse_frames(_dsss_mode_demodulate(w, 1200, 3000.0))
    assert frames and frames[0].data == payload

    # Reference DQPSK TX (the 8PSK alias wire) -> probe-gated 8PSK surface.
    w = qpsk_modulate_ref(framed, 1200, 3600.0).astype(np.float32)
    frames = parse_frames(_psk8_mode_demodulate(w, 1200, 3600.0))
    assert frames and frames[0].data == payload
