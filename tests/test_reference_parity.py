"""Golden-fixture parity tests against the reference implementation.

``fixtures/reference_golden.npz`` holds waveforms produced by RUNNING the
reference's own modulators (numpy/scipy) on a known frame — captured once and
committed, so these tests need no access to the reference at run time. They
pin down two interoperability claims:

1. **Waveform parity** — our modulators generate (near-)sample-identical
   audio for the same bytes and configuration, so reference receivers hear
   the same signal.
2. **Cross-decode** — our receivers recover bit-exact payloads from
   reference-generated audio (the direction the reference itself often
   couldn't do: its logged QPSK self-decode failed, and its FSK9600
   demodulator crashes).
"""

import os

import numpy as np
import pytest

from audio_modem_radio.framing import parse_frames
from audio_modem_radio.ops.fsk import fsk_demodulate, fsk_modulate
from audio_modem_radio.ops.hell import hellschreiber_demodulate, hellschreiber_modulate
from audio_modem_radio.ops.psk import (
    bpsk_demodulate,
    bpsk_modulate,
    qpsk_demodulate,
    qpsk_modulate,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "reference_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


def _framed(golden) -> bytes:
    return golden["framed"].tobytes()


def _payload(golden) -> bytes:
    return golden["payload"].tobytes()


# --- 1. waveform parity --------------------------------------------------------

def test_bpsk_waveform_parity(golden):
    ours = bpsk_modulate(_framed(golden), baud=2400, carrier=3000.0)
    ref = golden["bpsk_2400"]
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 2e-5


@pytest.mark.parametrize("key,baud", [("qpsk_2400", 2400), ("qpsk_9600", 9600)])
def test_qpsk_waveform_parity(golden, key, baud):
    ours = qpsk_modulate(_framed(golden), baud=baud, carrier=3000.0)
    ref = golden[key]
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 2e-5


def test_fsk_waveform_parity(golden):
    # The reference accumulates phase in float mod 2π; ours is exact integer
    # cycle units — agreement to float32 rounding over the whole signal.
    ours = fsk_modulate(_framed(golden), baud=1200, mark_freq=1200.0, space_freq=2200.0)
    ref = golden["fsk_1200"]
    n = len(ref)  # ours carries one extra postamble byte
    assert len(ours) >= n
    assert np.max(np.abs(ours[:n] - ref)) < 1e-3


def test_fsk_high_speed_waveform_parity(golden):
    ours = fsk_modulate(_framed(golden), baud=19200, mark_freq=8000.0, space_freq=16000.0)
    ref = golden["fsk_19200"]
    n = len(ref)
    assert np.max(np.abs(ours[:n] - ref)) < 1e-3


def test_hellschreiber_waveform_parity(golden):
    ours = hellschreiber_modulate("HELLO GOLDEN 123")
    ref = golden["hell_wave"]
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 2e-5


# --- 2. cross-decode: reference-generated audio -> our receivers ---------------

def _assert_decodes(raw: bytes, golden):
    frames = parse_frames(raw)
    assert frames and frames[0].data == _payload(golden)


def test_decode_reference_bpsk(golden):
    _assert_decodes(bpsk_demodulate(golden["bpsk_2400"], baud=2400, carrier=3000.0), golden)


@pytest.mark.parametrize("key,baud", [("qpsk_2400", 2400), ("qpsk_9600", 9600)])
def test_decode_reference_qpsk(golden, key, baud):
    # The reference's OWN receiver cannot decode these (its logged self-test
    # failed); ours must.
    _assert_decodes(qpsk_demodulate(golden[key], baud=baud, carrier=3000.0), golden)


def test_decode_reference_fsk1200(golden):
    _assert_decodes(
        fsk_demodulate(golden["fsk_1200"], baud=1200, mark_freq=1200.0, space_freq=2200.0),
        golden,
    )


def test_decode_reference_fsk19200(golden):
    _assert_decodes(
        fsk_demodulate(golden["fsk_19200"], baud=19200, mark_freq=8000.0, space_freq=16000.0),
        golden,
    )


def test_decode_reference_hellschreiber(golden):
    assert hellschreiber_demodulate(golden["hell_wave"]) == "HELLO GOLDEN 123"
