"""Round 4 (VERDICT r3 #9): the waterfall-driven mode recommender.

The reference's recommender mirrors a static 5-profile table
(/root/reference/intelligent_communication.py:34-66) that can never pick
DSSS (measured 100% recovery at −9 dB) or 8PSK — the modes that now define
this framework's envelope. MODE_PROFILES is derived from the committed
measured floors (benchmarks/ber_results_r5.json; MEASURED_MIN_SNR carries
the provenance) over every real mode family; the reference behavior stays
available behind CONFIG ``intelligence.compat_profiles``.
"""

import json
import os

import numpy as np
import pytest

from audio_modem_radio.config import CONFIG
from audio_modem_radio.intelligence import (
    MEASURED_MIN_SNR,
    MODE_PROFILES,
    REFERENCE_MODE_PROFILES,
    get_recommended_mode,
    intelligent_encode_setup,
)


@pytest.fixture(autouse=True)
def _reset_compat():
    yield
    CONFIG.set("intelligence.compat_profiles", False)


def test_profiles_cover_every_real_mode_family():
    assert set(MODE_PROFILES) == set(MEASURED_MIN_SNR)
    for mode in ("DSSS", "8PSK", "OFDM4", "OFDM8", "HELLSCHREIBER",
                 "BPSK", "QPSK", "FSK1200", "FSK9600", "FSK19200", "NEURAL"):
        assert mode in MODE_PROFILES, mode
        prof = MODE_PROFILES[mode]
        assert prof["min_snr"] == MEASURED_MIN_SNR[mode]
        assert 0.0 <= prof["robustness"] <= 1.0
        assert 0.0 <= prof["speed"] <= 1.0


def test_floors_match_committed_matrix_artifact():
    """MEASURED_MIN_SNR == the waterfall floors recomputed from the
    committed round-5 matrix (benchmarks/ber_results_r5.json).

    Round 4 shipped a recommender one receiver-generation stale (VERDICT r4
    weak #2): the table's comment promised "regenerated from the artifact"
    but nothing enforced it. This test closes the loop — regenerating the
    matrix without refreshing the table (or vice versa) now fails the suite.
    """
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "benchmarks", "ber_results_r5.json",
    )
    cells = json.load(open(path))
    by_mode = {}
    for c in cells:
        by_mode.setdefault(c["mode"], []).append(
            (c["snr_db"], c["frame_recovery_rate"])
        )
    floors = {}
    for mode, rows in by_mode.items():
        rows.sort()
        # Floor = lowest swept SNR from which recovery stays 100%.
        floor = None
        for snr, rec in reversed(rows):
            if rec == 1.0:
                floor = snr
            else:
                break
        assert floor is not None, f"{mode}: no fully-recovered cell"
        floors[mode] = floor
    assert floors == MEASURED_MIN_SNR


def test_robustness_at_0db_recommends_dsss():
    """The verdict's acceptance criterion, verbatim."""
    assert get_recommended_mode({"snr_db": 0}, "robustness") == "DSSS"


def test_below_every_floor_still_returns_deepest_mode():
    assert get_recommended_mode({"snr_db": -20}, "robustness") == "DSSS"


def test_speed_at_high_snr_recommends_fastest_eligible():
    got = get_recommended_mode({"snr_db": 30}, "speed")
    assert got == "OFDM8"  # design-fastest family (reference encoder.py:69)


def test_compat_flag_restores_reference_behavior():
    CONFIG.set("intelligence.compat_profiles", True)
    # Reference table: nothing eligible below 8 dB -> FSK1200 fallback
    # (/root/reference/intelligent_communication.py:60-66).
    assert get_recommended_mode({"snr_db": 0}, "robustness") == "FSK1200"
    assert get_recommended_mode({"snr_db": 10}, "robustness") == "FSK1200"
    # DSSS/8PSK are unreachable in compat mode at any SNR.
    for snr in (0, 15, 40):
        got = get_recommended_mode({"snr_db": snr}, "robustness")
        assert got in REFERENCE_MODE_PROFILES or got == "FSK1200"


def test_recommended_low_snr_setup_roundtrips(tmp_path, monkeypatch, rng):
    """A robustness recommendation at low SNR yields an encoder setup that
    actually round-trips through its own channel regime."""
    monkeypatch.chdir(tmp_path)
    from audio_modem_radio.decoder import decode_from_buffer
    from audio_modem_radio.encoder import encode_file
    from audio_modem_radio.utils.wavio import read_wav

    setup = intelligent_encode_setup(500, priority="robustness",
                                     conditions={"snr_db": 0})
    assert setup["mode"] == "DSSS"
    data = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    src = tmp_path / "f.bin"
    src.write_bytes(data)
    wav = encode_file(str(src), **setup)
    samples, sr = read_wav(wav)
    p = float(np.mean(samples.astype(np.float64) ** 2))
    noisy = (samples + np.random.default_rng(7).normal(
        0, np.sqrt(p), len(samples))).astype(np.float32)  # 0 dB full-band
    saved = decode_from_buffer(noisy, setup["mode"], setup["symbol_rate"],
                               recv_dir=str(tmp_path / "r"), sample_rate=sr)
    assert saved and open(saved[0], "rb").read() == data
