"""FSK9600 inverted-cell verdict: the production receiver is ON the bound.

benchmarks/fsk9600_bound.py (round 5) decomposed the BER matrix's one
slower≠more-robust cell — FSK9600 recovering nothing at 15 dB while
FSK19200 recovers 1.0 — and attributed it to PHYSICS: the reference's
fixed 1200/2200 Hz tone plan gives h = 1000/9600 ≈ 0.104 cycles/bit at
9600 Bd, whose minimum merged-event distance caps even exact-ML sequence
detection (genie phase/amplitude/timing) at ~1.8e-3 BER at 15 dB
(measured genie 1.81e-3 vs production 1.82e-3 — the production MLSE sits
ON the genie bound). This test pins that property at one cell so a future
receiver regression (production drifting off the bound) is caught.

Reference anchor: /root/reference/config.py mark/space defaults;
/root/reference/encoder.py:284-296 (FSK9600 is default-reachable).
"""

import numpy as np
import jax.numpy as jnp

from audio_modem_radio.framing import crc32, pack_frame
from audio_modem_radio.ops import fsk

SR, BAUD, MARK, SPACE = 96000, 9600.0, 1200.0, 2200.0
SPB = 10


def test_production_mlse_near_genie_bound():
    """At 15 dB full-band SNR the production receiver's BER must stay
    within 2x of the measured genie exact-ML bound (1.81e-3; the harness
    measured production at 1.005x — 2x allows seed noise, while a receiver
    regression like losing MLSE shows up as ~28x (the eq-only rung))."""
    rng = np.random.default_rng(11000)
    payload = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    framed = pack_frame("f.bin", payload, 0, 1, 2000, crc32(payload))
    wave = np.asarray(fsk.fsk_modulate(framed, BAUD, MARK, SPACE, SR), np.float32)
    sigma = float(np.sqrt(np.mean(wave**2) / 10 ** (15.0 / 10.0)))
    noisy = (wave + rng.normal(0.0, sigma, len(wave))).astype(np.float32)

    n_bits = len(wave) // SPB
    truth, _ = fsk.fsk_demod_bits(jnp.asarray(wave), BAUD, MARK, SPACE, SR, mlse=False)
    truth = np.asarray(truth)[:n_bits]
    b_p, _ = fsk.fsk_demod_bits(jnp.asarray(noisy), BAUD, MARK, SPACE, SR, mlse=True)
    ber = float(np.mean(np.asarray(b_p)[:n_bits] != truth))
    assert ber < 2.0 * 1.81e-3, f"production BER {ber:.2e} drifted off the genie bound"
    # And MLSE must actually be doing the work: the eq-only rung is ~28x.
    b_eq, _ = fsk.fsk_demod_bits(jnp.asarray(noisy), BAUD, MARK, SPACE, SR, mlse=False)
    ber_eq = float(np.mean(np.asarray(b_eq)[:n_bits] != truth))
    assert ber_eq > 5.0 * ber, f"eq rung {ber_eq:.2e} vs prod {ber:.2e}"
