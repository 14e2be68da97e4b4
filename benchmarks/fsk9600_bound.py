"""FSK9600 sensitivity decomposition: is the inverted cell physics or loss?

VERDICT r4 weak-item #3: the BER matrix has FSK9600 (9600 Bd) recovering
NOTHING at 15 dB while FSK19200 — double the bit rate — recovers 1.0. This
harness decomposes the cell on shared waveforms:

  theory   the union-style minimum-distance asymptote for ML sequence
           detection of this exact passband CPFSK: d²_min is computed
           NUMERICALLY over all merged error events (difference sequences
           with equal mark counts — the 1000 Hz tone delta at 9600 Bd
           advances phase 5/48 cycle per bit, so unequal counts cannot
           re-merge before 48 net bits) up to length 6, minimized over all
           48 trellis phase states; Pb ≈ Q(d_min/2σ). NOTE this is the
           worst-state asymptote — the weakest event lives at specific
           states/data, so measured ML BER sits BELOW this line (event
           multiplicity < 1); it is a shape reference, not a floor.
  genie    exact ML sequence detection with GENIE channel knowledge:
           known phase (θ=0), known amplitude, exact bit boundaries — a
           standalone 48-state Viterbi on raw samples with branch metric
           Σx·h − ½‖h‖². No receiver can beat this on these captures.
  eq       the production discriminator + calibrated ISI equalizer
           (ops/fsk.fsk_demod_bits, mlse=False)
  prod     the full production receiver (+ raw-sample MLSE refinement,
           estimated phase/amplitude/timing)

plus production frame recovery per cell. The verdict this artifact records:
if prod ≈ genie, the inverted cell is PHYSICS of the reference's tone plan
(mark 1200 / space 2200 fixed from /root/reference/config.py while the GUI
scales baud to 9600 → h = 1000/9600 ≈ 0.104 cycles/bit, a fraction of
FSK19200's h = 8000/19200 ≈ 0.417) — not receiver loss.

Usage::

    JAX_PLATFORMS=cpu python benchmarks/fsk9600_bound.py \
        [--snrs 14,15,16,17,18] [--trials 4] [--payload 2000]
        [--out benchmarks/fsk9600_bound_results.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_modem_radio.utils.runtime import configure_compile_cache  # noqa: E402

configure_compile_cache()

import jax.numpy as jnp  # noqa: E402

from audio_modem_radio.framing import crc32, pack_frame, parse_frames  # noqa: E402
from audio_modem_radio.ops import fsk  # noqa: E402

SR, BAUD, MARK, SPACE = 96000, 9600.0, 1200.0, 2200.0
SPB = int(SR // BAUD)
N_STATES = 48  # gcd grid of the 1200/2200@spb=10 phase advances (ops/fsk.py)


def _tone_bit(f: float, phi0: float) -> np.ndarray:
    t = np.arange(SPB) / SR
    return np.sin(2 * np.pi * f * t + phi0)


def _advance(f: float) -> float:
    return 2 * np.pi * f * SPB / SR


def _synth(bits, phi0: float) -> np.ndarray:
    ph, out = phi0, []
    for b in bits:
        f = MARK if b else SPACE
        out.append(_tone_bit(f, ph))
        ph += _advance(f)
    return np.concatenate(out)


def d2_min_merged(max_len: int = 6) -> float:
    """Numerical minimum squared distance over merged error events."""
    best = None
    for L in range(2, max_len + 1):
        for b1 in itertools.product([0, 1], repeat=L):
            for b2 in itertools.product([0, 1], repeat=L):
                if b1[0] == b2[0] or sum(b1) != sum(b2):
                    continue
                for st in range(N_STATES):
                    phi0 = 2 * np.pi * st / N_STATES
                    d2 = float(np.sum((_synth(b1, phi0) - _synth(b2, phi0)) ** 2))
                    if best is None or d2 < best:
                        best = d2
    return best


def genie_mlse(noisy: np.ndarray, n_bits: int) -> np.ndarray:
    """Exact ML sequence detection with genie phase/amplitude/timing.

    48-state phase-trellis Viterbi on the raw samples; branch metric
    m(s,b) = Σ x·h_{s,b} − ½‖h_{s,b}‖² (amplitude genie-known = the
    modulator's, folded into h). Vectorized over states per step."""
    # Precompute per (state, bit): template correlation pieces. h depends on
    # the state phase φ_s: h = sin(wt + φ_s) = sin(wt)cosφ + cos(wt)sinφ.
    t = np.arange(SPB) / SR
    amp = 0.9  # fsk_modulate's output scale (ops/fsk.fsk_modulate)
    sins = np.stack([np.sin(2 * np.pi * f * t) for f in (MARK, SPACE)])  # (2, SPB)
    coss = np.stack([np.cos(2 * np.pi * f * t) for f in (MARK, SPACE)])
    phases = 2 * np.pi * np.arange(N_STATES) / N_STATES
    cphi, sphi = np.cos(phases), np.sin(phases)  # (S,)
    # ||h||^2 per (tone, state)
    e_ss = np.sum(sins * sins, axis=1)  # (2,)
    e_cc = np.sum(coss * coss, axis=1)
    e_sc = np.sum(sins * coss, axis=1)
    energy = (
        amp * amp
        * (
            e_ss[:, None] * cphi[None] ** 2
            + e_cc[:, None] * sphi[None] ** 2
            + 2 * e_sc[:, None] * cphi[None] * sphi[None]
        )
    )  # (2, S)
    adv = np.array(
        [int(round(MARK * SPB)) % SR, int(round(SPACE * SPB)) % SR]
    ) // (SR // N_STATES)  # grid steps per bit for (mark, space)

    x = noisy[: n_bits * SPB].reshape(n_bits, SPB)
    # Correlations per bit per tone: (n_bits, 2) for sin and cos pieces.
    xs = x @ sins.T  # (n_bits, 2)
    xc = x @ coss.T
    pm = np.zeros(N_STATES, np.float64)
    decisions = np.empty((n_bits, N_STATES), np.uint8)
    preds = [
        (np.arange(N_STATES) - adv[0]) % N_STATES,  # predecessor via mark (bit 1)
        (np.arange(N_STATES) - adv[1]) % N_STATES,
    ]
    for i in range(n_bits):
        # metric at PREDECESSOR state s for tone f: amp*(xs·cosφ_s + xc·sinφ_s) − ½E
        m1 = amp * (xs[i, 0] * cphi + xc[i, 0] * sphi) - 0.5 * energy[0]
        m0 = amp * (xs[i, 1] * cphi + xc[i, 1] * sphi) - 0.5 * energy[1]
        cand1 = pm[preds[0]] + m1[preds[0]]
        cand0 = pm[preds[1]] + m0[preds[1]]
        take1 = cand1 > cand0
        pm = np.where(take1, cand1, cand0)
        pm -= pm.max()
        decisions[i] = take1
    state = int(np.argmax(pm))
    bits = np.empty(n_bits, np.uint8)
    for i in range(n_bits - 1, -1, -1):
        b = decisions[i, state]
        bits[i] = b
        state = int((state - adv[0 if b else 1]) % N_STATES)
    return bits


def measure_cell(snr_db: float, payload_len: int, trials: int, seed: int,
                 d2min: float) -> dict:
    e_g = e_eq = e_p = n_tot = 0
    rec = 0
    amp2 = None
    for tr in range(trials):
        rng = np.random.default_rng(seed + 7919 * tr)
        payload = rng.integers(0, 256, payload_len, dtype=np.uint8).tobytes()
        framed = pack_frame("f.bin", payload, 0, 1, payload_len, crc32(payload))
        wave = np.asarray(fsk.fsk_modulate(framed, BAUD, MARK, SPACE, SR), np.float32)
        if amp2 is None:
            amp2 = 2 * float(np.mean(wave**2))
        sigma = float(np.sqrt(np.mean(wave**2) / 10 ** (snr_db / 10.0)))
        noisy = (wave + rng.normal(0.0, sigma, len(wave))).astype(np.float32)

        n_bits = len(wave) // SPB
        truth = genie_mlse(wave, n_bits)  # clean genie = transmitted stream
        e_g += int(np.sum(genie_mlse(noisy, n_bits) != truth))
        b_eq, _ = fsk.fsk_demod_bits(jnp.asarray(noisy), BAUD, MARK, SPACE, SR, mlse=False)
        b_p, _ = fsk.fsk_demod_bits(jnp.asarray(noisy), BAUD, MARK, SPACE, SR, mlse=True)
        e_eq += int(np.sum(np.asarray(b_eq)[:n_bits] != truth))
        e_p += int(np.sum(np.asarray(b_p)[:n_bits] != truth))
        n_tot += n_bits

        fr = parse_frames(fsk.fsk_demodulate(noisy, BAUD, MARK, SPACE, SR))
        rec += bool(fr and fr[0].data == payload)

    sigma2 = (amp2 / 2) / 10 ** (snr_db / 10.0)
    arg = math.sqrt(d2min * amp2 / 0.81 / (4 * sigma2))  # d2min computed at amp 0.9
    pb_theory = 0.5 * math.erfc(arg / math.sqrt(2.0))
    return {
        "snr_db": snr_db,
        "ebn0_db": snr_db + 10 * math.log10(SPB / 2.0),
        "ber_theory_dmin": pb_theory,
        "ber_genie_mlse": e_g / n_tot,
        "ber_disc_eq": e_eq / n_tot,
        "ber_prod": e_p / n_tot,
        "recovery_prod": rec / trials,
        "bits": n_tot,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snrs", default="14,15,16,17,18")
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--payload", type=int, default=2000)
    ap.add_argument("--out", default="benchmarks/fsk9600_bound_results.json")
    args = ap.parse_args()

    d2min = d2_min_merged()
    print(f"numerical merged-event d2_min (amp 0.9): {d2min:.4f}")

    rows = []
    for i, s in enumerate(float(x) for x in args.snrs.split(",")):
        row = measure_cell(s, args.payload, args.trials, 11000 + i, d2min)
        rows.append(row)
        print(
            f"SNR {s:5.1f} dB (Eb/N0 {row['ebn0_db']:5.1f}): "
            f"theory {row['ber_theory_dmin']:.2e}  genie {row['ber_genie_mlse']:.2e}  "
            f"eq {row['ber_disc_eq']:.2e}  prod {row['ber_prod']:.2e}  "
            f"rec {row['recovery_prod']:.2f}"
        )

    out = {
        "config": {
            "baud": BAUD, "mark": MARK, "space": SPACE, "samp_rate": SR,
            "payload": args.payload, "trials": args.trials,
            "d2_min_merged": d2min,
            "h_index": (SPACE - MARK) / BAUD,
        },
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
