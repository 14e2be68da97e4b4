"""DSSS despread-stream decomposition: differential vs z² V&V tracking.

VERDICT r4 missing-item #1 / next-round #3: DSSS ends in differential DBPSK
on the despread stream (ops/dsss.py; the reference's "DSSS" is an unspread
DBPSK alias, /root/reference/modem.py:380-383). The despread 16-chip
coherent sums are BPSK phasors, so the round-4 single-carrier z² tracker
(ops/psk.bpsk_tracked_bits) applies verbatim; this harness measures what it
buys at the below-noise-floor operating envelope (the mode's POINT: −9 dB
recovery, −12 with margin — PERF.md DSSS row):

  theory   coherent BPSK at the post-despread per-bit Es/N0
           (full-band SNR + 10·log10(16·spchip/2)), doubled for
           differential ENCODING
  dd       the production differential-detection despread stream
  vv       the tracked stream (absolute antipodal decisions, XOR delta)

plus frame-recovery rows for both receivers. Usage::

    JAX_PLATFORMS=cpu python benchmarks/dsss_bound.py \
        [--snrs -9,-10,-11,-12,-13,-14] [--trials 10] [--payload 300]
        [--out benchmarks/dsss_bound_results.json]
"""

from __future__ import annotations

import argparse
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
from audio_modem_radio.ops import dsss  # noqa: E402
from audio_modem_radio.ops.psk import bpsk_tracked_bits  # noqa: E402


def _q(x: float) -> float:
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def _bit_streams(noisy: np.ndarray, baud: float, carrier: float, sr: int):
    """(dd_bits, vv_bits) differential-decoded bit streams off the despread
    front end (the receiver's own timing + chip-alignment selection)."""
    br, bi, _a = dsss._dsss_best_raw(jnp.asarray(noisy, jnp.float32), baud, carrier, sr)
    dr = br[1:] * br[:-1] + bi[1:] * bi[:-1]
    dd = np.asarray(dr < 0).astype(np.uint8)
    vv = np.asarray(bpsk_tracked_bits(br, bi))
    return dd, vv


def _aligned_errors(truth: np.ndarray, bits: np.ndarray, max_lag: int = 2):
    """(errors, n) at the best small bit-lag between truth and decoded.

    The noisy run's pass-1 timing may land a chip off the clean run's; the
    16-hypothesis despread alignment absorbs it, leaving the decoded BIT
    stream shifted by ±1 (and phasor-inverted, which both XOR-delta decodes
    cancel). Comparing at lag 0 scored that relabeling as 13-33% "BER" on
    cells whose frames recover 100% — the lag search measures actual bit
    errors. Lags beyond ±2 never occur (the timing search is sub-chip)."""
    best = None
    for lag in range(-max_lag, max_lag + 1):
        a = truth[max(0, lag) : len(truth) + min(0, lag)]
        b = bits[max(0, -lag) : len(bits) + min(0, -lag)]
        n = min(len(a), len(b))
        e = int(np.sum(a[:n] != b[:n]))
        if best is None or e < best[0]:
            best = (e, n)
    return best


def measure_cell(snr_db: float, payload_len: int, trials: int, baud: float,
                 carrier: float, sr: int, seed: int) -> dict:
    spchip = sr // int(baud)
    esn0_db = snr_db + 10 * math.log10(dsss.SPREAD * spchip / 2.0)
    pb_coh = _q(math.sqrt(2.0 * 10 ** (esn0_db / 10.0)))

    e_dd = e_vv = n_bits = 0
    rec_dd = rec_vv = 0
    for t in range(trials):
        rng = np.random.default_rng(seed + 7919 * t)
        payload = rng.integers(0, 256, payload_len, dtype=np.uint8).tobytes()
        framed = pack_frame("b.bin", payload, 0, 1, payload_len, crc32(payload))
        wave = np.asarray(dsss.dsss_real_modulate(framed, baud, carrier, sr), np.float32)
        sigma = float(np.sqrt(np.mean(wave**2) / 10 ** (snr_db / 10.0)))
        noisy = (wave + rng.normal(0.0, sigma, len(wave))).astype(np.float32)

        t_dd, t_vv = _bit_streams(wave, baud, carrier, sr)
        dd, vv = _bit_streams(noisy, baud, carrier, sr)
        e1, n1 = _aligned_errors(t_dd, dd)
        e2, _n2 = _aligned_errors(t_vv, vv)
        e_dd += e1
        e_vv += e2
        n_bits += n1

        fr = parse_frames(dsss.dsss_real_demodulate(noisy, baud, carrier, sr))
        rec_dd += bool(fr and fr[0].data == payload)
        fr = parse_frames(dsss.dsss_tracked_demodulate(noisy, baud, carrier, sr))
        rec_vv += bool(fr and fr[0].data == payload)

    return {
        "snr_db": snr_db,
        "esn0_db": esn0_db,
        "ber_theory_coh": pb_coh,
        "ber_theory_diffenc": 2 * pb_coh,
        "ber_dd": e_dd / n_bits,
        "ber_vv": e_vv / n_bits,
        "recovery_dd": rec_dd / trials,
        "recovery_vv": rec_vv / trials,
        "bits": n_bits,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snrs", default="-9,-10,-11,-12,-13,-14")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--payload", type=int, default=300)
    ap.add_argument("--baud", type=float, default=4800)
    ap.add_argument("--carrier", type=float, default=3000.0)
    ap.add_argument("--samp-rate", type=int, default=96000)
    ap.add_argument("--out", default="benchmarks/dsss_bound_results.json")
    args = ap.parse_args()

    rows = []
    for i, s in enumerate(float(x) for x in args.snrs.split(",")):
        row = measure_cell(
            s, args.payload, args.trials, args.baud, args.carrier,
            args.samp_rate, seed=9000 + i,
        )
        rows.append(row)
        print(
            f"SNR {s:6.1f} dB (Es/N0 {row['esn0_db']:5.1f}): "
            f"theory {row['ber_theory_diffenc']:.2e}  dd {row['ber_dd']:.2e} "
            f"(rec {row['recovery_dd']:.2f})  vv {row['ber_vv']:.2e} "
            f"(rec {row['recovery_vv']:.2f})"
        )

    out = {
        "config": {
            "baud": args.baud, "carrier": args.carrier,
            "samp_rate": args.samp_rate, "payload": args.payload,
            "trials": args.trials, "spread": dsss.SPREAD,
        },
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
