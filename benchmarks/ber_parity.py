"""BER parity: our receivers vs the reference's scipy receivers.

Closes BASELINE.md's correctness clause ("BER / decoded-file bit-exactness
parity vs the CPU reference") with data: for every reference-reachable
physical config, run BOTH receivers over the SAME noisy captures and compare
BER + frame recovery at each SNR — in BOTH wire directions where the
reference transmitter functions (our TX -> both RX, and reference TX -> both
RX), so the rows double as bidirectional wire-interop proof.

The reference oracle (reference_oracle.py) is byte-exact with the actual
reference demodulators — validated by importing /root/reference/modem.py and
comparing outputs on clean and noisy captures (see test_ber_parity.py).

Covered configs (round 4 widens VERDICT r3 missing #2):

* FSK 600/1000 Bd at the 1200/2200 Hz tone plan (reference modem.py:298-341).
* FSK19200-class high-separation tones 8000/16000 Hz
  (fsk_high_speed_modulate, modem.py:351-356).
* DQPSK at integer carrier/baud ratios (3600/1200, 7200/2400) — the configs
  where the reference's per-symbol sine restart (modem.py:177-184) is
  phase-consistent and its receiver functions.
* DBPSK at its own 3000 Hz / 1200 Bd default (modem.py:28-135). The
  reference receiver samples at exact symbol boundaries where its own 10%
  edge ramp zeroes the waveform, so its recovery is ~0 even on clean
  captures — the rows RECORD that (ours must be >= it, trivially and
  non-trivially: our receiver decodes the reference's ramped TX wire).
* Hellschreiber text fax (hellschreiber.py:109-186), scored by decoded-text
  similarity instead of frame recovery (the mode is unframed).
* The 8PSK and DSSS ALIAS wire formats (modem.py:345-348, 380-383 — DQPSK
  and DBPSK respectively): our TX side uses the package's alias modulators,
  and our RX side is the PROBE-GATED production surface (real D8PSK/DSSS
  receive first, auto-fallback to the alias wire on probe hit) — so these
  rows also prove the alias autodetection under noise.

Configs still excluded (reference TX and RX both nonfunctional, nothing to
interop with): DQPSK at fractional carrier/baud (each symbol restarts its
sine at t=0, modem.py:177-184, so downconversion sees a constant extra
rotation per symbol the π/4 sector map cannot absorb — its receiver cannot
decode its own clean TX); CPFSK with mark - baud <= 0 (scipy butter raises
on a zero critical frequency, modem.py:306 has no clamp).

Usage::

    python benchmarks/ber_parity.py [--snrs 4,6,8,10,14] [--trials 5]
        [--payload 600] [--out benchmarks/ber_parity_results.json]
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import sys
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio_modem_radio.utils.runtime import configure_compile_cache  # noqa: E402

configure_compile_cache()


def _configs() -> List[Dict]:
    """Reference-reachable configs. Keys: ``mod``/``ours`` our TX/RX,
    ``ref`` the oracle RX, ``ref_mod`` the oracle TX (None = reference TX
    direction skipped), ``text`` = unframed text mode."""
    from audio_modem_radio.modem import (
        _dsss_mode_demodulate,
        _psk8_mode_demodulate,
        bpsk_demodulate,
        bpsk_modulate,
        dsss_modulate,
        psk8_modulate,
    )
    from audio_modem_radio.ops.fsk import fsk_demodulate, fsk_modulate
    from audio_modem_radio.ops.hell import (
        hellschreiber_demodulate,
        hellschreiber_modulate,
    )
    from audio_modem_radio.ops.psk import qpsk_demodulate, qpsk_modulate

    from reference_oracle import (
        bpsk_demodulate_ref,
        bpsk_modulate_ref,
        fsk_demodulate_ref,
        fsk_modulate_ref,
        hellschreiber_demodulate_ref,
        hellschreiber_modulate_ref,
        qpsk_demodulate_ref,
        qpsk_modulate_ref,
    )

    return [
        {
            "name": "FSK 600Bd 1200/2200",
            "mod": lambda d: fsk_modulate(d, 600),
            "ours": lambda s: fsk_demodulate(s, 600),
            "ref": lambda s: fsk_demodulate_ref(s, 600),
            "ref_mod": lambda d: fsk_modulate_ref(d, 600),
        },
        {
            "name": "FSK 1000Bd 1200/2200",
            "mod": lambda d: fsk_modulate(d, 1000),
            "ours": lambda s: fsk_demodulate(s, 1000),
            "ref": lambda s: fsk_demodulate_ref(s, 1000),
            "ref_mod": lambda d: fsk_modulate_ref(d, 1000),
        },
        {
            # fsk_high_speed_* tone plan (reference modem.py:351-356); run at
            # 4800 Bd so the oracle's per-bit majority window spans >=4
            # samples (at 19200 Bd its own receiver is sample-starved).
            "name": "FSK-HS 4800Bd 8000/16000",
            "mod": lambda d: fsk_modulate(d, 4800, 8000.0, 16000.0),
            "ours": lambda s: fsk_demodulate(s, 4800, 8000.0, 16000.0),
            "ref": lambda s: fsk_demodulate_ref(s, 4800, 8000.0, 16000.0),
            "ref_mod": lambda d: fsk_modulate_ref(d, 4800, 8000.0, 16000.0),
        },
        {
            "name": "QPSK 1200Bd c=3600",
            "mod": lambda d: qpsk_modulate(d, 1200, 3600.0),
            "ours": lambda s: qpsk_demodulate(s, 1200, 3600.0),
            "ref": lambda s: qpsk_demodulate_ref(s, 1200, 3600.0),
            "ref_mod": lambda d: qpsk_modulate_ref(d, 1200, 3600.0),
        },
        {
            "name": "QPSK 2400Bd c=7200",
            "mod": lambda d: qpsk_modulate(d, 2400, 7200.0),
            "ours": lambda s: qpsk_demodulate(s, 2400, 7200.0),
            "ref": lambda s: qpsk_demodulate_ref(s, 2400, 7200.0),
            "ref_mod": lambda d: qpsk_modulate_ref(d, 2400, 7200.0),
        },
        {
            "name": "DBPSK 1200Bd c=3000",
            "mod": lambda d: bpsk_modulate(d, 1200, 3000.0),
            "ours": lambda s: bpsk_demodulate(s, 1200, 3000.0),
            "ref": lambda s: bpsk_demodulate_ref(s, 1200, 3000.0),
            "ref_mod": lambda d: bpsk_modulate_ref(d, 1200, 3000.0),
        },
        {
            # Alias wire format (reference modem.py:345-348): DQPSK on the
            # wire; our RX is the production probe-gated 8PSK surface.
            "name": "8PSK-alias 1200Bd c=3600",
            "mod": lambda d: psk8_modulate(d, 1200, 3600.0),
            "ours": lambda s: _psk8_mode_demodulate(s, 1200, 3600.0),
            "ref": lambda s: qpsk_demodulate_ref(s, 1200, 3600.0),
            "ref_mod": lambda d: qpsk_modulate_ref(d, 1200, 3600.0),
        },
        {
            # Alias wire format (reference modem.py:380-383): plain DBPSK on
            # the wire; our RX is the production probe-gated DSSS surface.
            "name": "DSSS-alias 1200Bd c=3000",
            "mod": lambda d: dsss_modulate(d, 1200, 3000.0),
            "ours": lambda s: _dsss_mode_demodulate(s, 1200, 3000.0),
            "ref": lambda s: bpsk_demodulate_ref(s, 1200, 3000.0),
            "ref_mod": lambda d: bpsk_modulate_ref(d, 1200, 3000.0),
        },
        {
            "name": "HELL 122.5Bd c=1000",
            "text": True,
            "mod": lambda t: hellschreiber_modulate(t),
            "ours": lambda s: hellschreiber_demodulate(s),
            "ref": lambda s: hellschreiber_demodulate_ref(s),
            "ref_mod": lambda t: hellschreiber_modulate_ref(t),
        },
    ]


def _ber(sent_framed: bytes, raw: bytes) -> float:
    """Alignment-free BER: correlate the receiver's output bits against the
    transmitted frame bits and score the best overlap.

    Both receivers return magic-synced byte streams whose alignment can be
    off by a few bits under noise; locating the payload by the magic bytes
    (as ber.py does) then misreads everything after a sync slip. Correlating
    ±1 bit sequences finds the true alignment regardless of which receiver
    slipped, so the comparison is fair to both.
    """
    sent = np.unpackbits(np.frombuffer(sent_framed, np.uint8)).astype(np.int8) * 2 - 1
    got = np.unpackbits(np.frombuffer(raw, np.uint8)).astype(np.int8) * 2 - 1
    if len(got) < 64:
        return 0.5
    n = max(len(sent), len(got))
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    corr = np.fft.irfft(
        np.fft.rfft(got, nfft) * np.conj(np.fft.rfft(sent, nfft)), nfft
    )
    shift = int(np.argmax(corr))  # got[shift + i] ~ sent[i] (mod nfft)
    idx = shift + np.arange(len(sent))
    valid = idx < len(got)
    if valid.sum() < len(sent) // 2:
        return 0.5
    matches = got[idx[valid]] == sent[: len(sent)][valid]
    errors = np.sum(~matches) + 0.5 * np.sum(~valid)
    return float(min(errors / len(sent), 0.5))


def _noisy(wave: np.ndarray, snr_db: float, rng) -> np.ndarray:
    w = np.asarray(wave, np.float64)
    p_sig = float(np.mean(w**2))
    sigma = np.sqrt(p_sig / 10 ** (snr_db / 10))
    return w + rng.normal(0, sigma, len(w))


def _measure_frame_cell(cfg, snr_db: float, trials: int, payload_len: int) -> Dict:
    from audio_modem_radio.framing import crc32, pack_frame, parse_frames

    rng = np.random.default_rng(hash((cfg["name"], snr_db)) % (2**32))
    directions = [("", cfg["mod"])]
    if cfg.get("ref_mod") is not None:
        directions.append(("_reftx", cfg["ref_mod"]))
    cell: Dict = {"config": cfg["name"], "snr_db": snr_db, "trials": trials}
    for suffix, tx in directions:
        bers = {"ours": [], "ref": []}
        rec = {"ours": 0, "ref": 0}
        for _ in range(trials):
            payload = rng.integers(0, 256, payload_len, dtype=np.uint8).tobytes()
            framed = pack_frame("p.bin", payload, 0, 1, payload_len, crc32(payload))
            noisy = _noisy(np.asarray(tx(framed), np.float64), snr_db, rng)
            for side in ("ours", "ref"):
                raw = cfg[side](noisy.astype(np.float32) if side == "ours" else noisy)
                frames = parse_frames(raw)
                if any(f.data == payload for f in frames):
                    rec[side] += 1
                    bers[side].append(0.0)
                else:
                    bers[side].append(_ber(framed, raw))
        cell[f"ber_ours{suffix}"] = float(np.mean(bers["ours"]))
        cell[f"ber_ref{suffix}"] = float(np.mean(bers["ref"]))
        cell[f"recovery_ours{suffix}"] = rec["ours"] / trials
        cell[f"recovery_ref{suffix}"] = rec["ref"] / trials
    return cell


def _measure_text_cell(cfg, snr_db: float, trials: int, n_chars: int = 48) -> Dict:
    """Unframed text mode (Hellschreiber): decoded-text similarity
    (difflib ratio — alignment-tolerant, fair to both receivers)."""
    rng = np.random.default_rng(hash((cfg["name"], snr_db)) % (2**32))
    directions = [("", cfg["mod"])]
    if cfg.get("ref_mod") is not None:
        directions.append(("_reftx", cfg["ref_mod"]))
    cell: Dict = {"config": cfg["name"], "snr_db": snr_db, "trials": trials, "text": True}
    for suffix, tx in directions:
        acc = {"ours": [], "ref": []}
        for _ in range(trials):
            text = "".join(chr(c) for c in rng.integers(33, 127, n_chars))
            noisy = _noisy(np.asarray(tx(text), np.float64), snr_db, rng)
            for side in ("ours", "ref"):
                got = cfg[side](noisy.astype(np.float32) if side == "ours" else noisy)
                acc[side].append(difflib.SequenceMatcher(None, text, got).ratio())
        cell[f"acc_ours{suffix}"] = float(np.mean(acc["ours"]))
        cell[f"acc_ref{suffix}"] = float(np.mean(acc["ref"]))
        # Recovery-style fields so the parity gate below is uniform: a text
        # cell "recovers" when similarity >= 0.95.
        cell[f"recovery_ours{suffix}"] = float(
            np.mean([a >= 0.95 for a in acc["ours"]])
        )
        cell[f"recovery_ref{suffix}"] = float(np.mean([a >= 0.95 for a in acc["ref"]]))
        cell[f"ber_ours{suffix}"] = 1.0 - cell[f"acc_ours{suffix}"]
        cell[f"ber_ref{suffix}"] = 1.0 - cell[f"acc_ref{suffix}"]
    return cell


def run(snrs: List[float], trials: int, payload_len: int) -> List[Dict]:
    results = []
    for cfg in _configs():
        for snr_db in snrs:
            if cfg.get("text"):
                cell = _measure_text_cell(cfg, snr_db, trials)
            else:
                cell = _measure_frame_cell(cfg, snr_db, trials, payload_len)
            results.append(cell)
            for suffix, lbl in (("", "ourTX"), ("_reftx", "refTX")):
                if f"ber_ours{suffix}" not in cell:
                    continue
                print(
                    f"{cfg['name']:>26} @ {snr_db:5.1f} dB {lbl}: "
                    f"BER ours={cell[f'ber_ours{suffix}']:.2e} "
                    f"ref={cell[f'ber_ref{suffix}']:.2e}  "
                    f"rec ours={cell[f'recovery_ours{suffix}']:.2f} "
                    f"ref={cell[f'recovery_ref{suffix}']:.2f}",
                    flush=True,
                )
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snrs", default="4,6,8,10,14")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--payload", type=int, default=600)
    ap.add_argument(
        "--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "ber_parity_results.json")
    )
    args = ap.parse_args()

    snrs = [float(s) for s in args.snrs.split(",")]
    results = run(snrs, args.trials, args.payload)

    worse = []
    for r in results:
        for suffix in ("", "_reftx"):
            if f"ber_ours{suffix}" not in r:
                continue
            if (
                r[f"ber_ours{suffix}"] > r[f"ber_ref{suffix}"] + 1e-9
                or r[f"recovery_ours{suffix}"] < r[f"recovery_ref{suffix}"]
            ):
                worse.append({**r, "direction": suffix or "_ourtx"})
    summary = {
        "results": results,
        "parity": not worse,
        "worse_cells": worse,
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\nparity={'PASS' if not worse else 'FAIL'} -> {args.out}")
    return 0 if not worse else 1


if __name__ == "__main__":
    sys.exit(main())
