"""Randomized end-to-end chaos sweep over the whole mode surface.

Encodes random payloads in random data modes x symbol rates, applies random
channel impairments (leading silence, AWGN, gain+clipping, a 48 kHz
resample round trip), and decodes. Reports per-seed OK/LOST/CRASH tallies;
``--ladder`` replays every direct-path loss through the full
``decode_from_buffer`` recovery ladder.

This is the sweep that found the round-3 receiver tail-truncation bugs
(floor-vs-ceil symbol counts in the PSK and OFDM receivers — a
fractional-symbol lead corrupted the frame's final dibits), so it stays
in-tree as a regression harness. Mirrors the reference's only QA procedure
(manual encode-play-decode loops, /root/reference/filebeep_system.log) at
scale and with adversarial channels.

Expected losses are physics, not bugs: modes whose spectra extend past
24 kHz (MSK/QPSK-family at 19200 Bd, NEURAL) cannot survive the 48 kHz
resample's low-pass, and FSK9600 below ~20 dB SNR sits above the
full-frame CRC loss threshold (see benchmarks/ber_results.json).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from audio_modem_radio.utils.runtime import configure_compile_cache

configure_compile_cache()

import numpy as np  # noqa: E402

from audio_modem_radio.framing import crc32, pack_frame, parse_frames  # noqa: E402
from audio_modem_radio.modem import MODES, demodulate, modulate  # noqa: E402
from audio_modem_radio.utils.wavio import resample  # noqa: E402

TEXT_MODES = ("HELLSCHREIBER", "FELD_HELL", "SLOW_HELL")


def run_seed(seed: int, trials: int, rng_factory=np.random.default_rng):
    data_modes = [m for m in MODES if m not in TEXT_MODES]
    rng = rng_factory(seed)
    out = {"ok": 0, "lost": [], "crash": []}
    for trial in range(trials):
        mode = data_modes[rng.integers(len(data_modes))]
        rate = int(rng.choice([1200, 2400, 4800, 9600, 19200]))
        n = int(rng.integers(60, 2500))
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        framed = pack_frame("c.bin", payload, 0, 1, n, crc32(payload))
        try:
            wave = np.asarray(modulate(mode, framed, rate), np.float32)
            impair = []
            if rng.random() < 0.5:
                z = int(rng.integers(0, 50000))
                impair.append(f"lead{z}")
                wave = np.concatenate([np.zeros(z, np.float32), wave])
            if rng.random() < 0.5:
                snr_db = float(rng.uniform(12, 35))
                impair.append(f"snr{snr_db:.0f}")
                p = np.mean(wave**2) or 1e-9
                wave = wave + rng.normal(
                    0, np.sqrt(p / 10 ** (snr_db / 10)), len(wave)
                ).astype(np.float32)
            if rng.random() < 0.3:
                g = float(rng.uniform(0.2, 1.4))
                impair.append(f"clip{g:.2f}")
                wave = np.clip(wave * g, -1, 1).astype(np.float32)
            if rng.random() < 0.3:
                impair.append("resamp")
                wave = resample(resample(wave, 96000, 48000), 48000, 96000)
                wave = wave.astype(np.float32)
            frames = parse_frames(demodulate(mode, wave, rate))
            if frames and frames[0].data == payload:
                out["ok"] += 1
            else:
                out["lost"].append(
                    {"trial": trial, "mode": mode, "rate": rate,
                     "impair": impair, "payload": payload, "wave": wave}
                )
        except Exception as exc:  # crash = always a bug
            out["crash"].append((trial, mode, rate, repr(exc)))
            traceback.print_exc()
    return out


def replay_ladder(lost):
    """Replay direct-path losses through the full decode_from_buffer ladder."""
    from audio_modem_radio.decoder import decode_from_buffer

    cwd = os.getcwd()
    recovered, still = [], []
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for item in lost:
                got = False
                try:
                    saved = decode_from_buffer(
                        item["wave"], item["mode"], item["rate"]
                    )
                    for p in saved or []:
                        if open(p, "rb").read() == item["payload"]:
                            got = True
                except Exception:
                    traceback.print_exc()
                (recovered if got else still).append(
                    (item["trial"], item["mode"], item["rate"], item["impair"])
                )
        finally:
            os.chdir(cwd)
    return recovered, still


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="2026,777")
    ap.add_argument("--trials", type=int, default=120)
    ap.add_argument("--ladder", action="store_true",
                    help="replay losses through decode_from_buffer")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    report = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_seed(seed, args.trials)
        brief = [(x["trial"], x["mode"], x["rate"], x["impair"])
                 for x in res["lost"]]
        print(f"seed={seed}: OK {res['ok']}/{args.trials}", flush=True)
        print("  LOST:", brief, flush=True)
        print("  CRASH:", res["crash"], flush=True)
        entry = {"ok": res["ok"], "trials": args.trials,
                 "lost": brief, "crash": res["crash"]}
        if args.ladder and res["lost"]:
            rec, still = replay_ladder(res["lost"])
            print("  RECOVERED by ladder:", rec, flush=True)
            print("  STILL LOST:", still, flush=True)
            entry["ladder_recovered"] = rec
            entry["ladder_still_lost"] = still
        report[str(seed)] = entry
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
