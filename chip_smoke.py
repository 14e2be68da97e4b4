#!/usr/bin/env python3
"""Bring-up smoke test of the batched WAV decode farm on the GPU.

Run from the repository root::

    python3 chip_smoke.py            # one card: device, farm, families, reference
    python3 chip_smoke.py --multi    # four cards: the multi-card paths only

Phases (a failing phase raises; the script then exits non-zero and prints
no result line):

1. device — JAX must run on a GPU; there is no CPU fallback. Prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. farm — 16 distinct random payloads, each encoded at QPSK@9600 by
   ``encode_file`` into one 5-minute 96 kHz int16 WAV (28.8 M samples, the
   reference's documented record window), decoded together from disk by
   one ``decode_wav_batch`` call; every saved file must equal its payload.
   Prints wall seconds, audio-seconds decoded per second and samples/s
   (cold, which includes compilation, then warm), and the warm device time
   and compiled memory of ``demod_pack_batch`` at that shape under HIGHEST
   and DEFAULT matmul precision.
   Then the same path from the command line: ``encode-file`` and
   ``decode-wav --batch`` on two small payloads.
3. families — each row of ``benchmarks/honest.py`` CONFIGS: 4 captures of
   30 s through ``decode_wav_batch``, files bit-exact (HELL: text equal),
   with the warm device time of ``demod_pack_batch`` and its
   ``memory_analysis()``.
4. reference — per family, its captures at 10 dB SNR through
   ``demod_pack_batch`` on the GPU and on the host CPU; the bit
   disagreement rate of the output streams must stay within
   ``REF_TOLERANCE``.

``--multi`` runs instead, over four cards: ``decode_wav_batch`` on the
4-card data-parallel mesh with 64 five-minute QPSK captures (16 per card),
compared with the payloads and with the same call on one card; and
``parallel.sequence.decode_capture_sharded`` of one 60-minute QPSK capture
across the four cards, compared with its 1-card decode.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
WAVs go to a temporary directory (``TMPDIR``) that is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import wave
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

SR = 96000
RATE = 9600
FARM_CAPTURES = 16
FARM_MINUTES = 5.0
FAMILY_CAPTURES = 4
FAMILY_SECONDS = 30.0
MULTI_CAPTURES = 64
SEQ_MINUTES = 60.0
REF_SNR_DB = 10.0
# Bit disagreement allowed between the GPU's and the CPU's output streams.
# Both run float32 at HIGHEST precision and differ only in summation order
# (~1e-7 relative), which flips a decision only when its statistic sits
# within that distance of a boundary: expected well under 1e-5 of the bits
# at 10 dB. TF32 products (~1e-3 relative) would flip ~100x more.
REF_TOLERANCE = 1e-4
TEXT_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


def log(msg: str) -> None:
    print(msg, flush=True)


# --- phase 1: device -----------------------------------------------------------

def check_device() -> Dict[str, object]:
    """The GPU JAX runs on; RuntimeError on any other platform."""
    from audio_modem_radio.utils.runtime import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    print(card_name_and_power_limit(), flush=True)
    log(f"device {json.dumps(dev)}")
    return dev


# --- capture synthesis ------------------------------------------------------------

def _write_pcm(path: str, pcm: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.ascontiguousarray(pcm, dtype="<i2").tobytes())


def _read_pcm(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        if w.getframerate() != SR or w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: expected mono int16 at {SR} Hz")
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


def place_in_window(tx_wav: str, out_wav: str, n_samples: int, lead: int) -> int:
    """Write ``tx_wav``'s transmission into an ``n_samples`` int16 capture
    after ``lead`` samples of silence (the record window around it);
    returns the transmission length. Raises when it does not fit."""
    pcm = _read_pcm(tx_wav)
    if lead + len(pcm) > n_samples:
        raise ValueError(
            f"{tx_wav}: {len(pcm)} samples after a {lead}-sample lead exceed "
            f"the {n_samples}-sample window"
        )
    cap = np.zeros(n_samples, np.int16)
    cap[lead : lead + len(pcm)] = pcm
    _write_pcm(out_wav, cap)
    return len(pcm)


def samples_per_unit(mode: str, rate: int) -> float:
    """On-air samples per payload byte (per character for text modes)."""
    from audio_modem_radio.framing import crc32, pack_frame
    from audio_modem_radio.modem import modulate
    from audio_modem_radio.parallel.batch import resolve_demod_plan

    if resolve_demod_plan(mode, rate)[0] == "hell":
        from audio_modem_radio.ops.hell import hellschreiber_modulate

        return len(hellschreiber_modulate("A" * 40)) / 40.0
    probe = bytes(4000)
    framed = pack_frame("probe", probe, 0, 1, len(probe), crc32(probe))
    return len(modulate(mode, framed, rate)) / len(framed)


def make_captures(
    workdir: str, tag: str, mode: str, rate: int, n_captures: int,
    n_samples: int, fill: float, seed: int,
) -> Tuple[List[str], List[bytes]]:
    """``n_captures`` distinct random payloads (text for HELL), each encoded
    through the user entry point and placed in an ``n_samples`` window with
    a random lead; the transmission fills about ``fill`` of the window.
    Returns (capture WAV paths, expected payloads — text as ASCII bytes)."""
    from audio_modem_radio.encoder import encode_file, encode_hellschreiber_text
    from audio_modem_radio.parallel.batch import resolve_demod_plan

    text_mode = resolve_demod_plan(mode, rate)[0] == "hell"
    rng = np.random.default_rng(seed)
    units = max(8, int(fill * n_samples / samples_per_unit(mode, rate)))
    if not text_mode:
        units = max(8, units - 64)  # frame header + compression tag
    txd = os.path.join(workdir, f"{tag}_tx")
    encd = os.path.join(workdir, f"{tag}_enc")
    capd = os.path.join(workdir, f"{tag}_cap")
    for d in (txd, encd, capd):
        os.makedirs(d, exist_ok=True)
    paths, payloads = [], []
    for i in range(n_captures):
        lead = int(rng.integers(0, max(1, int((1.0 - fill) * n_samples / 4))))
        if text_mode:
            # The text receivers keep no timing search: the transmission must
            # open the capture (a lead of one pixel or more loses the glyph
            # grid, on the single-file path as well).
            lead = 0
            idx = rng.integers(0, len(TEXT_ALPHABET), units)
            text = "".join(TEXT_ALPHABET[j] for j in idx)
            wav = encode_hellschreiber_text(text, cache_dir=encd)
            payload = text.encode("ascii")
        else:
            payload = rng.integers(0, 256, units, dtype=np.uint8).tobytes()
            src = os.path.join(txd, f"{tag}_{i:03d}.bin")
            with open(src, "wb") as f:
                f.write(payload)
            wav = encode_file(
                src, mode, symbol_rate=rate, split_large_files=False, cache_dir=encd
            )
        out = os.path.join(capd, f"{tag}_{i:03d}.wav")
        place_in_window(wav, out, n_samples, lead)
        paths.append(out)
        payloads.append(payload)
    return paths, payloads


# --- decode + checks -----------------------------------------------------------------

def decode_and_check(
    paths: Sequence[str], payloads: Sequence[bytes], mode: str, rate: int,
    recv_dir: str, mesh=None,
) -> Tuple[float, List[List[bytes]]]:
    """One ``decode_wav_batch`` call; every capture must save its payload.
    Returns (wall seconds, per-capture saved contents)."""
    from audio_modem_radio.assembly import AssemblyRegistry
    from audio_modem_radio.parallel.batch import decode_wav_batch

    t0 = time.perf_counter()
    saved = decode_wav_batch(
        list(paths), mode, rate, recv_dir=recv_dir,
        registry=AssemblyRegistry(journal_dir=""), mesh=mesh,
    )
    wall = time.perf_counter() - t0
    contents = []
    bad = []
    for i, (files, payload) in enumerate(zip(saved, payloads)):
        got = []
        for p in files:
            with open(p, "rb") as f:
                got.append(f.read())
        contents.append(got)
        if payload not in got:
            bad.append(i)
    if bad:
        raise AssertionError(
            f"{mode}: {len(bad)}/{len(payloads)} captures did not decode to their "
            f"payload (first: {paths[bad[0]]})"
        )
    return wall, contents


def load_batch(paths: Sequence[str]) -> np.ndarray:
    """(B, bucket) float32 batch of the captures, as decode_wav_batch builds it."""
    from audio_modem_radio.parallel.batch import _bucket_length

    pcms = [_read_pcm(p) for p in paths]
    n = _bucket_length([len(p) for p in pcms])
    batch = np.zeros((len(pcms), n), np.float32)
    for i, p in enumerate(pcms):
        batch[i, : len(p)] = p.astype(np.float32) / 32768.0
    return batch


def device_program(batch: np.ndarray, mode: str, rate: int, cfo_retry: bool, device=None):
    """(compiled demod_pack_batch, its device-resident input) for the
    host-shaped batch — the program decode_sample_batch dispatches."""
    import jax

    from audio_modem_radio.parallel.batch import demod_pack_batch, host_shape_batch

    x = jax.device_put(host_shape_batch(batch, mode, rate), device)
    compiled = demod_pack_batch.lower(
        x, mode, rate, cfo_retry=cfo_retry, fsk_mlse=False
    ).compile()
    return compiled, x


def memory_summary(compiled) -> Dict[str, int]:
    m = compiled.memory_analysis()
    return {
        "argument_bytes": int(m.argument_size_in_bytes),
        "output_bytes": int(m.output_size_in_bytes),
        "temp_bytes": int(m.temp_size_in_bytes),
        "code_bytes": int(m.generated_code_size_in_bytes),
    }


def stream_disagreement(a, b) -> float:
    """Bit disagreement rate of two (packed, n_valid, found) batch outputs;
    a length or sync difference counts every unmatched bit."""
    pa, na, fa = (np.asarray(v) for v in a)
    pb, nb, fb = (np.asarray(v) for v in b)
    flips = total = 0
    for i in range(pa.shape[0]):
        la, lb = int(na[i]), int(nb[i])
        total += 8 * max(la, lb, 1)
        if bool(fa[i]) != bool(fb[i]):
            flips += 8 * max(la, lb, 1)
            continue
        n = min(la, lb)
        flips += int(np.unpackbits(np.bitwise_xor(pa[i, :n], pb[i, :n])).sum())
        flips += 8 * abs(la - lb)
    return flips / total


def add_noise(batch: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    """Each capture plus white noise at ``snr_db`` relative to the mean
    power of its non-silent span."""
    rng = np.random.default_rng(seed)
    out = np.empty_like(batch)
    for i, x in enumerate(batch):
        active = np.flatnonzero(x)
        p = float(np.mean(x[active[0] : active[-1] + 1] ** 2)) if len(active) else 1.0
        noise = rng.normal(0.0, np.sqrt(p / 10 ** (snr_db / 10)), len(x))
        out[i] = x + noise.astype(np.float32)
    return out


def reference_check(
    batch: np.ndarray, compiled, mode: str, rate: int, cfo_retry: bool, seed: int
) -> float:
    """The family's batch at ``REF_SNR_DB`` through the device program
    (``compiled``) and through the same function on the host CPU; returns
    the bit disagreement rate (AssertionError above REF_TOLERANCE)."""
    import jax

    from audio_modem_radio.parallel.batch import host_shape_batch

    noisy = add_noise(batch, REF_SNR_DB, seed)
    dev_out = compiled(jax.device_put(host_shape_batch(noisy, mode, rate)))
    cpu_prog, x_cpu = device_program(
        noisy, mode, rate, cfo_retry, device=jax.devices("cpu")[0]
    )
    dis = stream_disagreement(dev_out, cpu_prog(x_cpu))
    if dis > REF_TOLERANCE:
        raise AssertionError(
            f"{mode}: device/CPU bit disagreement {dis:.3e} > {REF_TOLERANCE:.0e}"
        )
    return dis


# --- phases 2-4 ---------------------------------------------------------------------

def farm_phase(workdir: str, n_captures: int = FARM_CAPTURES, minutes: float = FARM_MINUTES) -> None:
    import jax
    from _timing import timed

    n_samples = int(minutes * 60 * SR)
    t0 = time.perf_counter()
    paths, payloads = make_captures(
        workdir, "farm", "QPSK", RATE, n_captures, n_samples, fill=0.9, seed=1
    )
    log(f"farm: encoded {n_captures} x {minutes:g}-min QPSK@{RATE} WAVs "
        f"in {time.perf_counter() - t0:.1f} s")
    audio_s = n_captures * n_samples / SR
    for run in ("cold", "warm"):
        wall, _ = decode_and_check(
            paths, payloads, "QPSK", RATE, os.path.join(workdir, f"farm_recv_{run}")
        )
        log(f"farm {run}: {n_captures}/{n_captures} files byte-equal; wall {wall:.3f} s, "
            f"{audio_s / wall:.1f} audio-s/s, {n_captures * n_samples / wall / 1e6:.1f} Msamples/s")
    batch = load_batch(paths)
    for prec in ("highest", "default"):
        with jax.default_matmul_precision(prec):
            compiled, x = device_program(batch, "QPSK", RATE, cfo_retry=True)
        sec = timed(compiled, x, reps=5)
        log(f"farm demod_pack_batch[{prec}] {batch.shape}: {sec * 1e3:.3f} ms, "
            f"{batch.size / sec / 1e9:.3f} GS/s, memory {json.dumps(memory_summary(compiled))}")
        del compiled, x


def cli_phase(workdir: str, n_bytes: int = 20_000) -> None:
    """The user's command line: ``amr encode-file`` two payloads, then
    ``amr decode-wav --batch`` both WAVs; every payload must come back."""
    from audio_modem_radio import cli

    rng = np.random.default_rng(7)
    enc, recv = os.path.join(workdir, "cli_enc"), os.path.join(workdir, "cli_recv")
    wavs, payloads = [], []
    for i in range(2):
        src = os.path.join(workdir, f"cli_{i}.bin")
        payloads.append(rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes())
        with open(src, "wb") as f:
            f.write(payloads[-1])
        if cli.main(["encode-file", src, "--mode", "QPSK", "--symbol-rate", str(RATE),
                     "--cache-dir", enc]) != 0:
            raise AssertionError("cli encode-file failed")
        wavs.append(os.path.join(enc, f"cli_{i}.bin.QPSK.wav"))
    if cli.main(["decode-wav", *wavs, "--batch", "--mode", "QPSK", "--symbol-rate",
                 str(RATE), "--recv-dir", recv]) != 0:
        raise AssertionError("cli decode-wav --batch failed")
    got = []
    for name in os.listdir(recv):
        path = os.path.join(recv, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                got.append(f.read())
    if any(p not in got for p in payloads):
        raise AssertionError("cli decode-wav --batch lost a payload")
    log(f"cli: encode-file x2 -> decode-wav --batch, {len(payloads)}/{len(payloads)} files byte-equal")


def family_rows() -> Dict[str, tuple]:
    from honest import CONFIGS

    return CONFIGS


def families_phase(
    workdir: str, n_captures: int = FAMILY_CAPTURES, seconds: float = FAMILY_SECONDS,
    rows: Dict[str, tuple] = None,
) -> None:
    from _timing import timed
    from audio_modem_radio.config import CONFIG
    from audio_modem_radio.ops.common import matmul_precision

    n_samples = int(seconds * SR)
    rows = rows if rows is not None else family_rows()
    for k, (name, (rate, _b, _p, kw)) in enumerate(rows.items()):
        mode = name.split("-")[0]
        cfo = bool(kw.get("cfo_retry", True))
        old = CONFIG.get("modem.cfo_retry", True)
        CONFIG.set("modem.cfo_retry", cfo)
        try:
            paths, payloads = make_captures(
                workdir, f"fam{k}", mode, rate, n_captures, n_samples, fill=0.6, seed=100 + k
            )
            wall, _ = decode_and_check(
                paths, payloads, mode, rate, os.path.join(workdir, f"fam{k}_recv")
            )
            batch = load_batch(paths)
            compiled, x = device_program(batch, mode, rate, cfo)
            sec = timed(compiled, x, reps=5)
            dis = reference_check(batch, compiled, mode, rate, cfo, seed=200 + k)
        finally:
            CONFIG.set("modem.cfo_retry", old)
        log(f"family {name}: {n_captures}/{n_captures} files exact; decode_wav_batch "
            f"cold {wall:.3f} s; demod_pack_batch {batch.shape} {sec * 1e3:.3f} ms "
            f"({batch.size / sec / 1e9:.3f} GS/s); memory {json.dumps(memory_summary(compiled))}; "
            f"reference @{REF_SNR_DB:g} dB: disagreement {dis:.3e} "
            f"(tolerance {REF_TOLERANCE:.0e}, precision {matmul_precision()})")


def multi_phase(
    workdir: str, n_captures: int = MULTI_CAPTURES, minutes: float = FARM_MINUTES,
    seq_minutes: float = SEQ_MINUTES, n_cards: int = 4,
) -> None:
    import jax

    from audio_modem_radio.decoder import smart_decompress
    from audio_modem_radio.framing import parse_frames
    from audio_modem_radio.parallel.mesh import get_mesh
    from audio_modem_radio.parallel.sequence import decode_capture_sharded

    devs = jax.devices()
    if len(devs) < n_cards:
        raise RuntimeError(f"--multi needs {n_cards} devices, found {len(devs)}")
    mesh_n = get_mesh(n_cards, devs[:n_cards])
    mesh_1 = get_mesh(1, devs[:1])

    n_samples = int(minutes * 60 * SR)
    paths, payloads = make_captures(
        workdir, "dp", "QPSK", RATE, n_captures, n_samples, fill=0.9, seed=3
    )
    wall_n, files_n = decode_and_check(
        paths, payloads, "QPSK", RATE, os.path.join(workdir, "dp_recv_n"), mesh=mesh_n
    )
    wall_1, files_1 = decode_and_check(
        paths, payloads, "QPSK", RATE, os.path.join(workdir, "dp_recv_1"), mesh=mesh_1
    )
    if files_n != files_1:
        raise AssertionError("data-parallel decode differs from the 1-card decode")
    log(f"multi dp: {n_captures} x {minutes:g}-min captures byte-equal on {n_cards} cards "
        f"(cold wall {wall_n:.3f} s) and on 1 card (cold wall {wall_1:.3f} s)")

    seq_samples = int(seq_minutes * 60 * SR)
    (seq_path,), (seq_payload,) = make_captures(
        workdir, "seq", "QPSK", RATE, 1, seq_samples, fill=0.9, seed=4
    )
    samples = _read_pcm(seq_path).astype(np.float32) / 32768.0
    raws = {}
    for label, mesh in ((n_cards, mesh_n), (1, mesh_1)):
        t0 = time.perf_counter()
        raws[label] = decode_capture_sharded(samples, "QPSK", RATE, mesh)
        log(f"multi sequence: {seq_minutes:g}-min capture on {label} card(s) "
            f"cold {time.perf_counter() - t0:.3f} s")
    # The streams differ only in length: each layout pads the capture to a
    # whole number of rows per shard, and the padding decodes to a tail.
    common = min(len(raws[n_cards]), len(raws[1]))
    if raws[n_cards][:common] != raws[1][:common]:
        raise AssertionError("sequence-parallel stream differs from the 1-card decode")
    frames = parse_frames(raws[n_cards])
    if not frames or smart_decompress(frames[0].data) != seq_payload:
        raise AssertionError("sequence-parallel decode lost the 60-minute frame")
    log(f"multi sequence: {seq_minutes:g}-min frame ({len(seq_payload)} B) equal on "
        f"{n_cards} cards and 1 card")


def run(phases: List[Callable[[str], None]]) -> None:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        for phase in phases:
            t0 = time.perf_counter()
            phase(workdir)
            log(f"{phase.__name__} done in {time.perf_counter() - t0:.1f} s")


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--multi", action="store_true",
        help="run only the four-card data- and sequence-parallel paths",
    )
    args = ap.parse_args(argv)

    from audio_modem_radio.utils.runtime import configure_compile_cache

    configure_compile_cache()
    dev = check_device()
    if args.multi:
        run([multi_phase])
    else:
        run([farm_phase, cli_phase, families_phase])
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
