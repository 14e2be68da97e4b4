"""Command-line interface: encode-file / decode-wav / modes / stats / bench.

The reference ships only a PyQt5 GUI (/root/reference/filebeep_advanced_v2.py);
this CLI is the headless equivalent surface for the same pipeline, plus
batch decoding (the device throughput path) and channel-intelligence helpers.

Usage::

    python -m audio_modem_radio.cli encode-file FILE [--mode QPSK]
        [--symbol-rate 9600] [--no-compress] [--split] [--duration-min 1]
    python -m audio_modem_radio.cli decode-wav WAV [WAV ...] [--mode QPSK]
        [--symbol-rate 9600] [--retry] [--batch]
    python -m audio_modem_radio.cli modes
    python -m audio_modem_radio.cli stats FILE --mode QPSK
    python -m audio_modem_radio.cli recommend [--priority balanced] [--wav WAV]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _analytics():
    """Shared analytics store; CLI runs record like the console app does."""
    from .observability import AnalyticsStore

    return AnalyticsStore()


def _cmd_encode(args: argparse.Namespace) -> int:
    from .encoder import calculate_transmission_stats, encode_file_paths
    import os

    if args.sstv_prep:
        # Image -> thumbnail -> low-quality JPEG -> zlib payload, then framed
        # like any other file (the reference's SSTV payload preparation).
        import tempfile

        from .utils.compression import prepare_sstv_like

        payload = prepare_sstv_like(args.file)
        tmp = os.path.join(
            tempfile.mkdtemp(prefix="sstv_"), os.path.basename(args.file) + ".sstv"
        )
        with open(tmp, "wb") as f:
            f.write(payload)
        print(f"SSTV prep: {os.path.getsize(args.file)} -> {len(payload)} bytes")
        args.file = tmp
        args.no_compress = True  # already compressed

    stats = calculate_transmission_stats(
        os.path.getsize(args.file), args.mode, args.symbol_rate, not args.no_compress
    )
    print(
        f"encoding {args.file} [{args.mode} @ {args.symbol_rate} Bd] "
        f"~{stats['duration_sec']:.1f}s on air"
    )
    paths = encode_file_paths(
        args.file,
        mode=args.mode,
        compress=not args.no_compress,
        symbol_rate=args.symbol_rate,
        split_large_files=args.split,
        target_duration_min=args.duration_min,
        cache_dir=args.cache_dir,
        use_fec=args.fec,
        fec_type=args.fec_type,
    )
    for p in paths:
        print(p)
    an = _analytics()
    an.record_encode(args.mode, os.path.getsize(args.file), ok=bool(paths))
    an.save()
    return 0 if paths else 1


def _cmd_decode(args: argparse.Namespace) -> int:
    from .decoder import decode_wav_file, decode_with_retry
    from .utils.wavio import read_wav

    saved_all: List[str] = []
    if args.batch and len(args.wavs) > 1:
        from .parallel.batch import decode_wav_batch

        results = decode_wav_batch(
            args.wavs, args.mode, args.symbol_rate, recv_dir=args.recv_dir
        )
        for wav, saved in zip(args.wavs, results):
            print(f"{wav}: {len(saved)} file(s)")
            saved_all.extend(saved)
    else:
        for wav in args.wavs:
            if args.retry:
                data, sr = read_wav(wav)
                from .utils.wavio import SAMPLE_RATE, resample

                if sr != SAMPLE_RATE:
                    data = resample(data, sr, SAMPLE_RATE)
                if getattr(args, "denoise", False):
                    from .utils.denoise import spectral_gate

                    data = spectral_gate(data)
                saved = decode_with_retry(
                    data, args.mode, args.symbol_rate, recv_dir=args.recv_dir,
                    stream_fec=getattr(args, "stream_fec", False),
                )
            else:
                saved = decode_wav_file(
                    wav, args.mode, args.symbol_rate, recv_dir=args.recv_dir,
                    stream_fec=getattr(args, "stream_fec", False),
                    denoise=getattr(args, "denoise", False),
                )
            print(f"{wav}: {len(saved)} file(s)")
            saved_all.extend(saved)
    for p in saved_all:
        print(p)
    import os

    an = _analytics()
    an.record_decode(
        args.mode,
        sum(os.path.getsize(p) for p in saved_all if os.path.exists(p)),
        ok=bool(saved_all),
    )
    an.save()
    return 0 if saved_all else 1


def _cmd_decode_stream(args: argparse.Namespace) -> int:
    """Incremental decode: windows over a growing capture (or a WAV replay)."""
    from .streaming import StreamingDecoder

    if args.wav:
        from .utils.wavio import read_wav

        data, sr = read_wav(args.wav)
        dec = StreamingDecoder(
            args.mode, args.symbol_rate, window=args.window, sample_rate=sr,
            recv_dir=args.recv_dir,
        )
        saved = []
        chunk = max(1, args.window // 4)
        for start in range(0, len(data), chunk):
            for p in dec.feed(data[start : start + chunk]):
                print(f"recovered mid-stream: {p}")
                saved.append(p)
        for p in dec.flush():
            print(f"recovered at flush: {p}")
            saved.append(p)
        return 0 if saved else 1

    from .audio_io import SOUNDDEVICE_AVAILABLE, Recorder

    if not SOUNDDEVICE_AVAILABLE:
        print("no --wav given and sounddevice unavailable for live capture")
        return 2
    rec = Recorder()
    dec = StreamingDecoder(
        args.mode, args.symbol_rate, window=args.window,
        sample_rate=rec.sample_rate, recv_dir=args.recv_dir,
    )
    import time as _time

    rec.start()
    try:
        # Continuous capture: drain() swaps the block buffer without pausing
        # the input stream, so no samples are lost between windows (a
        # stop()/start() loop drops the audio between the two calls — a frame
        # straddling that gap would never decode).
        deadline = _time.time() + args.seconds
        while _time.time() < deadline:
            _time.sleep(1.0)
            for p in dec.feed(rec.drain()):
                print(f"recovered: {p}")
    finally:
        dec.feed(rec.stop())
        for p in dec.flush():
            print(f"recovered: {p}")
    return 0


def _cmd_modes(args: argparse.Namespace) -> int:
    from .modem import MODES

    if getattr(args, "diagram", None):
        from .diagrams import mode_diagram

        print(mode_diagram(args.diagram, args.symbol_rate))
        return 0
    for name, spec in MODES.items():
        baud = f"fixed {spec.fixed_baud} Bd" if spec.fixed_baud else "symbol-rate arg"
        print(f"{name:14s} {baud:20s} ~{spec.bytes_per_sec(9600)} B/s @9600")
    if getattr(args, "all", False):
        from .modem import ANALOG_MODES, DIGITAL_MODES

        print("\ncatalog labels (reference GUI lists; display-only there too):")
        print("  digital:", ", ".join(DIGITAL_MODES))
        print("  analog: ", ", ".join(ANALOG_MODES))
    print("(try: modes --diagram QPSK, modes --all)")
    return 0


def _cmd_stats(args: argparse.Namespace) -> int:
    import os

    from .encoder import calculate_transmission_stats

    stats = calculate_transmission_stats(
        os.path.getsize(args.file), args.mode, args.symbol_rate, not args.no_compress
    )
    print(json.dumps(stats, indent=2))
    return 0


def _cmd_recommend(args: argparse.Namespace) -> int:
    from .intelligence import analyze_channel, intelligent_encode_setup

    samples = None
    if args.wav:
        from .utils.wavio import read_wav

        samples, _ = read_wav(args.wav)
    conditions = analyze_channel(samples)
    setup = intelligent_encode_setup(0, priority=args.priority, conditions=conditions)
    print(json.dumps({"conditions": conditions, "recommended": setup}, indent=2, default=str))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="audio_modem_radio", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("encode-file", help="encode a file into modulated WAV(s)")
    e.add_argument("file")
    e.add_argument("--mode", default="QPSK")
    e.add_argument("--symbol-rate", type=int, default=9600)
    e.add_argument("--no-compress", action="store_true")
    e.add_argument("--split", action="store_true", help="split large files into parts")
    e.add_argument("--duration-min", type=int, default=1, help="target minutes per part")
    e.add_argument("--sstv-prep", action="store_true",
                   help="prepare an image as an SSTV-style payload first")
    e.add_argument("--fec", action="store_true", help="wrap payloads in forward error correction")
    e.add_argument(
        "--fec-type",
        default=None,
        choices=["reed_solomon", "convolutional", "stream"],
        help="'stream' convolutionally codes the WHOLE frame (header+magic "
        "included) — decode with --stream-fec",
    )
    e.add_argument("--cache-dir", default="cache")
    e.set_defaults(fn=_cmd_encode)

    d = sub.add_parser("decode-wav", help="decode WAV(s) back into files")
    d.add_argument("wavs", nargs="+")
    d.add_argument("--mode", default="QPSK")
    d.add_argument("--symbol-rate", type=int, default=9600)
    d.add_argument("--retry", action="store_true", help="sweep symbol rate ±5%%")
    d.add_argument("--stream-fec", action="store_true",
                   help="Viterbi-decode the stream first (for --fec-type stream captures)")
    d.add_argument("--denoise", action="store_true",
                   help="spectral-gate noise reduction before demodulation")
    d.add_argument("--batch", action="store_true", help="batched device decode")
    d.add_argument("--recv-dir", default="recv")
    d.set_defaults(fn=_cmd_decode)

    ds = sub.add_parser("decode-stream", help="incremental streaming decode")
    ds.add_argument("--wav", default=None, help="replay this WAV as a stream")
    ds.add_argument("--mode", default="QPSK")
    ds.add_argument("--symbol-rate", type=int, default=9600)
    ds.add_argument("--window", type=int, default=1 << 20)
    ds.add_argument("--seconds", type=float, default=30.0, help="live capture duration")
    ds.add_argument("--recv-dir", default="recv")
    ds.set_defaults(fn=_cmd_decode_stream)

    m = sub.add_parser("modes", help="list transmission modes")
    m.add_argument("--diagram", metavar="MODE", help="print an ASCII diagram of a mode")
    m.add_argument("--all", action="store_true", help="include the display-only mode catalogs")
    m.add_argument("--symbol-rate", type=int, default=2400)
    m.set_defaults(fn=_cmd_modes)

    s = sub.add_parser("stats", help="estimate transmission stats for a file")
    s.add_argument("file")
    s.add_argument("--mode", default="QPSK")
    s.add_argument("--symbol-rate", type=int, default=9600)
    s.add_argument("--no-compress", action="store_true")
    s.set_defaults(fn=_cmd_stats)

    r = sub.add_parser("recommend", help="channel analysis and mode recommendation")
    r.add_argument("--priority", default="balanced", choices=["robustness", "speed", "balanced"])
    r.add_argument("--wav", default=None, help="estimate SNR from this WAV")
    r.set_defaults(fn=_cmd_recommend)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    from .utils.runtime import configure_compile_cache

    configure_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
