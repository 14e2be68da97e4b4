"""Interactive terminal application — the reference GUI's workflows, headless.

The reference ships a PyQt5 desktop app with four tabs — Encode, Decode,
Player, Analysis — plus a log pane and status bar
(/root/reference/filebeep_advanced_v2.py). PyQt5 isn't a dependency of this
rebuild; this module provides the same workflows as an interactive console
application (menu REPL), launchable with::

    python -m audio_modem_radio.app

Workflows mapped from the reference GUI:
  encode   — file picker prompt, mode/symbol-rate/compression/FEC options,
             transmission stats preview, progress, cancellation (Encode tab)
  decode   — decode WAV file(s); live mic recording when sounddevice exists
             (Decode tab, WorkerRecord)
  player   — playlist with played-state markers, play/pause/stop, PTT
             port/method configuration and keyed transmission (Player tab)
  analysis — reception stats, in-flight assemblies, channel analysis of a
             WAV, host/device performance (Analysis tab + StatusWidget)
  config   — view/set dotted config keys, save/load JSON (ConfigManager)
  log      — tail the session log (log pane)
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from .config import CONFIG
from .observability import AnalyticsStore, LogManager, PerformanceMonitor, setup_logging

MODES_HELP = (
    "FSK1200 FSK9600 FSK19200 BPSK QPSK 8PSK OFDM4 OFDM8 APSK16 DSSS MSK "
    "FT8 PSK31 SSTV HELLSCHREIBER FELD_HELL"
)


def load_playlist_file(path: str):
    """Read playlist.json -> (paths, played_set). Missing/corrupt -> empty.

    Shared by the console app, the curses TUI and the tkinter GUI so all
    three front ends persist the same playlist + played-state schema (the
    reference loses both on restart; filebeep_advanced_v2.py:1159-1203).
    """
    import json

    try:
        with open(path) as f:
            data = json.load(f)
        entries = data.get("entries", [])
        return [e["path"] for e in entries], {e["path"] for e in entries if e.get("played")}
    except (OSError, ValueError, KeyError, TypeError):
        return None, set()


def save_playlist_file(path: str, playlist, played) -> None:
    """Write playlist.json ({entries: [{path, played}]}); never raises."""
    import json

    entries = [{"path": p, "played": p in played} for p in playlist]
    try:
        with open(path, "w") as f:
            json.dump({"entries": entries}, f, indent=1)
    except OSError:
        pass


class ConsoleApp:
    def __init__(self, analytics: Optional[AnalyticsStore] = None):
        self.logger = setup_logging(
            console=False, to_file=bool(CONFIG.get("ui.auto_save_logs", True))
        )
        self.log_manager = LogManager()
        self.analytics = analytics or AnalyticsStore()
        self.monitor = PerformanceMonitor()
        self.mode = "QPSK"
        self.symbol_rate = 9600
        self.compress = True
        self.use_fec = bool(CONFIG.get("modem.fec_enabled", False))
        self.playlist: List[str] = []
        self.ptt_port: Optional[str] = None
        self.ptt_method = "RTS"
        self._player = None
        self.playlist_path = "playlist.json"
        self._load_playlist()

    # --- helpers ---------------------------------------------------------

    def _load_playlist(self) -> None:
        """Restore playlist + played-state (the reference loses both on
        restart; its colored playlist is filebeep_advanced_v2.py:1159-1203)."""
        # Set both attributes unconditionally: callers construct this object
        # without __init__ (the TUI shares the persistence logic), so the
        # error path must leave a fully usable state.
        fallback = getattr(self, "playlist", [])
        loaded, self._restored_played = load_playlist_file(self.playlist_path)
        self.playlist = fallback if loaded is None else loaded

    def _save_playlist(self) -> None:
        played = self.player.played | self._restored_played
        save_playlist_file(self.playlist_path, self.playlist, played)

    def _input(self, prompt: str, default: str = "") -> str:
        try:
            raw = input(f"{prompt}{f' [{default}]' if default else ''}: ").strip()
        except EOFError:
            return default
        return raw or default

    @property
    def player(self):
        if self._player is None:
            from .audio_io import AudioPlayer

            self._player = AudioPlayer()
        return self._player

    # --- workflows --------------------------------------------------------

    def do_encode(self) -> None:
        from .encoder import calculate_transmission_stats, encode_file_paths

        path = self._input("file to encode")
        if not path or not os.path.exists(path):
            print("no such file")
            return
        self.mode = self._input(f"mode ({MODES_HELP})", self.mode).upper()
        self.symbol_rate = int(self._input("symbol rate", str(self.symbol_rate)))
        stats = calculate_transmission_stats(
            os.path.getsize(path), self.mode, self.symbol_rate, self.compress
        )
        print(
            f"~{stats['duration_sec']:.1f}s on air at {stats['bytes_per_sec']:.0f} B/s "
            f"(compression ratio {stats['compression_ratio']})"
        )
        split = self._input("split into parts? (y/n)", "n").lower() == "y"
        try:
            paths = encode_file_paths(
                path,
                mode=self.mode,
                compress=self.compress,
                symbol_rate=self.symbol_rate,
                split_large_files=split,
                use_fec=self.use_fec,
                progress_callback=lambda i, n: print(f"  part {i}/{n}"),
            )
        except Exception as e:
            self.analytics.record_encode(self.mode, 0, ok=False)
            print(f"encode failed: {e}")
            return
        self.analytics.record_encode(self.mode, os.path.getsize(path))
        self.analytics.save()
        for p in paths:
            print(f"wrote {p}")
            self.playlist.append(p)

    def do_decode(self) -> None:
        from .decoder import decode_wav_file

        path = self._input("WAV file to decode (or 'mic' for live capture)")
        if path == "mic":
            self._do_record()
            return
        if not os.path.exists(path):
            print("no such file")
            return
        mode = self._input("mode", self.mode).upper()
        rate = int(self._input("symbol rate", str(self.symbol_rate)))
        saved = decode_wav_file(path, mode, rate)
        self.analytics.record_decode(mode, sum(os.path.getsize(p) for p in saved), ok=bool(saved))
        self.analytics.save()
        print(f"{len(saved)} file(s) recovered")
        for p in saved:
            print(f"  {p}")

    def _do_record(self) -> None:
        from .audio_io import ReceiveSession, Recorder, SOUNDDEVICE_AVAILABLE

        if not SOUNDDEVICE_AVAILABLE:
            print("sounddevice not installed; live capture unavailable")
            return
        seconds = float(self._input("record seconds", "30"))
        recorder = Recorder()

        def meter(level: float) -> None:
            # Live input level like the reference's volume bar
            # (filebeep_advanced_v2.py:309-310, RMS x15); \r keeps one line.
            bars = int(level * 30)
            sys.stdout.write(f"\rlevel [{'#' * bars}{'.' * (30 - bars)}] {level * 100:3.0f}%")
            sys.stdout.flush()

        recorder.volume_callback = meter
        session = ReceiveSession(self.mode, self.symbol_rate, recorder)
        print("recording...")
        saved = session.run(seconds)
        sys.stdout.write("\n")
        print(f"{len(saved)} file(s) recovered")

    def do_player(self) -> None:
        while True:
            for i, p in enumerate(self.playlist):
                state = self.player.state_of(p)
                if state == "pending" and p in self._restored_played:
                    state = "played"  # restored from playlist.json
                marker = {"playing": ">", "played": "*", "pending": " "}[state]
                print(f" {marker} [{i}] {p}")
            cmd = self._input("player (play N / pause / stop / add PATH / clear / ptt PORT [RTS|DTR] / tx N / back)")
            parts = cmd.split()
            if not parts or parts[0] == "back":
                return
            try:
                if parts[0] == "play":
                    self.player.play(self.playlist[int(parts[1])])
                    self._save_playlist()
                elif parts[0] == "pause":
                    self.player.pause()
                elif parts[0] == "stop":
                    self.player.stop()
                elif parts[0] == "add":
                    self.playlist.append(parts[1])
                    self._save_playlist()
                elif parts[0] == "clear":
                    self.playlist.clear()
                    self._restored_played.clear()
                    self._save_playlist()
                elif parts[0] == "ptt":
                    self.ptt_port = parts[1]
                    self.ptt_method = parts[2] if len(parts) > 2 else "RTS"
                    print(f"PTT on {self.ptt_port} via {self.ptt_method}")
                elif parts[0] == "tx":
                    from .audio_io import transmit

                    transmit(self.playlist[int(parts[1])], self.ptt_port, self.ptt_method, self.player)
            except Exception as e:
                print(f"error: {e}")

    def do_analysis(self) -> None:
        from .decoder import get_assembly_status, get_reception_stats
        from .intelligence import analyze_channel, get_recommended_mode

        stats = get_reception_stats()
        print("reception stats:")
        for k, v in stats.items():
            print(f"  {k}: {v}")
        for asm in get_assembly_status():
            print(f"  in flight: {asm['filename']} {asm['received']}/{asm['total']}")
        wav = self._input("analyze channel from WAV (empty to skip)")
        samples = None
        if wav and os.path.exists(wav):
            from .utils.wavio import read_wav

            samples, _ = read_wav(wav)
        conditions = analyze_channel(samples)
        print(f"channel: SNR {conditions['snr_db']:.1f} dB -> "
              f"recommended mode {get_recommended_mode(conditions)}")
        print("host:", self.monitor.sample())

    def do_config(self) -> None:
        cmd = self._input("config (get KEY / set KEY VALUE / save / load / back)")
        parts = cmd.split(None, 2)
        if not parts or parts[0] == "back":
            return
        if parts[0] == "get" and len(parts) > 1:
            print(CONFIG.get(parts[1]))
        elif parts[0] == "set" and len(parts) > 2:
            import json as _json

            try:
                value = _json.loads(parts[2])
            except _json.JSONDecodeError:
                value = parts[2]
            CONFIG.set(parts[1], value)
            print("ok")
        elif parts[0] == "save":
            CONFIG.save_to_file()
            print("saved filebeep_config.json")
        elif parts[0] == "load":
            CONFIG.load_from_file()
            print("loaded")

    def do_log(self) -> None:
        rotated = self.log_manager.rotate()
        if rotated:
            print(f"rotated -> {rotated}")
        if os.path.exists(self.log_manager.log_file):
            with open(self.log_manager.log_file, encoding="utf-8") as f:
                for line in f.readlines()[-20:]:
                    print(line.rstrip())
        else:
            print("(no log yet)")

    # --- main loop ---------------------------------------------------------

    def do_diagram(self) -> None:
        """ASCII mode diagrams (reference ModeDiagramWidget parity)."""
        from .diagrams import mode_diagram

        mode = self._input("mode to illustrate", self.mode).upper()
        print(mode_diagram(mode, self.symbol_rate))

    def run(self) -> None:
        print(
            "audio-modem-radio console "
            "(encode/decode/player/analysis/diagram/config/log/quit)"
        )
        dispatch = {
            "encode": self.do_encode,
            "decode": self.do_decode,
            "player": self.do_player,
            "analysis": self.do_analysis,
            "diagram": self.do_diagram,
            "config": self.do_config,
            "log": self.do_log,
        }
        while True:
            try:
                cmd = input("menu: ").strip()
            except EOFError:
                # Closed stdin (piped input exhausted, headless fallback):
                # exit like "quit" instead of busy-looping on the default.
                cmd = "quit"
            if cmd in ("quit", "exit", "q"):
                self.analytics.save()
                return
            fn = dispatch.get(cmd)
            if fn:
                try:
                    fn()
                except KeyboardInterrupt:
                    print("\n(cancelled)")
            elif cmd:
                print(f"unknown: {cmd}")


def main() -> int:
    from .utils.runtime import configure_compile_cache

    configure_compile_cache()
    ConsoleApp().run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
