"""Curses TUI: the full-screen terminal analog of the reference's GUI.

The reference is, to its users, a four-tab PyQt5 window
(/root/reference/filebeep_advanced_v2.py:404-1373: Encode / Decode / Player /
Analysis, log pane, status bar, mode diagrams, volume meter, colored
playlist). This TUI reproduces every affordance in a terminal:

* tab bar + per-tab panels (arrow keys / tab to switch),
* Encode: file prompt, mode/rate cycling, progress + result log,
* Decode: WAV prompt, live-record with a volume meter, reception stats and
  in-flight assembly status (the reference's 2 s/5 s refresh panes),
* Player: playlist with pending/playing/played markers (persisted via the
  console app's playlist.json), play/stop, PTT port control,
* Analysis: channel SNR + recommended mode + host metrics + mode diagram.

Architecture: all drawing is PURE — ``render_*`` functions map an
``AppState`` to lines of text, unit-testable without a terminal; the curses
shell at the bottom just paints lines and routes keys. Heavy work (encode/
decode) runs on worker threads exactly like the reference's QThread workers,
posting results back through a queue.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

TABS = ("Encode", "Decode", "Player", "Analysis")


@dataclass
class AppState:
    tab: int = 0
    sel: int = 0  # player selection cursor
    mode: str = "QPSK"
    symbol_rate: int = 9600
    compress: bool = True
    use_fec: bool = False
    log: List[str] = field(default_factory=list)
    playlist: List[str] = field(default_factory=list)
    played: set = field(default_factory=set)
    playing: Optional[str] = None
    volume: float = 0.0
    recording: bool = False
    busy: str = ""  # current background job description
    status: str = ""
    ptt_port: Optional[str] = None
    stats: dict = field(default_factory=dict)
    assemblies: List[dict] = field(default_factory=list)
    host: dict = field(default_factory=dict)
    channel: dict = field(default_factory=dict)  # analysis results (own field:
    # the 2 s stats refresh replaces st.stats and must not race these)

    def logline(self, msg: str) -> None:
        self.log.append(f"[{time.strftime('%H:%M:%S')}] {msg}")
        del self.log[:-200]


# --- pure rendering -------------------------------------------------------------

def render_header(st: AppState, width: int = 80) -> List[str]:
    tabs = "  ".join(
        (f"[{name}]" if i == st.tab else f" {name} ") for i, name in enumerate(TABS)
    )
    cfg = f"{st.mode}@{st.symbol_rate}Bd comp={'y' if st.compress else 'n'} fec={'y' if st.use_fec else 'n'}"
    line2 = (st.busy or st.status or "ready").ljust(width - len(cfg) - 1)[: width - len(cfg) - 1]
    return [tabs[:width], f"{line2} {cfg}"[:width], "-" * width]


def render_volume_bar(level: float, width: int = 40) -> str:
    bars = int(max(0.0, min(1.0, level)) * width)
    return f"level [{'#' * bars}{'.' * (width - bars)}] {level * 100:3.0f}%"


def render_encode_tab(st: AppState, width: int = 80) -> List[str]:
    return [
        "ENCODE   (e: encode file   m: cycle mode   r: set rate   c: compress   F: FEC)",
        "",
        f"  mode         : {st.mode}",
        f"  symbol rate  : {st.symbol_rate} Bd",
        f"  compression  : {'on' if st.compress else 'off'}",
        f"  FEC          : {'on' if st.use_fec else 'off'}",
    ]


def render_decode_tab(st: AppState, width: int = 80) -> List[str]:
    lines = [
        "DECODE   (d: decode WAV   R: record+decode   y: retry sweep)",
        "",
        render_volume_bar(st.volume) if st.recording else "not recording",
        "",
        "reception stats:",
    ]
    for k, v in (st.stats or {}).items():
        lines.append(f"  {k}: {v}")
    if st.assemblies:
        lines.append("in-flight assemblies:")
        for a in st.assemblies:
            lines.append(f"  {a.get('filename')} {a.get('received')}/{a.get('total')}")
    return lines


def render_player_tab(st: AppState, width: int = 80) -> List[str]:
    lines = ["PLAYER   (a: add   p: play sel   s: stop   x: clear   t: PTT port   T: transmit)",
             ""]
    if not st.playlist:
        lines.append("  (playlist empty — encode something or press 'a')")
    for i, p in enumerate(st.playlist):
        if p == st.playing:
            mark = ">"  # playing (reference: yellow)
        elif p in st.played:
            mark = "*"  # played (reference: green)
        else:
            mark = " "  # pending (reference: red)
        cursor = "->" if i == st.sel else "  "
        lines.append(f"{cursor}{mark} [{i}] {p}"[:width])
    lines.append("")
    lines.append(f"PTT: {st.ptt_port or 'off'}")
    return lines


def render_analysis_tab(st: AppState, width: int = 80) -> List[str]:
    lines = ["ANALYSIS   (n: analyze channel from WAV   g: mode diagram)", ""]
    if st.host:
        lines.append(
            "host: " + "  ".join(f"{k}={v}" for k, v in st.host.items())
        )
    snr = st.channel.get("snr_db")
    if snr is not None:
        lines.append(f"channel SNR: {snr:.1f} dB -> recommended {st.channel.get('recommended')}")
    return lines


def render_log(st: AppState, height: int = 8, width: int = 80) -> List[str]:
    out = ["-" * width, "log:"]
    out += [ln[:width] for ln in st.log[-(height - 2) :]]
    return out


def render_screen(st: AppState, width: int = 80, log_height: int = 8) -> List[str]:
    body = {
        0: render_encode_tab,
        1: render_decode_tab,
        2: render_player_tab,
        3: render_analysis_tab,
    }[st.tab](st, width)
    return render_header(st, width) + body + render_log(st, log_height, width)


# --- background workers ----------------------------------------------------------

def _worker(st: AppState, results: "queue.Queue", fn, desc: str):
    def run():
        st.busy = desc
        try:
            msg = fn()
            results.put(msg)
        except Exception as exc:  # workers must never kill the UI loop
            results.put(f"error: {exc}")
        finally:
            st.busy = ""

    threading.Thread(target=run, daemon=True).start()


# --- curses shell (thin; everything above is unit-tested) -------------------------

def main() -> int:  # pragma: no cover - requires a terminal
    import curses

    from .observability import AnalyticsStore, PerformanceMonitor
    from .utils.runtime import configure_compile_cache

    configure_compile_cache()

    st = AppState()
    results: "queue.Queue[str]" = queue.Queue()
    analytics = AnalyticsStore()
    monitor = PerformanceMonitor()
    from .audio_io import AudioPlayer

    tx_player = AudioPlayer()  # shared so 's' can actually stop playback

    # Share playlist persistence with the console app.
    from .app import ConsoleApp

    shell = ConsoleApp.__new__(ConsoleApp)
    shell.playlist_path = "playlist.json"
    shell._player = None
    shell._load_playlist()
    st.playlist = list(shell.playlist)
    st.played = set(shell._restored_played)

    def prompt(scr, text: str) -> str:
        curses.echo()
        scr.nodelay(False)  # getstr must BLOCK; the main loop is non-blocking
        h, w = scr.getmaxyx()
        scr.addstr(h - 1, 0, (text + ": ").ljust(w - 1)[: w - 1])
        scr.refresh()
        try:
            s = scr.getstr(h - 1, len(text) + 2, 200).decode("utf-8", "ignore").strip()
        finally:
            scr.nodelay(True)
            curses.noecho()
        return s

    def do_encode(scr):
        path = prompt(scr, "file to encode")
        if not path or not os.path.exists(path):
            st.logline("no such file")
            return
        mode, rate, comp, fec = st.mode, st.symbol_rate, st.compress, st.use_fec

        def job():
            from .encoder import encode_file_paths

            paths = encode_file_paths(
                path, mode=mode, compress=comp, symbol_rate=rate, use_fec=fec
            )
            analytics.record_encode(mode, os.path.getsize(path), ok=bool(paths))
            analytics.save()
            st.playlist.extend(paths)
            return f"encoded -> {', '.join(paths)}"

        _worker(st, results, job, f"encoding {os.path.basename(path)}")

    def do_decode(scr, retry: bool):
        path = prompt(scr, "WAV to decode")
        if not path or not os.path.exists(path):
            st.logline("no such file")
            return
        mode, rate = st.mode, st.symbol_rate

        def job():
            from .decoder import decode_wav_file, decode_with_retry
            from .utils.wavio import SAMPLE_RATE, read_wav, resample

            if retry:
                data, sr = read_wav(path)
                if sr != SAMPLE_RATE:
                    data = resample(data, sr, SAMPLE_RATE)
                saved = decode_with_retry(data, mode, rate)
            else:
                saved = decode_wav_file(path, mode, rate)
            analytics.record_decode(
                mode, sum(os.path.getsize(p) for p in saved), ok=bool(saved)
            )
            analytics.save()
            return f"{len(saved)} file(s): {', '.join(saved) or '-'}"

        _worker(st, results, job, f"decoding {os.path.basename(path)}")

    def do_record(scr):
        from .audio_io import SOUNDDEVICE_AVAILABLE, ReceiveSession, Recorder

        if not SOUNDDEVICE_AVAILABLE:
            st.logline("sounddevice unavailable")
            return
        secs = prompt(scr, "record seconds [30]") or "30"
        rec = Recorder()
        rec.volume_callback = lambda v: setattr(st, "volume", v)
        st.recording = True

        def job():
            try:
                session = ReceiveSession(st.mode, st.symbol_rate, rec)
                saved = session.run(float(secs))
                return f"recorded; {len(saved)} file(s)"
            finally:
                st.recording = False

        _worker(st, results, job, "recording")

    def tui(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        from .config import CONFIG

        # Stats/assembly pane refresh period (ms) — the reference's 2 s Qt
        # poll timer, key finally wired (ui.refresh_interval).
        refresh_s = max(0.1, float(CONFIG.get("ui.refresh_interval", 2000)) / 1000.0)
        last_stats = 0.0
        while True:
            now = time.time()
            if now - last_stats > refresh_s:
                from .decoder import get_assembly_status, get_reception_stats

                st.stats = dict(get_reception_stats())
                st.assemblies = get_assembly_status()
                st.host = monitor.sample()
                last_stats = now
            try:
                while True:
                    st.logline(results.get_nowait())
            except queue.Empty:
                pass

            scr.erase()
            h, w = scr.getmaxyx()
            for y, line in enumerate(render_screen(st, w - 1, log_height=8)[: h - 1]):
                scr.addstr(y, 0, line)
            scr.refresh()

            ch = scr.getch()
            if ch == -1:
                time.sleep(0.05)
                continue
            key = chr(ch) if 0 < ch < 256 else ""
            if key == "q":
                # Persist through the console app's shared writer.
                shell.playlist = st.playlist
                shell._restored_played = set(st.played)
                shell._save_playlist()
                return
            if ch == 9 or key == "]":  # tab
                st.tab = (st.tab + 1) % len(TABS)
            elif key == "[":
                st.tab = (st.tab - 1) % len(TABS)
            elif key == "m":
                from .modem import MODES

                names = list(MODES)
                st.mode = names[(names.index(st.mode) + 1) % len(names)]
            elif key == "r":
                val = prompt(scr, "symbol rate")
                if val.isdigit():
                    st.symbol_rate = int(val)
            elif key == "c":
                st.compress = not st.compress
            elif key == "F":
                st.use_fec = not st.use_fec
            elif key == "e" and st.tab == 0:
                do_encode(scr)
            elif key == "d" and st.tab == 1:
                do_decode(scr, retry=False)
            elif key == "y" and st.tab == 1:
                do_decode(scr, retry=True)
            elif key == "R" and st.tab == 1:
                do_record(scr)
            elif st.tab == 2:
                if key == "a":
                    p = prompt(scr, "add to playlist")
                    if p:
                        st.playlist.append(p)
                elif key == "x":
                    st.playlist.clear()
                    st.played.clear()
                elif key == "t":
                    st.ptt_port = prompt(scr, "PTT port (empty=off)") or None
                elif key == "p" and st.playlist:
                    st.sel = min(st.sel, len(st.playlist) - 1)
                    target = st.playlist[st.sel]

                    def job(target=target):
                        from .audio_io import transmit

                        st.playing = target
                        try:
                            # Shared player: the 's' key calls tx_player.stop(),
                            # which ends transmit()'s is_busy() wait and drops
                            # PTT via the context exit.
                            transmit(target, st.ptt_port, "RTS", tx_player)
                        finally:
                            st.playing = None
                            st.played.add(target)
                        return f"played {target}"

                    _worker(st, results, job, f"playing {os.path.basename(target)}")
                elif key == "s":
                    try:
                        tx_player.stop()
                    except Exception:
                        pass
                    st.playing = None
                elif ch == curses.KEY_DOWN:
                    st.sel = min(st.sel + 1, max(0, len(st.playlist) - 1))
                elif ch == curses.KEY_UP:
                    st.sel = max(st.sel - 1, 0)
            elif st.tab == 3:
                if key == "n":
                    p = prompt(scr, "WAV to analyze (empty = ambient)")

                    def job(p=p):
                        from .intelligence import analyze_channel, get_recommended_mode

                        samples = None
                        if p and os.path.exists(p):
                            from .utils.wavio import read_wav

                            samples, _ = read_wav(p)
                        cond = analyze_channel(samples)
                        st.channel = {
                            "snr_db": cond["snr_db"],
                            "recommended": get_recommended_mode(cond),
                        }
                        return f"SNR {cond['snr_db']:.1f} dB -> {st.channel['recommended']}"

                    _worker(st, results, job, "analyzing channel")
                elif key == "g":
                    from .diagrams import mode_diagram

                    for line in mode_diagram(st.mode, st.symbol_rate).splitlines():
                        st.logline(line)

    curses.wrapper(tui)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
