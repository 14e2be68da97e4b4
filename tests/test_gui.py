"""Tests for the tkinter GUI's headless core (gui.py).

The tk widget layer needs a display; everything it renders or drives is
produced by :class:`GuiViewModel` and :func:`mode_diagram_primitives`, which
are exercised here without tk. A display-gated smoke test instantiates the
real window when $DISPLAY exists (skipped in headless CI).
"""

import os
import queue
import time

import numpy as np
import pytest

from audio_modem_radio.gui import GuiViewModel, mode_diagram_primitives
from audio_modem_radio.modem import MODES


def _drain(vm, kinds=None, timeout=120.0):
    """Collect events until a terminal event (encoded/decoded/error)."""
    events = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            event = vm.events.get(timeout=0.5)
        except queue.Empty:
            continue
        events.append(event)
        if event[0] in ("encoded", "decoded", "error"):
            return events
    raise AssertionError(f"no terminal event; saw {events}")


@pytest.fixture
def vm(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return GuiViewModel(playlist_path=str(tmp_path / "playlist.json"))


# --- diagram primitives ---------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_diagram_primitives_all_modes(mode):
    w, h = 360, 180
    prims = mode_diagram_primitives(mode, 9600, w, h)
    assert prims, mode
    kinds = {p[0] for p in prims}
    assert kinds <= {"polyline", "rect", "oval", "text"}
    # Nothing may escape the widget (allow small oval/label overhang margin).
    for p in prims:
        if p[0] == "polyline":
            for x, y in p[1]:
                assert -10 <= x <= w + 10 and -10 <= y <= h + 10, (mode, p[:1], x, y)
        elif p[0] in ("rect", "oval"):
            assert -10 <= p[1] <= w + 10 and -10 <= p[2] <= h + 10, (mode, p)
    # Every diagram is more than the title text.
    assert len(prims) > 1, mode


def test_diagram_unknown_mode():
    prims = mode_diagram_primitives("NOPE")
    assert any("unknown" in str(p) for p in prims)


def test_diagram_shapes_by_family():
    # PSK: waveform polyline + 4 constellation points.
    prims = mode_diagram_primitives("QPSK")
    assert sum(p[0] == "oval" for p in prims) == 4
    assert any(p[0] == "polyline" and len(p[1]) > 16 for p in prims)
    # OFDM: spectrum rects.
    assert any(p[0] == "rect" for p in mode_diagram_primitives("OFDM4"))
    # HELL: glyph raster rects.
    assert sum(p[0] == "rect" for p in mode_diagram_primitives("HELLSCHREIBER")) > 20


# --- view model workflows ----------------------------------------------------------


def test_encode_then_decode_roundtrip(vm, tmp_path):
    payload = bytes(np.random.default_rng(7).integers(0, 256, 400, dtype=np.uint8))
    src = tmp_path / "hello.bin"
    src.write_bytes(payload)

    vm.mode, vm.symbol_rate = "QPSK", 9600
    t = vm.start_encode(str(src))
    events = _drain(vm)
    t.join(timeout=60)
    encoded = [e for e in events if e[0] == "encoded"]
    assert encoded, events
    wavs = encoded[0][1]
    assert wavs and all(os.path.exists(p) for p in wavs)
    # Encoded output lands on the playlist like the reference (:1042-1054).
    assert wavs[0] in vm.playlist

    t = vm.start_decode(wavs[0])
    events = _drain(vm)
    t.join(timeout=60)
    decoded = [e for e in events if e[0] == "decoded"]
    assert decoded, events
    saved = decoded[0][1]
    assert len(saved) == 1
    assert open(saved[0], "rb").read() == payload


def test_record_with_file_recorder(vm, tmp_path):
    """Live-capture workflow against the deterministic fake backend, with
    level events like the reference volume meter."""
    from audio_modem_radio.audio_io import FileRecorder
    from audio_modem_radio.encoder import encode_file

    src = tmp_path / "cap.bin"
    src.write_bytes(b"captured payload!" * 5)
    wav = encode_file(str(src), "QPSK", True, 9600)

    rec = FileRecorder(wav)
    t = vm.start_record(seconds=1.0, recorder=rec)
    events = _drain(vm)
    t.join(timeout=60)
    decoded = [e for e in events if e[0] == "decoded"]
    assert decoded and decoded[0][1], events
    assert open(decoded[0][1][0], "rb").read() == src.read_bytes()


def test_single_worker_at_a_time(vm, tmp_path):
    """Starting an operation while another runs must be refused with an
    error event (the reference disables the button). Deterministic: the
    first worker is held open by an explicit gate — racing a real 100-byte
    encode against the second start made this flaky on a loaded box (the
    encode could finish first, legitimately allowing the second start)."""
    import threading

    src = tmp_path / "f.bin"
    src.write_bytes(b"x" * 100)
    gate = threading.Event()
    started = vm._spawn("encode", gate.wait)
    assert vm.busy
    vm.start_decode(str(src))
    events = _drain(vm)
    gate.set()
    started.join(timeout=60)
    assert any(e[0] == "error" and "running" in e[2] for e in events), events


def test_progress_and_multipart(vm, tmp_path):
    src = tmp_path / "big.bin"
    src.write_bytes(bytes(np.random.default_rng(3).integers(0, 256, 30_000, dtype=np.uint8)))
    vm.mode, vm.symbol_rate, vm.split, vm.part_minutes = "QPSK", 9600, True, 1
    t = vm.start_encode(str(src))
    events = _drain(vm)
    t.join(timeout=120)
    assert any(e[0] == "progress" for e in events)
    assert any(e[0] == "encoded" for e in events)


def test_playlist_persistence(vm, tmp_path):
    vm.add_to_playlist("a.wav")
    vm.add_to_playlist("b.wav")
    vm.player.played.add("a.wav")
    vm.save_playlist()

    vm2 = GuiViewModel(playlist_path=vm.playlist_path)
    assert vm2.playlist == ["a.wav", "b.wav"]
    states = dict(vm2.playlist_states())
    assert states["a.wav"] == "played"
    assert states["b.wav"] == "pending"


def test_transmission_preview_and_analyze(vm, tmp_path):
    src = tmp_path / "p.bin"
    src.write_bytes(b"q" * 5000)
    text = vm.transmission_preview(str(src))
    assert "on air" in text and "B/s" in text
    assert vm.transmission_preview(str(tmp_path / "missing")) == ""
    report = vm.analyze(None)
    assert "recommended mode" in report
    assert isinstance(vm.host_status(), str)


def test_ptt_test_simulated(vm):
    vm.ptt_port = None  # SimulatedPort path
    vm.ptt_test()  # must not raise


def test_log_tail_and_save(vm, tmp_path):
    vm.log("hello from the gui test")
    tail = vm.log_tail()
    assert any("hello from the gui test" in line for line in tail)
    out = tmp_path / "saved.log"
    vm.save_log_to(str(out))
    assert "hello from the gui test" in out.read_text()


def test_stats_surfaces(vm):
    stats = vm.reception_stats()
    assert "total_files_received" in stats or stats  # dict shape per decoder
    assert isinstance(vm.assembly_status(), list)
    assert isinstance(vm.ptt_ports(), list)


# --- display-gated window smoke test ---------------------------------------------


@pytest.mark.skipif(not os.environ.get("DISPLAY"), reason="no X display")
def test_window_smoke(vm):
    import tkinter

    from audio_modem_radio.gui import FileBeepWindow

    try:
        window = FileBeepWindow(vm=vm)
    except tkinter.TclError as e:
        pytest.skip(f"display unusable: {e}")
    window._draw_diagram()
    window._pump_events()
    window._refresh_playlist_box()
    window.root.update_idletasks()
    window.root.destroy()


def test_monitor_streams_files_live(vm, tmp_path):
    """The monitor workflow surfaces files as frames complete (continuous
    StreamingDecoder drain; the reference can only one-shot 30 s windows)."""
    from audio_modem_radio.audio_io import FileRecorder
    from audio_modem_radio.encoder import encode_file

    src = tmp_path / "live.bin"
    src.write_bytes(b"monitored payload " * 8)
    wav = encode_file(str(src), "QPSK", True, 9600)

    rec = FileRecorder(wav)
    t = vm.start_monitor(recorder=rec, poll_s=0.1)
    deadline = time.time() + 90
    saved = []
    while time.time() < deadline and not saved:
        try:
            e = vm.events.get(timeout=0.5)
        except queue.Empty:
            continue
        if e[0] == "decoded" and e[1]:
            saved = e[1]
    vm.stop_monitor()
    t.join(timeout=60)
    assert saved, "monitor never surfaced the file"
    assert open(saved[0], "rb").read() == src.read_bytes()
    assert not vm.monitoring
