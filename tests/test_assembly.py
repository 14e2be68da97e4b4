"""Multi-part assembly and reception-stats tests."""

import time

import pytest

from audio_modem_radio.assembly import AssemblyRegistry, FileAssembly
from audio_modem_radio.framing import Frame, crc32


def _mk_frames(name: str, data: bytes, n_parts: int):
    size = len(data)
    fcrc = crc32(data)
    step = (size + n_parts - 1) // n_parts
    return [
        Frame(f"{name}.part{i+1}", data[i * step : (i + 1) * step], i, n_parts, size, fcrc)
        for i in range(n_parts)
    ]


def test_out_of_order_reassembly():
    data = bytes(range(256)) * 10
    frames = _mk_frames("f.bin", data, 4)
    reg = AssemblyRegistry()
    results = [reg.offer(f) for f in (frames[2], frames[0], frames[3], frames[1])]
    assert results[:3] == [None, None, None]
    assert results[3] == data


def test_quality_based_duplicate_replacement():
    asm = FileAssembly("f", 2, 100, 0)
    bad = b"\x00" * 50  # all zeros -> quality 0
    good = bytes(range(50))
    assert not asm.add_part(0, bad)
    assert asm.parts[0] == bad
    # higher-quality retransmission replaces the bad part
    asm.add_part(0, good)
    assert asm.parts[0] == good
    # a worse retransmission does not
    asm.add_part(0, bad)
    assert asm.parts[0] == good


def test_signal_quality_heuristic():
    q_zero = FileAssembly.calculate_signal_quality(b"\x00" * 100)
    q_rep = FileAssembly.calculate_signal_quality(b"abcde" * 100)
    q_rich = FileAssembly.calculate_signal_quality(bytes(range(256)))
    assert q_zero == 0.0
    assert q_rich > q_rep
    assert FileAssembly.calculate_signal_quality(b"") == 0.0


def test_bad_final_crc_keeps_assembly_alive_for_healing():
    data = bytes(range(200))
    frames = _mk_frames("f.bin", data, 2)
    # corrupt part 1's payload but claim the original file CRC
    corrupt = Frame(frames[1].name, b"\xff" * len(frames[1].data), 1, 2, len(data), crc32(data))
    reg = AssemblyRegistry()
    assert reg.offer(frames[0]) is None
    assert reg.offer(corrupt) is None  # complete but CRC-bad -> held for healing
    # the genuine part heals it
    assert reg.offer(frames[1]) == data


def test_expiry_purge():
    reg = AssemblyRegistry(timeout_seconds=0)
    frames = _mk_frames("slow.bin", b"x" * 100, 3)
    reg.offer(frames[0])
    time.sleep(0.01)
    assert reg.purge_expired()
    assert reg.get_status() == []


def test_progress_and_missing():
    asm = FileAssembly("f", 4, 100, 0)
    asm.add_part(1, b"bb")
    asm.add_part(3, b"dd")
    assert asm.get_progress() == 50.0
    assert asm.get_missing_parts() == [0, 2]
    with pytest.raises(ValueError):
        asm.assemble_file()


def test_stats_accumulate():
    data = bytes(range(100))
    reg = AssemblyRegistry()
    for f in _mk_frames("s.bin", data, 2):
        reg.offer(f)
    stats = reg.get_stats()
    assert stats["total_files"] == 1
    assert stats["total_bytes"] == len(data)
    assert stats["quality_samples"] == 2
    assert 0 <= stats["average_quality"] <= 1
    reg.clear_stats()
    assert reg.get_stats()["total_files"] == 0


def test_checkpoint_resume(tmp_path):
    data = bytes(range(256)) * 4
    frames = _mk_frames("resume.bin", data, 3)
    reg = AssemblyRegistry()
    reg.offer(frames[0])
    reg.offer(frames[2])
    ckpt = str(tmp_path / "assemblies.json")
    reg.save_state(ckpt)

    # "Restart": fresh registry resumes and completes with the missing part.
    reg2 = AssemblyRegistry()
    assert reg2.load_state(ckpt) == 1
    assert reg2.get_status()[0]["received"] == 2
    assert reg2.offer(frames[1]) == data


def test_checkpoint_drops_expired(tmp_path):
    reg = AssemblyRegistry(timeout_seconds=0)
    reg.offer(_mk_frames("old.bin", b"x" * 50, 2)[0])
    ckpt = str(tmp_path / "a.json")
    reg.save_state(ckpt)
    time.sleep(0.01)
    reg2 = AssemblyRegistry(timeout_seconds=0)
    assert reg2.load_state(ckpt) == 0


def test_load_missing_checkpoint():
    assert AssemblyRegistry().load_state("/nonexistent/path.json") == 0


# --- disk journal: restart-safe transfers (round 3) -------------------------


def test_journal_survives_restart(tmp_path):
    """Kill-and-restart between parts: a fresh registry (fresh process)
    pointed at the same journal reassembles bit-exact — no explicit
    save_state call anywhere (reference decoder.py:106-107, 251-253 intended
    resumable transfer; its in-memory version dies with the app)."""
    jd = str(tmp_path / ".assembly")
    data = bytes(range(256)) * 8
    frames = _mk_frames("journal.bin", data, 3)

    reg = AssemblyRegistry(journal_dir=jd)
    assert reg.offer(frames[0]) is None
    assert reg.offer(frames[2]) is None
    del reg  # process "dies" here; only the journal remains

    reg2 = AssemblyRegistry(journal_dir=jd)
    assert reg2.offer(frames[1]) == data
    # Completion drops the journal entry.
    import glob

    assert glob.glob(jd + "/*/meta.json") == []


def test_journal_replaced_part_survives_restart(tmp_path):
    """A healing retransmission (better-quality duplicate) is what the
    journal holds after a restart."""
    jd = str(tmp_path / ".assembly")
    good = bytes(range(200))
    frames = _mk_frames("heal.bin", good, 2)
    bad0 = Frame(frames[0].name, b"\x00" * len(frames[0].data), 0, 2,
                 frames[0].file_size, frames[0].file_crc)

    reg = AssemblyRegistry(journal_dir=jd)
    reg.offer(bad0)
    reg.offer(frames[0])  # heals part 0
    del reg

    reg2 = AssemblyRegistry(journal_dir=jd)
    assert reg2.offer(frames[1]) == good


def test_journal_expired_dropped_on_restart(tmp_path):
    jd = str(tmp_path / ".assembly")
    reg = AssemblyRegistry(timeout_seconds=0, journal_dir=jd)
    reg.offer(_mk_frames("old.bin", b"x" * 50, 2)[0])
    time.sleep(0.02)
    reg2 = AssemblyRegistry(timeout_seconds=0, journal_dir=jd)
    # The lazy replay happens on first use; the expired entry is dropped
    # from disk and never resumed.
    assert reg2.get_status() == []
    import glob

    assert glob.glob(jd + "/*/meta.json") == []


def test_journal_disabled_by_empty_dir(tmp_path):
    reg = AssemblyRegistry(journal_dir="")
    frames = _mk_frames("nojournal.bin", b"y" * 100, 2)
    reg.offer(frames[0])
    assert reg.journal_dir is None


def test_journal_e2e_through_audio_restart(tmp_path, monkeypatch):
    """Two part-WAVs decoded by two separate decoder invocations with
    DIFFERENT registries (simulated process restart, journal via CONFIG
    default) still reassemble the file bit-exact."""
    monkeypatch.chdir(tmp_path)
    import numpy as np

    from audio_modem_radio.config import CONFIG
    from audio_modem_radio.decoder import decode_from_buffer
    from audio_modem_radio.encoder import encode_file_parts, split_file_for_transmission
    from audio_modem_radio.utils.wavio import read_wav

    CONFIG.set("modem.assembly_journal", str(tmp_path / "recv" / ".assembly"))
    data = bytes(np.random.default_rng(5).integers(0, 256, 30_000, dtype=np.uint8))
    src = tmp_path / "big.bin"
    src.write_bytes(data)
    parts = split_file_for_transmission(str(src), "QPSK", 9600, target_duration_sec=2)
    assert len(parts) >= 2
    wavs = encode_file_parts(parts, "QPSK", True, 9600)

    saved = []
    for w in wavs:
        samples, sr = read_wav(w)
        # Fresh registry per capture = fresh process per capture.
        saved = decode_from_buffer(
            samples, "QPSK", 9600, recv_dir=str(tmp_path / "recv"),
            registry=AssemblyRegistry(),
        )
    assert len(saved) == 1
    assert open(saved[0], "rb").read() == data
