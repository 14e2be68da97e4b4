"""chip_smoke.py off the card: it must refuse a CPU platform (and a
directory without the package), and its phase helpers must hold at tiny
sizes on the CPU backend — the same code the GPU run executes at full
size."""

import os
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, path], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_check_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


def test_script_fails_on_cpu_without_result():
    out = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_script_alone_fails_without_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_place_in_window(tmp_path):
    src = tmp_path / "tx.wav"
    pcm = np.arange(1, 101, dtype=np.int16)
    chip_smoke._write_pcm(str(src), pcm)
    out = tmp_path / "cap.wav"
    assert chip_smoke.place_in_window(str(src), str(out), 300, 17) == 100
    with wave.open(str(out)) as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (96000, 2, 1)
    cap = chip_smoke._read_pcm(str(out))
    assert len(cap) == 300 and not cap[:17].any() and not cap[117:].any()
    assert np.array_equal(cap[17:117], pcm)
    with pytest.raises(ValueError, match="exceed"):
        chip_smoke.place_in_window(str(src), str(out), 110, 17)


def test_stream_disagreement():
    packed = np.zeros((2, 8), np.uint8)
    n_valid = np.array([8, 4])
    found = np.array([True, True])
    base = (packed, n_valid, found)
    assert chip_smoke.stream_disagreement(base, base) == 0.0
    flipped = packed.copy()
    flipped[0, 3] = 1  # one bit of 96
    assert chip_smoke.stream_disagreement(base, (flipped, n_valid, found)) == 1 / 96
    shorter = (packed, np.array([8, 3]), found)  # 8 unmatched bits
    assert chip_smoke.stream_disagreement(base, shorter) == 8 / 96
    lost = (packed, n_valid, np.array([True, False]))
    assert chip_smoke.stream_disagreement(base, lost) == 32 / 96


def test_add_noise_snr():
    x = np.zeros((1, 200_000), np.float32)
    x[0, 50_000:150_000] = np.sin(np.arange(100_000) * 0.1).astype(np.float32)
    noisy = chip_smoke.add_noise(x, 10.0, seed=1)
    noise = noisy - x
    snr = 10 * np.log10(np.mean(x[0, 50_000:150_000] ** 2) / np.mean(noise**2))
    assert abs(snr - 10.0) < 0.2


def test_family_rows_are_the_benchmark_configs():
    rows = chip_smoke.family_rows()
    assert len(rows) == 12
    assert {"QPSK", "QPSK-nocfo", "NEURAL", "HELLSCHREIBER"} <= set(rows)


def test_farm_phase_tiny(tmp_path):
    chip_smoke.farm_phase(str(tmp_path), n_captures=2, minutes=0.05)


def test_cli_phase_tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI writes its analytics file to cwd
    chip_smoke.cli_phase(str(tmp_path), n_bytes=2000)


@pytest.mark.parametrize("name", list(chip_smoke.family_rows()))
def test_families_phase_tiny(name, tmp_path):
    rows = {name: chip_smoke.family_rows()[name]}
    chip_smoke.families_phase(str(tmp_path), n_captures=2, seconds=8.0, rows=rows)


def test_reference_check_flags_disagreement(tmp_path, monkeypatch):
    """A device stream that differs from the CPU's fails the phase."""
    paths, _payloads = chip_smoke.make_captures(
        str(tmp_path), "rf", "QPSK", 9600, 1, 96000, fill=0.6, seed=9
    )
    batch = chip_smoke.load_batch(paths)
    compiled, _x = chip_smoke.device_program(batch, "QPSK", 9600, True)

    def corrupt(x):
        packed, n_valid, found = compiled(x)
        return packed ^ 0xFF, n_valid, found

    with pytest.raises(AssertionError, match="disagreement"):
        chip_smoke.reference_check(batch, corrupt, "QPSK", 9600, True, seed=1)


def test_multi_phase_tiny(tmp_path):
    """Four virtual CPU devices stand in for four cards."""
    chip_smoke.multi_phase(str(tmp_path), n_captures=4, minutes=0.05, seq_minutes=0.2)
