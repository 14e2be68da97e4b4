"""The batch path must be as robust as the single-capture path (VERDICT r2 #3).

Round 2's ``decode_wav_batch`` had frame parse + FEC + header-tolerant
recovery but not the no-sync rescue sweep, stream-FEC, denoise, or the ±5%
clock-drift hypotheses — the throughput path silently recovered strictly
fewer captures than ``decode_from_buffer`` on damaged input. These tests
corrupt a mixed capture set and assert the batch path recovers every file the
single path does (reference retry semantics: /root/reference/decoder.py:313-377).
"""

import numpy as np
import pytest

from audio_modem_radio.assembly import AssemblyRegistry
from audio_modem_radio.decoder import decode_from_buffer, decode_with_retry
from audio_modem_radio.encoder import encode_file
from audio_modem_radio.parallel.batch import decode_wav_batch
from audio_modem_radio.parallel.mesh import get_mesh
from audio_modem_radio.utils.wavio import read_wav, write_wav


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _encode(workdir, name, data, **kw):
    src = workdir / name
    src.write_bytes(data)
    return encode_file(str(src), **kw)


def _drift(samples: np.ndarray, factor: float) -> np.ndarray:
    """Simulate a TX clock fast by ``factor``: the capture holds the waveform
    read at stride ``factor`` (decode_with_retry's exact-inverse model)."""
    n = len(samples)
    dst = np.arange(int(n / factor), dtype=np.float64) * factor
    return np.interp(dst, np.arange(n, dtype=np.float64), samples).astype(np.float32)


def _sync_killed_capture(content: bytes, symbol_rate: int) -> np.ndarray:
    """A capture whose frame magic is DESTROYED at the byte level (8 flipped
    bits across the 16 sync bits): the demodulator cannot bit-align, packs
    from offset 0, and only the no-sync rescue sweep + the standalone
    FEC-tag anchor can recover the frame."""
    import zlib

    from audio_modem_radio.fec import wrap_fec
    from audio_modem_radio.framing import crc32, pack_frame
    from audio_modem_radio.modem import modulate
    from audio_modem_radio.utils.compression import TAG_ZLIB

    payload = wrap_fec(TAG_ZLIB + zlib.compress(content, 9), "convolutional")
    framed = bytearray(
        pack_frame("sync2.bin", payload, 0, 1, len(content), crc32(content))
    )
    framed[0] ^= 0x5A
    framed[1] ^= 0xA5
    return np.asarray(modulate("QPSK", bytes(framed), symbol_rate), np.float32)


def test_batch_recovers_everything_single_path_does(workdir):
    rate = 4800
    contents = [
        bytes(f"ladder capture {i} ".encode() * 50) for i in range(4)
    ]
    clean_wavs = [
        _encode(workdir, f"src{i}.bin", contents[i], mode="QPSK", symbol_rate=rate)
        for i in range(2)
    ]
    # capture 0: clean; capture 1: +5% TX clock drift; capture 2: magic
    # destroyed (no-sync rescue); capture 3: AWGN at 2.5 dB full-band SNR —
    # inside the differential-detection penalty window, so only the shared
    # ladder's coherent-tracked escalation recovers it (round 5: both paths
    # consume decoder.run_recovery_ladder, so this pins they stay equal).
    damaged_paths = []
    for i, wav in enumerate(clean_wavs):
        samples, sr = read_wav(wav)
        if i == 1:
            samples = _drift(samples, 1.05)
        p = str(workdir / f"damaged{i}.wav")
        write_wav(p, samples, sr)
        damaged_paths.append(p)
    p2 = str(workdir / "damaged2.wav")
    write_wav(p2, _sync_killed_capture(contents[2], rate), 96000)
    damaged_paths.append(p2)
    wav3 = _encode(workdir, "src3.bin", contents[3], mode="QPSK", symbol_rate=rate)
    s3, sr3 = read_wav(wav3)
    s3 = np.asarray(s3, np.float32)
    rng3 = np.random.default_rng(77)
    sigma3 = np.sqrt(np.mean(s3**2) / 10 ** (2.5 / 10.0))
    p3 = str(workdir / "damaged3.wav")
    write_wav(p3, (s3 + rng3.normal(0, sigma3, len(s3))).astype(np.float32), sr3)
    damaged_paths.append(p3)

    # The single path recovers each one (sanity precondition).
    for i, p in enumerate(damaged_paths):
        samples, sr = read_wav(p)
        reg = AssemblyRegistry()
        saved = decode_with_retry(
            samples, "QPSK", rate, recv_dir=str(workdir / f"single{i}"),
            registry=reg, dump_attempts=False,
        )
        assert saved, f"single path failed on capture {i}"
        assert open(saved[0], "rb").read() == contents[i]

    # The batch path must recover the same set in one call.
    reg = AssemblyRegistry()
    results = decode_wav_batch(
        damaged_paths, "QPSK", rate, recv_dir=str(workdir / "batch"),
        registry=reg, mesh=get_mesh(),
    )
    assert [len(r) for r in results] == [1, 1, 1, 1]
    for saved, expected in zip(results, contents):
        assert open(saved[0], "rb").read() == expected


def test_batch_stream_fec(workdir):
    """Whole-frame convolutional stream FEC through the batch entry point."""
    rate = 4800
    contents = [bytes(f"stream fec {i} ".encode() * 40) for i in range(2)]
    wavs = [
        _encode(
            workdir, f"sf{i}.bin", contents[i], mode="QPSK", symbol_rate=rate,
            use_fec=True, fec_type="stream",
        )
        for i in range(2)
    ]
    reg = AssemblyRegistry()
    results = decode_wav_batch(
        wavs, "QPSK", rate, recv_dir=str(workdir / "batch"),
        registry=reg, mesh=get_mesh(), stream_fec=True,
    )
    assert [len(r) for r in results] == [1, 1]
    for saved, expected in zip(results, contents):
        assert open(saved[0], "rb").read() == expected


def test_batch_denoise_flag(workdir):
    """denoise=True runs the spectral gate per capture before demod and the
    capture still round-trips."""
    rate = 4800
    content = b"denoised batch capture " * 40
    wav = _encode(workdir, "dn.bin", content, mode="QPSK", symbol_rate=rate)
    samples, sr = read_wav(wav)
    noisy = samples + np.random.default_rng(0).normal(0, 0.02, len(samples)).astype(
        np.float32
    )
    p = str(workdir / "dn.wav")
    write_wav(p, noisy, sr)
    results = decode_wav_batch(
        [p], "QPSK", rate, recv_dir=str(workdir / "batch"),
        registry=AssemblyRegistry(), mesh=get_mesh(), denoise=True,
    )
    assert len(results[0]) == 1
    assert open(results[0][0], "rb").read() == content


def test_batch_fsk_mlse_escalation(workdir):
    """Round 4 (VERDICT r3 weak #3): a marginal close-tone FSK capture whose
    equalizer-only batch front end parses nothing must be re-dispatched
    through the MLSE-refined path automatically — batch never decodes
    strictly worse than single-file, without the blanket 3x-cost
    ``modem.batch_mlse`` flag. Seeded at a measured point where the
    equalizer fails and MLSE succeeds; a healthy capture rides along to pin
    that escalation re-dispatches ONLY the failed rows.
    """
    from audio_modem_radio.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio.modem import modulate
    from audio_modem_radio.parallel.batch import decode_sample_batch

    rate = 9600
    data = np.random.default_rng(5).integers(0, 256, 300, dtype=np.uint8).tobytes()
    framed = pack_frame("m.bin", data, 0, 1, len(data), crc32(data))
    wave = np.asarray(modulate("FSK9600", framed, rate), np.float32)
    marginal = (
        wave + np.random.default_rng(2001).normal(0, 0.08, len(wave))
    ).astype(np.float32)

    # Preconditions of the seed: the single path decodes it; the batch
    # front end WITHOUT MLSE parses nothing (so recovery below can only
    # come from the escalation).
    reg = AssemblyRegistry()
    single = decode_from_buffer(
        marginal, "FSK9600", rate, recv_dir=str(workdir / "single"), registry=reg
    )
    assert single and open(single[0], "rb").read() == data
    raws = decode_sample_batch(marginal[None, :], "FSK9600", rate, fsk_mlse=False)
    assert not parse_frames(raws[0]), "seed must defeat the equalizer-only path"

    healthy = _encode(workdir, "ok.bin", b"healthy capture " * 30,
                      mode="FSK9600", symbol_rate=rate)
    p = str(workdir / "marginal.wav")
    write_wav(p, marginal, 96000)

    results = decode_wav_batch(
        [healthy, p], "FSK9600", rate, recv_dir=str(workdir / "batch"),
        registry=AssemblyRegistry(), mesh=get_mesh(),
    )
    assert len(results[0]) == 1 and len(results[1]) == 1
    assert open(results[1][0], "rb").read() == data


def test_batch_psk_coherent_escalation(workdir):
    """Round 4: a PSK capture inside the differential-detection penalty
    window (2.2 dB full-band SNR — differential BER ~1e-3, tracked ~6e-5)
    must be re-dispatched through the coherent V&V-tracked receiver when the
    batch's differential parse finds nothing, exactly like the single-file
    mode ladder. Pinned by config toggle: with the escalation disabled the
    batch loses the capture; with the default it recovers bit-exact."""
    from audio_modem_radio.config import CONFIG
    from audio_modem_radio.framing import crc32, pack_frame, parse_frames
    from audio_modem_radio.modem import modulate
    from audio_modem_radio.parallel.batch import decode_sample_batch

    rate = 4800
    data = np.random.default_rng(3).integers(0, 256, 512, dtype=np.uint8).tobytes()
    framed = pack_frame("t.bin", data, 0, 1, len(data), crc32(data))
    wave = np.asarray(modulate("QPSK", framed, rate), np.float32)
    sigma = float(np.sqrt(np.mean(wave**2) / 10 ** (2.2 / 10)))
    noisy = (
        wave + np.random.default_rng(23).normal(0, sigma, len(wave))
    ).astype(np.float32)

    # Precondition: the batched differential dispatch parses nothing.
    raws = decode_sample_batch(noisy[None, :], "QPSK", rate)
    assert not parse_frames(raws[0]), "seed must defeat differential detection"

    p = str(workdir / "marginal_psk.wav")
    write_wav(p, noisy, 96000)

    CONFIG.set("modem.psk_coherent_escalation", False)
    try:
        res_off = decode_wav_batch(
            [p], "QPSK", rate, recv_dir=str(workdir / "batch_off"),
            registry=AssemblyRegistry(), mesh=get_mesh(), drift_retry=False,
        )
    finally:
        CONFIG.set("modem.psk_coherent_escalation", True)
    assert not res_off[0], "without escalation this capture must be lost"

    results = decode_wav_batch(
        [p], "QPSK", rate, recv_dir=str(workdir / "batch_on"),
        registry=AssemblyRegistry(), mesh=get_mesh(),
    )
    assert len(results[0]) == 1
    assert open(results[0][0], "rb").read() == data
