"""Native (C++) runtime library tests: frame scanner and WAV batch loader.

These compare the ctypes-bound native implementations against the pure-Python
equivalents; when no compiler/library is available the fallbacks are
exercised instead (same assertions hold).
"""

import numpy as np
import pytest

from audio_modem_radio import native
from audio_modem_radio.framing import crc32, pack_frame, parse_frames_detailed


def test_native_availability_reported():
    # In this build image g++ and zlib exist, so the library must build.
    assert isinstance(native.NATIVE_AVAILABLE, bool)


def _stream(payloads):
    out = b"\x00garbage\xaa"
    for i, (name, data, part, total) in enumerate(payloads):
        out += pack_frame(name, data, part, total, sum(len(p[1]) for p in payloads), 123 + i)
        out += b"\xff" * 7
    return out


def test_scan_frames_matches_python_parser(rng):
    data1 = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    data2 = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    raw = _stream([("a.bin", data1, 0, 2), ("a.bin.part2", data2, 1, 2)])

    py_valid, py_damaged = parse_frames_detailed(raw)
    nat_valid, nat_damaged = native.scan_frames(raw)
    assert [(f.name, f.data, f.part_number, f.total_parts) for f in nat_valid] == [
        (f.name, f.data, f.part_number, f.total_parts) for f in py_valid
    ]
    assert len(nat_damaged) == len(py_damaged)


def test_scan_frames_damaged_detection():
    data = b"payload!" * 40
    raw = bytearray(pack_frame("x", data))
    raw[-5] ^= 0xFF  # corrupt payload -> CRC fails
    valid, damaged = native.scan_frames(bytes(raw))
    assert valid == []
    assert len(damaged) == 1 and damaged[0].name == "x"


def test_scan_frames_empty_and_garbage():
    assert native.scan_frames(b"") == ([], [])
    assert native.scan_frames(b"FBPC") == ([], [])
    assert native.scan_frames(b"\x00" * 1000) == ([], [])


def test_load_wav_batch_roundtrip(tmp_path, rng):
    from audio_modem_radio.utils.wavio import write_wav

    paths = []
    refs = []
    for i in range(5):
        arr = rng.normal(0, 0.2, 1000 + 300 * i).astype(np.float32).clip(-1, 1)
        p = str(tmp_path / f"w{i}.wav")
        write_wav(p, arr, 96000)
        paths.append(p)
        refs.append(arr)

    out, rates, counts = native.load_wav_batch(paths, row_len=4000)
    assert out.shape == (5, 4000)
    for i, ref in enumerate(refs):
        assert rates[i] == 96000
        assert counts[i] == len(ref)
        # int16 quantization tolerance
        assert np.abs(out[i, : len(ref)] - ref).max() < 1e-3
        assert np.all(out[i, len(ref) :] == 0)


def test_load_wav_batch_bad_file(tmp_path):
    bad = str(tmp_path / "notwav.wav")
    open(bad, "wb").write(b"this is not a wav file at all")
    out, rates, counts = native.load_wav_batch([bad], row_len=100)
    assert rates[0] == 0 and counts[0] == 0


@pytest.mark.skipif(not native.NATIVE_AVAILABLE, reason="native lib unavailable")
def test_native_scan_speed_sanity(rng):
    # Not a benchmark, just a smoke check that a multi-MB scan completes fast.
    import time

    payload = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    raw = pack_frame("big.bin", payload) * 4
    t0 = time.perf_counter()
    valid, _ = native.scan_frames(raw)
    dt = time.perf_counter() - t0
    assert len(valid) == 4
    assert dt < 1.0


def test_native_crc32_prefix_find():
    """Native prefix-CRC scan agrees with the Python framing fallback."""
    import zlib

    import numpy as np

    from audio_modem_radio.native import available, crc32_prefix_find

    if not available():
        import pytest

        pytest.skip("native library unavailable")
    data = np.random.default_rng(3).integers(0, 256, 65536, dtype=np.uint8).tobytes()
    target = zlib.crc32(data[:40000]) & 0xFFFFFFFF
    assert crc32_prefix_find(data, target) == 40000
    assert crc32_prefix_find(data, 0xDEADBEEF) in (0,)  # no prefix matches


def test_native_viterbi_matches_jax_trellis(rng):
    """The C++ ACS sweep is decision-identical to the JAX single-block
    trellis (same L1 metric, same p0-on-tie rule, same traceback), hard and
    soft inputs, with and without known boundaries."""
    import jax.numpy as jnp

    from audio_modem_radio.fec import ConvolutionalEncoder, viterbi_decode_bits

    if not native.viterbi_available():
        pytest.skip("native library unavailable")
    data = rng.integers(0, 256, 350, dtype=np.uint8).tobytes()
    pairs = ConvolutionalEncoder().encode_bits(
        np.unpackbits(np.frombuffer(data, np.uint8))
    ).astype(np.float32)
    flat = pairs.reshape(-1).copy()
    idx = rng.choice(len(flat), 50, replace=False)
    flat[idx] = 1 - flat[idx]
    hard = flat.reshape(-1, 2)
    soft = np.clip(hard + rng.normal(0, 0.2, hard.shape), 0, 1).astype(np.float32)
    for pp in (hard, soft):
        for kb in (True, False):
            jx = np.asarray(viterbi_decode_bits(jnp.asarray(pp), known_boundaries=kb))
            nt = native.viterbi_decode_pairs(pp, known_boundaries=kb)
            np.testing.assert_array_equal(jx, nt)


def test_native_viterbi_long_container_roundtrip(rng):
    """Above the block-parallel threshold ViterbiDecoder routes through the
    native sweep; a 256 KB noisy container still decodes byte-exact."""
    from audio_modem_radio.fec import ConvolutionalEncoder, ViterbiDecoder

    if not native.viterbi_available():
        pytest.skip("native library unavailable")
    data = rng.integers(0, 256, 256 << 10, dtype=np.uint8).tobytes()
    enc = bytearray(ConvolutionalEncoder().encode(data))
    for k in rng.choice(len(enc) - 8, 200, replace=False):
        enc[k] ^= 1 << int(k % 8)  # sparse bit errors, Viterbi-correctable
    assert ViterbiDecoder().decode(bytes(enc)) == data
