"""The vmapped XLA sync tails (magic search + relabel + byte pack) against
the plain numpy references of ``plain_reference.py``.

DQPSK/OFDM dibit lanes take ``dibit_sync_and_pack_rotations`` (or the
unrotated ``dibit_sync_and_pack`` with ``cfo_retry`` off), DBPSK sign-bit
lanes ``bit_sync_and_pack_rotations``; ``parallel.batch`` wires them into
``demod_pack_batch``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import plain_reference as ref
from audio_modem_radio.framing import (
    MAGIC_BIT_PATTERN,
    MAGIC_BIT_PATTERN2,
    crc32,
    pack_frame,
    parse_frames,
)
from audio_modem_radio.modem import modulate
from audio_modem_radio.ops.common import (
    bit_sync_and_pack_rotations,
    relabel_shift_pack,
)
from audio_modem_radio.parallel.batch import _dibit_sync_tail, demod_pack_batch


def _valid(out, i):
    packed, n_valid, found = out
    return bytes(np.asarray(packed[i])[: int(n_valid[i])]), bool(np.asarray(found)[i])


def _embed_qpsk_magic(hi, lo, t0, k=0):
    """The validated magic (pattern + follow-up) at even-parity dibit t0,
    as received under a k quarter-turn rotation (sector -> sector + k)."""
    p = ref.bits_of(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    n = len(p) // 2
    sh, sl = ref.relabel_dibits(p[0 : 2 * n : 2], p[1 : 2 * n : 2], -k)
    hi[t0 : t0 + n] = sh
    lo[t0 : t0 + n] = sl


@pytest.mark.parametrize("seed", [0, 1])
def test_relabel_shift_pack_matches_reference(seed):
    m = 256 * 128
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2, m, dtype=np.uint8)
    lo = rng.integers(0, 2, m, dtype=np.uint8)
    for s, k in ((seed * 7 + 1, seed), (8 + 2 * seed, (seed + 1) % 4), (1027, 3)):
        packed, n_valid = relabel_shift_pack(
            jnp.asarray(hi), jnp.asarray(lo), jnp.int32(s), jnp.int32(k)
        )
        got = bytes(np.asarray(packed)[: int(n_valid)])
        assert got == ref.relabel_shift_pack(hi, lo, s, k)


@pytest.mark.parametrize("hyp", [0, 1, 2, 3])
def test_bpsk_sync_and_pack(hyp):
    """The DBPSK tail finds the magic under hypothesis ``hyp`` (re, im, ~re,
    ~im) and packs the same bytes as the plain reference."""
    m = 256 * 128
    rng = np.random.default_rng(40 + hyp)
    true_bits = rng.integers(0, 2, m, dtype=np.uint8)
    start = 1000 + hyp * 3
    pat = ref.bits_of(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    true_bits[start : start + len(pat)] = pat
    other = rng.integers(0, 2, m, dtype=np.uint8)
    for p in (pat[:16], pat[:16] ^ 1):  # no accidental magic in the decoy
        win = np.lib.stride_tricks.sliding_window_view(other, len(p))
        for idx in np.nonzero((win == p).all(axis=1))[0]:
            other[idx] ^= 1
    stream = true_bits if hyp < 2 else true_bits ^ 1
    re = stream if hyp % 2 == 0 else other
    im = stream if hyp % 2 == 1 else other

    packed, n_valid, found = bit_sync_and_pack_rotations(
        jnp.asarray(re), jnp.asarray(im), MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2
    )
    want, want_found = ref.bit_sync(re, im)
    assert bool(found) and want_found
    assert bytes(np.asarray(packed)[: int(n_valid)]) == want
    assert want == ref.pack_from(true_bits, start)


@pytest.mark.parametrize("mode,n_psk", [("QPSK", 4), ("BPSK", 2)])
@pytest.mark.parametrize("cfo_retry", [True, False])
@pytest.mark.parametrize("layout", ["flat", "rows"])
def test_production_sync_tail_wiring(mode, n_psk, cfo_retry, layout):
    """demod_pack_batch end to end on real captures, flat (B, N) input or
    host-shaped blocked rows: every capture syncs and parses its frame."""
    from audio_modem_radio.parallel.batch import host_shape_batch

    rng = np.random.default_rng(17)
    payload = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    framed = pack_frame("w.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate(mode, framed, 9600), np.float32)
    n = 1 << int(np.ceil(np.log2(len(wave))))
    batch = np.zeros((2, n), np.float32)
    batch[0, : len(wave)] = wave
    batch[1, 13 : 13 + len(wave)] = wave[: n - 13]
    x = host_shape_batch(batch, mode, 9600) if layout == "rows" else batch
    assert x.ndim == (3 if layout == "rows" else 2)
    out = demod_pack_batch(jnp.asarray(x), mode, 9600, cfo_retry=cfo_retry)
    for i in range(2):
        raw, found = _valid(out, i)
        frames = parse_frames(raw)
        assert found and frames and frames[0].data == payload


@pytest.mark.parametrize("mode,n_sub", [("OFDM4", 4), ("OFDM8", 8)])
def test_ofdm_sync_tail_wiring(mode, n_sub):
    """OFDM dual dibit streams through the same dibit tail as DQPSK; the
    byte stream equals the plain reference sync on the same lanes."""
    from audio_modem_radio.ops.ofdm import ofdm_decision_streams_batch

    rng = np.random.default_rng(23)
    payload = rng.integers(0, 256, 1200, dtype=np.uint8).tobytes()
    framed = pack_frame("o.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate(mode, framed, 9600), np.float32)
    n = 1 << int(np.ceil(np.log2(len(wave))))
    batch = np.zeros((2, n), np.float32)
    batch[:, : len(wave)] = wave

    hi, lo = ofdm_decision_streams_batch(jnp.asarray(batch), 9600.0, 12000.0, n_sub, 96000)
    out = _dibit_sync_tail(hi, lo, True)
    for i in range(2):
        raw, found = _valid(out, i)
        want, want_found = ref.dibit_sync(np.asarray(hi[i]), np.asarray(lo[i]))
        assert found and want_found and raw == want
        frames = parse_frames(raw)
        assert frames and frames[0].data == payload


def test_fsk_batch_matches_vmap():
    """The batched dual-tone path on host-shaped rows == vmapped
    single-capture bits on the flat captures, and its pass 2 equals the
    plain per-bit energy detector at the same winning offset."""
    from audio_modem_radio.ops.fsk import (
        _fsk_blocked_templates, _fsk_geometry, _samples_per_bit,
        fsk_demod_bits, fsk_dual_bits_rows_batch,
    )
    from audio_modem_radio.parallel.batch import host_shape_batch

    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    framed = pack_frame("f.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate("FSK1200", framed, 1200), np.float32)
    n = (len(wave) // 1280 + 2) * 1280
    batch = np.zeros((2, n), np.float32)
    batch[0, : len(wave)] = wave
    batch[1, 777 : 777 + len(wave)] = wave  # shifted capture

    rows = host_shape_batch(batch, "FSK1200", 1200)
    bits_b = np.asarray(
        fsk_dual_bits_rows_batch(jnp.asarray(rows), 1200.0, 1200.0, 2200.0, 96000)
    )
    bits_v = np.asarray(
        jax.vmap(
            lambda x: fsk_demod_bits(x, 1200.0, 1200.0, 2200.0, 96000, mlse=False)[0]
        )(jnp.asarray(batch))
    )
    spb = _samples_per_bit(96000, 1200)
    n_sig = len(wave) // spb
    assert np.array_equal(bits_b[0, :n_sig], bits_v[0, :n_sig])
    assert np.mean(bits_b[1, :n_sig] != bits_v[1, :n_sig]) < 0.01

    # Plain reference of pass 2 at offset 0 on capture 0 (its winning offset).
    spr, row, ov = _fsk_geometry(spb)
    W = _fsk_blocked_templates(spb, 1200.0, 2200.0, 96000, 8)
    want = ref.fsk_dual_bits(rows[0], W, 0, spr)
    sig = n_sig - spr  # the last row's overlap tail sees pad garbage
    assert np.array_equal(bits_b[0, :sig], want[:sig])


def test_fsk_batch_e2e_decode(tmp_path):
    """decode_wav_batch FSK1200 through the batched path round-trips."""
    from audio_modem_radio.assembly import AssemblyRegistry
    from audio_modem_radio.encoder import encode_file
    from audio_modem_radio.parallel.batch import decode_wav_batch

    rng = np.random.default_rng(8)
    payload = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    src = tmp_path / "x.bin"
    src.write_bytes(payload)
    wav = encode_file(str(src), mode="FSK1200", symbol_rate=1200, cache_dir=str(tmp_path))
    reg = AssemblyRegistry()
    res = decode_wav_batch([wav], "FSK1200", 1200, recv_dir=str(tmp_path / "recv"), registry=reg)
    saved = [p for r in res for p in r]
    assert saved and open(saved[0], "rb").read() == payload


def test_relabel_pack_decodes_frame():
    """Decision lanes -> plain reference search for (s, k) -> XLA relabel +
    pack -> the frame parses."""
    from audio_modem_radio.ops.psk import psk_decision_streams_batch

    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    framed = pack_frame("k.bin", payload, 0, 1, len(payload), crc32(payload))
    wave = np.asarray(modulate("QPSK", framed, 9600), np.float32)
    n = 1 << int(np.ceil(np.log2(len(wave))))
    batch = np.zeros((1, n), np.float32)
    batch[0, : len(wave)] = wave

    hi, lo = psk_decision_streams_batch(jnp.asarray(batch), 9600.0, 3000.0, 96000, 4, True)
    hi, lo = np.asarray(hi[0]), np.asarray(lo[0])
    exact = ref.bits_of(MAGIC_BIT_PATTERN)
    found = None
    for k in range(4):
        bits = ref.interleave(*ref.relabel_dibits(hi, lo, k))
        p = ref.first_validated(bits, exact, exact[:0], 0, len(bits))
        if p is not None:
            found = (p, k)
            break
    assert found is not None
    packed, n_valid = relabel_shift_pack(
        jnp.asarray(hi), jnp.asarray(lo), jnp.int32(found[0]), jnp.int32(found[1])
    )
    frames = parse_frames(bytes(np.asarray(packed)[: int(n_valid)]))
    assert frames and frames[0].data == payload


@pytest.mark.parametrize("placement", ["tier1", "tier2", "late"])
def test_dibit_tail_magic_placement(placement):
    """A magic early, in the middle and late in a long stream: the tail's
    (bytes, found) equal the plain reference's."""
    m = 4096 * 128
    hi = np.zeros((2, m), np.uint8)
    lo = np.zeros((2, m), np.uint8)
    pos = {"tier1": 100, "tier2": 256 * 128 + 50, "late": 512 * 128 + 1234}[placement]
    for i in range(2):
        _embed_qpsk_magic(hi[i], lo[i], pos + i, k=i)
    out = _dibit_sync_tail(jnp.asarray(hi), jnp.asarray(lo), True)
    for i in range(2):
        raw, found = _valid(out, i)
        want, want_found = ref.dibit_sync(hi[i], lo[i])
        assert found and want_found and raw == want


def test_relabel_shift_pack_all_shifts_rotations():
    """Every (bit shift mod 8, rotation) combination equals the reference."""
    m = 16 * 128
    rng = np.random.default_rng(99)
    hi = rng.integers(0, 2, m, dtype=np.uint8)
    lo = rng.integers(0, 2, m, dtype=np.uint8)
    fn = jax.jit(relabel_shift_pack)
    for k in range(4):
        for s in range(8):
            packed, n_valid = fn(jnp.asarray(hi), jnp.asarray(lo), jnp.int32(s + 8 * k), jnp.int32(k))
            got = bytes(np.asarray(packed)[: int(n_valid)])
            assert got == ref.relabel_shift_pack(hi, lo, s + 8 * k, k), (s, k)


def test_bit_pack_all_shifts_hypotheses():
    """DBPSK: every (bit shift mod 8, hypothesis) combination packs the
    same bytes as the reference pack of the selected stream."""
    from audio_modem_radio.ops.common import pack_bits_from

    m = 16 * 128
    rng = np.random.default_rng(98)
    re = rng.integers(0, 2, m, dtype=np.uint8)
    im = rng.integers(0, 2, m, dtype=np.uint8)
    streams = [re, im, re ^ 1, im ^ 1]
    for hyp, stream in enumerate(streams):
        for s in range(8):
            packed, n_valid = pack_bits_from(jnp.asarray(stream), jnp.int32(s + hyp))
            got = bytes(np.asarray(packed)[: int(n_valid)])
            assert got == ref.pack_from(stream, s + hyp), (s, hyp)


@pytest.mark.parametrize("placement", ["early", "late", "mixed", "absent"])
def test_psk4_tail_equals_reference(placement):
    """The DQPSK tail on random lanes with the magic early, late, in one
    capture each, or absent: (bytes, found) equal the plain reference."""
    b, m = 2, 512 * 128
    rng = np.random.default_rng(sum(map(ord, placement)))
    hi = rng.integers(0, 2, (b, m), dtype=np.uint8)
    lo = rng.integers(0, 2, (b, m), dtype=np.uint8)
    prefix = 256 * 128
    if placement == "early":
        for i in range(b):
            _embed_qpsk_magic(hi[i], lo[i], 10 + 3 * i)
    elif placement == "late":
        hi[:, :prefix] = 0
        lo[:, :prefix] = 0
        for i in range(b):
            _embed_qpsk_magic(hi[i], lo[i], prefix + 1000 + i, k=2)
    elif placement == "mixed":
        _embed_qpsk_magic(hi[0], lo[0], 17)
        hi[1, :prefix] = 0
        lo[1, :prefix] = 0
        _embed_qpsk_magic(hi[1], lo[1], prefix + 555, k=1)
    else:
        hi[:, :prefix] = 0
        lo[:, :prefix] = 0
    out = _dibit_sync_tail(jnp.asarray(hi), jnp.asarray(lo), True)
    for i in range(b):
        raw, found = _valid(out, i)
        want, want_found = ref.dibit_sync(hi[i], lo[i])
        assert found == want_found and raw == want
        if placement != "absent":
            assert found


@pytest.mark.parametrize("placement", ["early", "late", "mixed", "absent"])
def test_psk2_tail_equals_reference(placement):
    b, m = 2, 512 * 128
    rng = np.random.default_rng(sum(map(ord, placement)) + 1)
    re = rng.integers(0, 2, (b, m), dtype=np.uint8)
    im = rng.integers(0, 2, (b, m), dtype=np.uint8)
    pat = ref.bits_of(MAGIC_BIT_PATTERN + MAGIC_BIT_PATTERN2)
    prefix = 256 * 128
    if placement == "early":
        for i in range(b):
            re[i, 20 + i : 20 + i + len(pat)] = pat
    elif placement == "late":
        re[:, :prefix] = 0
        im[:, :prefix] = 0
        for i in range(b):
            im[i, prefix + 777 + i : prefix + 777 + i + len(pat)] = pat ^ 1
    elif placement == "mixed":
        re[0, 31 : 31 + len(pat)] = pat
        re[1, :prefix] = 0
        im[1, :prefix] = 0
        re[1, prefix + 99 : prefix + 99 + len(pat)] = pat
    else:
        re[:, :prefix] = 0
        im[:, :prefix] = 0
    out = jax.vmap(
        lambda a, c: bit_sync_and_pack_rotations(a, c, MAGIC_BIT_PATTERN, MAGIC_BIT_PATTERN2)
    )(jnp.asarray(re), jnp.asarray(im))
    for i in range(b):
        raw, found = _valid(out, i)
        want, want_found = ref.bit_sync(re[i], im[i])
        assert found == want_found and raw == want
        if placement != "absent":
            assert found
