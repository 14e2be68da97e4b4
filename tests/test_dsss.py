"""Real DSSS: 16-chip spread spectrum with measurable processing gain.

The reference's DSSS is a bare DBPSK alias (/root/reference/modem.py:380-383);
ours spreads for real (ops/dsss.py) and must decode below the noise floor
where the alias's physical layer is long dead. Alias interop is kept behind
``modem.dsss_compat_alias`` + a probe-gated receive fallback (COMPAT.md).
"""

import numpy as np

import audio_modem_radio as amr
from audio_modem_radio.config import CONFIG
from audio_modem_radio.framing import crc32
from audio_modem_radio.ops.dsss import (
    SPREAD,
    _PN_BITS,
    _PN_SIGN,
    dsss_real_demodulate,
    dsss_real_modulate,
)

RNG = np.random.default_rng(13)


def _framed(n=120, name="d.bin"):
    payload = RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
    return payload, amr.pack_frame(name, payload, 0, 1, n, crc32(payload))


def test_pn_sequence_properties():
    assert len(_PN_BITS) == SPREAD == 16
    assert set(_PN_BITS.tolist()) == {0, 1}
    np.testing.assert_array_equal(_PN_SIGN, 1.0 - 2.0 * _PN_BITS)
    # The first 15 chips are the K=4 m-sequence: two-valued periodic
    # autocorrelation (15 in phase, -1 at every nonzero shift).
    m = _PN_SIGN[:15]
    for s in range(1, 15):
        assert int(np.dot(m, np.roll(m, s))) == -1


def test_spreading_factor_on_wire():
    payload, framed = _framed(64)
    w = dsss_real_modulate(framed, 9600, 3000.0, 96000)
    wb = amr.modulate("BPSK", framed, 9600)
    assert len(w) == SPREAD * len(wb)


def test_dsss_roundtrip_clean_and_offset():
    payload, framed = _framed()
    wave = np.asarray(dsss_real_modulate(framed, 9600, 3000.0, 96000), np.float32)
    frames = amr.parse_frames(dsss_real_demodulate(wave, 9600, 3000.0, 96000))
    assert frames and frames[0].data == payload

    cap = np.concatenate([np.zeros(7777, np.float32), wave, np.zeros(3000, np.float32)])
    cap = cap + 0.02 * RNG.normal(size=len(cap)).astype(np.float32)
    frames = amr.parse_frames(dsss_real_demodulate(cap, 9600, 3000.0, 96000))
    assert frames and frames[0].data == payload


def test_dsss_processing_gain_below_noise_floor():
    """The whole point of the mode: frames recover at -6 dB full-band SNR,
    where the plain-DBPSK alias cannot even find its magic (~+3 dB floor;
    benchmarks/ber_results_r5.json BPSK rows). ~12 dB of coherent 16-chip gain
    minus differential-detection losses."""
    payload, framed = _framed(100, name="nf.bin")
    wave = np.asarray(dsss_real_modulate(framed, 9600, 3000.0, 96000), np.float32)
    p = float(np.mean(wave**2))
    rng = np.random.default_rng(5)
    for snr in (0.0, -6.0):
        noisy = wave + rng.normal(0, np.sqrt(p / 10 ** (snr / 10)), len(wave)).astype(
            np.float32
        )
        frames = amr.parse_frames(dsss_real_demodulate(noisy, 9600, 3000.0, 96000))
        assert frames and frames[0].data == payload, f"failed at {snr} dB"
    # And the alias's physical layer at the same -6 dB: dead.
    wb = np.asarray(amr.modulate("BPSK", framed, 9600), np.float32)
    pb = float(np.mean(wb**2))
    nb = wb + rng.normal(0, np.sqrt(pb / 10**-0.6), len(wb)).astype(np.float32)
    from audio_modem_radio.modem import bpsk_demodulate

    assert amr.parse_frames(bpsk_demodulate(nb, 9600, 3000.0, 96000)) == []


def test_dsss_cfo_rotation():
    payload, framed = _framed(80)
    wave = np.asarray(dsss_real_modulate(framed, 9600, 3000.0, 96000), np.float32)
    # A small carrier offset: the coherent chip sum tolerates ~baud/(2π·16)
    # of within-bit rotation; the common rotation cancels in the bit
    # differential + rotation sync.
    frames = amr.parse_frames(dsss_real_demodulate(wave, 9600, 3001.0, 96000))
    assert frames and frames[0].data == payload


def test_dsss_noise_only_yields_nothing():
    noise = 0.1 * RNG.normal(size=1 << 18).astype(np.float32)
    assert amr.parse_frames(dsss_real_demodulate(noise, 9600, 3000.0, 96000)) == []


def test_registry_real_by_default_and_alias_fallback():
    payload, framed = _framed(96, name="reg.bin")
    wave = amr.modulate("DSSS", framed, 9600)
    frames = amr.parse_frames(amr.demodulate("DSSS", np.asarray(wave), 9600))
    assert frames and frames[0].data == payload

    CONFIG.set("modem.dsss_compat_alias", True)
    try:
        wave_alias = amr.modulate("DSSS", framed, 9600)
        ref = amr.modulate("BPSK", framed, 9600)
        np.testing.assert_array_equal(np.asarray(wave_alias), np.asarray(ref))
    finally:
        CONFIG.set("modem.dsss_compat_alias", False)
    # Alias capture (plain DBPSK wire) decodes through the probe fallback.
    frames = amr.parse_frames(amr.demodulate("DSSS", np.asarray(wave_alias), 9600))
    assert frames and frames[0].data == payload


def test_dsss_batched_decode():
    payload, framed = _framed(100, name="bd.bin")
    wave = np.asarray(amr.modulate("DSSS", framed, 9600), np.float32)
    from audio_modem_radio.parallel.batch import decode_sample_batch

    n = 1 << 21
    batch = np.zeros((2, n), np.float32)
    batch[0, 500 : 500 + len(wave)] = wave[: n - 500]
    batch[1, 12345 : 12345 + len(wave)] = wave[: n - 12345]
    batch += 0.05 * RNG.normal(size=batch.shape).astype(np.float32)
    raws = decode_sample_batch(batch, "DSSS", 9600)
    for raw in raws:
        frames = amr.parse_frames(raw)
        assert frames and frames[0].data == payload


def test_dsss_magic_damage_rescue_e2e(tmp_path):
    """2 corrupted magic bits through real spread audio recover bit-exact
    via the no-sync rescue ladder."""
    from audio_modem_radio.decoder import decode_from_buffer

    payload, framed = _framed(100, name="hd.bin")
    bad = bytearray(framed)
    bad[1] ^= 0x20
    bad[2] ^= 0x01
    wave = np.asarray(amr.modulate("DSSS", bytes(bad), 9600), np.float32)
    saved = decode_from_buffer(wave, "DSSS", 9600, recv_dir=str(tmp_path / "recv"))
    assert saved, "rescue ladder recovered nothing"
    assert open(saved[0], "rb").read() == payload


def test_dsss_encode_decode_pipeline(tmp_path):
    from audio_modem_radio.decoder import decode_wav_file
    from audio_modem_radio.encoder import encode_file

    payload = RNG.integers(0, 256, 512, dtype=np.uint8).tobytes()
    src = tmp_path / "docd.bin"
    src.write_bytes(payload)
    wav = encode_file(str(src), mode="DSSS", cache_dir=str(tmp_path / "cache"))
    saved = decode_wav_file(wav, "DSSS", 9600, recv_dir=str(tmp_path / "recv"))
    assert saved and open(saved[0], "rb").read() == payload


def test_despread_batch_matches_single():
    """The batched banded-matmul despreader reproduces the single-capture
    strided-reshape despreader at EVERY chip alignment (including the
    zero-padded tail groups past the capture)."""
    import jax.numpy as jnp

    from audio_modem_radio.ops.dsss import _despread_all, _despread_all_batch

    rng = np.random.default_rng(77)
    for n in (16 * 40, 16 * 40 + 7):  # exact and ragged chip counts
        re = rng.normal(size=n).astype(np.float32)
        im = rng.normal(size=n).astype(np.float32)
        s_re, s_im = _despread_all(jnp.asarray(re), jnp.asarray(im))
        b_re = _despread_all_batch(jnp.asarray(re)[None, :])[0]
        b_im = _despread_all_batch(jnp.asarray(im)[None, :])[0]
        np.testing.assert_allclose(np.asarray(b_re), np.asarray(s_re), rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(b_im), np.asarray(s_im), rtol=0, atol=1e-5)


def test_dsss_batched_preshaped_rows_decode():
    """The host row-shaping path (blocked (B, r, 128*spchip) f32 rows) feeds
    the batched DSSS front end directly — same frames out as flat input."""
    from audio_modem_radio.parallel.batch import demod_pack_batch, host_shape_batch

    payload, framed = _framed(80, name="rows.bin")
    wave = np.asarray(amr.modulate("DSSS", framed, 9600), np.float32)
    n = 1 << 21
    batch = np.zeros((2, n), np.float32)
    batch[0, 300 : 300 + len(wave)] = wave[: n - 300]
    batch[1, 4096 : 4096 + len(wave)] = wave[: n - 4096]
    shaped = host_shape_batch(batch, "DSSS", 9600)
    assert shaped.ndim == 3 and shaped.dtype == np.float32
    packed, n_valid, _found = demod_pack_batch(shaped, "DSSS", 9600)
    for i in range(2):
        raw = bytes(np.asarray(packed[i])[: int(n_valid[i])])
        frames = amr.parse_frames(raw)
        assert frames and frames[0].data == payload


def test_dsss_batch_shorter_than_one_spread_group():
    """A batch of captures whose despread chip stream holds ZERO complete
    spread groups must degrade to not-found like the single-capture path
    (the banded batch despreader once crashed on a concat shape mismatch)."""
    import jax.numpy as jnp
    import numpy as np

    from audio_modem_radio.ops.dsss import SPREAD, _despread_all_batch

    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, SPREAD - 1)), jnp.float32)
    rows = _despread_all_batch(x)
    assert rows.shape == (3, SPREAD, 0)
