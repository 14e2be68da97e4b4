"""Batched text (Hellschreiber) modes — VERDICT r2 #7.

Pixel energies are a reshape + mean-square and glyph classification is one
(B, n_blocks, 49) @ (49, 95) matmul (ops/hell.py hell_demod_text_batch), so
the text family batches like every other mode. These tests pin: batch ==
single-capture decode on clean audio, padding safety (bucket-padded captures
must not grow trailing garbage), the sync gate on noise captures, and the
decode_wav_batch / decode_from_buffer .txt surface for all three registered
text modes (reference wire format: /root/reference/hellschreiber.py:109-186).
"""

import numpy as np
import pytest

from audio_modem_radio.decoder import decode_from_buffer
from audio_modem_radio.ops.hell import (
    hellschreiber_demodulate,
    hellschreiber_demodulate_batch,
    hellschreiber_modulate,
)
from audio_modem_radio.parallel.batch import decode_wav_batch
from audio_modem_radio.utils.wavio import write_wav

TEXTS = ["HELLO GPU 123", "CQ CQ DE PY2ABC", "the quick brown fox?!"]


def _batchify(waves):
    n = max(len(w) for w in waves)
    out = np.zeros((len(waves), n), dtype=np.float32)
    for i, w in enumerate(waves):
        out[i, : len(w)] = w
    return out


@pytest.mark.parametrize("baud", [122.5, 61.25])
def test_batch_matches_single(baud):
    waves = [np.asarray(hellschreiber_modulate(t, baud), np.float32) for t in TEXTS]
    got = hellschreiber_demodulate_batch(_batchify(waves), baud)
    for text, wave, g in zip(TEXTS, waves, got):
        single = hellschreiber_demodulate(wave, baud)
        assert g == single == text


def test_padding_safe_stop():
    """A capture padded far past the closing rows decodes the same text —
    the all-on-row stop rule ends at the closing rows, not the pad."""
    wave = np.asarray(hellschreiber_modulate(TEXTS[0]), np.float32)
    padded = np.zeros(2 * len(wave) + 12345, np.float32)
    padded[: len(wave)] = wave
    assert hellschreiber_demodulate_batch(padded[None, :])[0] == TEXTS[0]


def test_noise_capture_gated_out():
    rng = np.random.default_rng(3)
    noise = rng.normal(0, 0.05, 96000).astype(np.float32)
    assert hellschreiber_demodulate_batch(noise[None, :]) == [""]


@pytest.mark.parametrize("mode", ["HELLSCHREIBER", "FELD_HELL", "SLOW_HELL"])
def test_decode_wav_batch_text_modes(mode, tmp_path):
    baud = 61.25 if mode == "SLOW_HELL" else 122.5
    paths = []
    for i, t in enumerate(TEXTS[:2]):
        w = np.asarray(hellschreiber_modulate(t, baud), np.float32)
        p = str(tmp_path / f"cap{i}.wav")
        write_wav(p, w, 96000)
        paths.append(p)
    noise = np.random.default_rng(0).normal(0, 0.05, 96000).astype(np.float32)
    pn = str(tmp_path / "noise.wav")
    write_wav(pn, noise, 96000)
    paths.append(pn)

    results = decode_wav_batch(paths, mode, 0, recv_dir=str(tmp_path / "recv"))
    assert [len(r) for r in results] == [1, 1, 0]
    for saved, expected in zip(results[:2], TEXTS[:2]):
        assert open(saved[0]).read() == expected
        assert saved[0].endswith(".txt")


def test_decode_from_buffer_text_parity(tmp_path):
    """The single-capture path saves the same text the batch path does."""
    wave = np.asarray(hellschreiber_modulate(TEXTS[1]), np.float32)
    saved = decode_from_buffer(wave, "HELLSCHREIBER", 0, recv_dir=str(tmp_path))
    assert len(saved) == 1
    assert open(saved[0]).read() == TEXTS[1]
    noise = np.random.default_rng(1).normal(0, 0.05, 96000).astype(np.float32)
    assert decode_from_buffer(noise, "HELLSCHREIBER", 0, recv_dir=str(tmp_path)) == []


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_preshaped_rows_match_flat(dtype):
    """(B, n_pix, spp) host pre-shaped pixel windows (the host-shaped layout,
    f32 view or int16 quantized) decode identically to the flat (B, N)
    device path."""
    import jax.numpy as jnp

    from audio_modem_radio.ops.hell import hell_demod_text_batch

    spp = int(round(96000 / 122.5))
    waves = [np.asarray(hellschreiber_modulate(t), np.float32) for t in TEXTS]
    batch = _batchify(waves)
    n_pix = batch.shape[1] // spp
    view = batch[:, : n_pix * spp].reshape(len(waves), n_pix, spp)
    if dtype == np.int16:
        shaped = np.clip(np.round(view * 32768.0), -32768, 32767).astype(np.int16)
    else:
        shaped = view
    chars_f, n_f, found_f = hell_demod_text_batch(jnp.asarray(batch), spp)
    chars_s, n_s, found_s = hell_demod_text_batch(jnp.asarray(shaped), spp)
    assert np.array_equal(np.asarray(n_f), np.asarray(n_s))
    assert np.array_equal(np.asarray(found_f), np.asarray(found_s))
    for i in range(len(waves)):
        k = int(np.asarray(n_f)[i])
        assert np.array_equal(np.asarray(chars_f)[i, :k], np.asarray(chars_s)[i, :k])


def test_host_shape_batch_hell_layout():
    """host_shape_batch ships hell captures as (B, n_pix, spp) windows (f32
    passthrough by default; int16 quantized with CONFIG device.int16_rows)."""
    from audio_modem_radio.parallel.batch import host_shape_batch

    wave = np.asarray(hellschreiber_modulate(TEXTS[0]), np.float32)
    batch = _batchify([wave, wave])
    shaped = host_shape_batch(batch, "HELLSCHREIBER", 9600)
    spp = int(round(96000 / 122.5))
    assert shaped.ndim == 3 and shaped.shape[2] == spp
    assert shaped.shape[1] == batch.shape[1] // spp
