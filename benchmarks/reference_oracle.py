"""Offline oracle: the reference's scipy receive chains, for BER parity runs.

These reimplement — vectorized, in numpy/scipy — the exact signal-processing
recipe of the reference's demodulators so the parity harness (ber_parity.py)
can run BOTH receivers over the same noisy captures and prove ours decodes at
least as well. Behavior sources (algorithms, constants, decision rules):

* DBPSK: /root/reference/modem.py:68-135 — Butterworth-4 bandpass
  carrier±baud, complex downconversion, Butterworth-4 LPF at baud, symbol
  sampling at stride ``fs/baud`` starting one symbol in, differential
  detection sign(Re{s[n]·conj(s[n-1])}), magic-prefix bit sync with
  offset-0 fallback.
* DQPSK: /root/reference/modem.py:189-266 — bandpass carrier±1.5·baud, LPF
  at baud, sampling offset half a symbol, differential angle quantized into
  four π/2 sectors rotated by π/4, Gray map 00/01/11/10.
* CPFSK: /root/reference/modem.py:298-341 — Butterworth-3 bandpasses at
  mark/space ±baud, Hilbert envelopes, per-sample energy comparison,
  majority vote over a ±¼-bit window at bit centers, magic sync.
* Hellschreiber RX: /root/reference/hellschreiber.py:156-186 — per-pixel
  mean-square energy threshold, then the naive per-7-pixel-group
  any-glyph-row lookup.

TRANSMIT oracles (for bidirectional wire interop rows — our RX must decode
reference-generated captures and vice versa):

* DBPSK TX: /root/reference/modem.py:28-65 — [1,0]x40 preamble,
  differential phase accumulation (bit 1 -> +π), per-symbol sine restart,
  10% linear edge ramps.
* DQPSK TX: /root/reference/modem.py:139-186 — [0,0]x30+[1,1]x10 preamble
  bits, Gray dibit -> phase increment, same per-symbol sine restart + ramps.
* CPFSK TX: /root/reference/modem.py:270-296 — 4x 0xAA preamble,
  continuous phase across bit boundaries.
* Hellschreiber TX: /root/reference/hellschreiber.py:109-153 — 10 all-on
  sync lines, 7x7 glyphs LSB-first + 2-pixel gap, 5 closing lines,
  per-pixel tone burst, peak-normalized to 0.8. The glyph font itself is
  wire data (not logic) and is taken from the package's re-encoded table
  (ops.hell.char_map — byte-identical to the reference's CHAR_MAP, verified
  in tests/test_ber_parity.py::test_tx_oracles_byte_exact_with_reference).

This is an oracle for benchmarks only — nothing in the package imports it.
The receivers under test live in audio_modem_radio/ops/ and share no code or
structure with this file.
"""

from __future__ import annotations

import numpy as np
from scipy import signal

MAGIC_BITS = np.unpackbits(np.frombuffer(b"FB", np.uint8))  # first 16 bits of FBPC


def _bits_to_bytes_synced(bits: np.ndarray) -> bytes:
    """Magic-prefix alignment then byte packing (reference modem.py:111-133).

    Searches the decoded bit stream for the first 16 bits of the FBPC magic;
    packs bytes from there, or from offset 0 if the magic never appears (the
    frame parser re-scans for magic at the byte level anyway).
    """
    bits = np.asarray(bits, np.uint8)
    start = 0
    if len(bits) >= 16:
        windows = np.lib.stride_tricks.sliding_window_view(bits, 16)
        hits = np.nonzero((windows == MAGIC_BITS).all(axis=1))[0]
        if len(hits):
            start = int(hits[0])
    usable = bits[start:]
    usable = usable[: len(usable) - (len(usable) % 8)]
    if len(usable) == 0:
        return b""
    return np.packbits(usable).tobytes()


def bpsk_demodulate_ref(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> bytes:
    """Reference DBPSK receiver (modem.py:68-135), vectorized."""
    spsym = int(samp_rate / baud)
    nyq = samp_rate / 2
    lo_c = max(0.01, (carrier - baud) / nyq)
    hi_c = min(0.99, (carrier + baud) / nyq)
    b, a = signal.butter(4, [lo_c, hi_c], btype="band")
    filtered = signal.filtfilt(b, a, np.asarray(samples, np.float64))

    t = np.arange(len(filtered)) / samp_rate
    baseband = filtered * np.exp(-2j * np.pi * carrier * t)
    b_lp, a_lp = signal.butter(4, baud / nyq, btype="low")
    baseband = signal.filtfilt(b_lp, a_lp, baseband)

    symbols = baseband[spsym::spsym]
    if len(symbols) < 2:
        return b""
    diffs = symbols[1:] * np.conj(symbols[:-1])
    bits = (np.real(diffs) < 0).astype(np.uint8)
    return _bits_to_bytes_synced(bits)


def qpsk_demodulate_ref(
    samples: np.ndarray, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> bytes:
    """Reference DQPSK receiver (modem.py:189-266), vectorized."""
    spsym = int(samp_rate / baud)
    nyq = samp_rate / 2
    lo_c = max(0.01, (carrier - 1.5 * baud) / nyq)
    hi_c = min(0.99, (carrier + 1.5 * baud) / nyq)
    b, a = signal.butter(4, [lo_c, hi_c], btype="band")
    filtered = signal.filtfilt(b, a, np.asarray(samples, np.float64))

    t = np.arange(len(filtered)) / samp_rate
    baseband = filtered * np.exp(-2j * np.pi * carrier * t)
    b_lp, a_lp = signal.butter(4, baud / nyq, btype="low")
    baseband = signal.filtfilt(b_lp, a_lp, baseband)

    symbols = baseband[spsym // 2 :: spsym]
    if len(symbols) < 2:
        return b""
    ang = np.angle(symbols[1:] * np.conj(symbols[:-1]))
    ang = np.where(ang < 0, ang + 2 * np.pi, ang)
    # Sector index 0..3 for centers 0, π/2, π, 3π/2 (boundaries at odd π/4).
    sector = np.floor((ang + np.pi / 4) / (np.pi / 2)).astype(np.int64) % 4
    gray = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.uint8)
    bits = gray[sector].reshape(-1)
    return _bits_to_bytes_synced(bits)


def fsk_demodulate_ref(
    samples: np.ndarray,
    baud: float = 1200,
    mark_freq: float = 1200.0,
    space_freq: float = 2200.0,
    samp_rate: int = 96000,
) -> bytes:
    """Reference CPFSK receiver (modem.py:298-341), vectorized."""
    spb = int(samp_rate / baud)
    nyq = samp_rate / 2
    x = np.asarray(samples, np.float64)

    def envelope(freq: float) -> np.ndarray:
        # The reference does NOT clamp these edges (modem.py:306) and raises
        # ValueError when freq - baud <= 0 — e.g. FSK1200's own default
        # mark=1200 at 1200 Bd. Clamp like its BPSK chain does (modem.py:76)
        # so the oracle can run at all; this only helps the reference.
        lo_e = max(0.01, (freq - baud) / nyq)
        hi_e = min(0.99, (freq + baud) / nyq)
        b, a = signal.butter(3, [lo_e, hi_e], btype="band")
        return np.abs(signal.hilbert(signal.filtfilt(b, a, x)))

    hard = (envelope(mark_freq) > envelope(space_freq)).astype(np.int64)

    centers = np.arange(spb // 2, len(hard), spb)
    quarter = spb // 4
    # Majority vote over the ±¼-bit window around each bit center.
    csum = np.concatenate([[0], np.cumsum(hard)])
    lo_i = np.maximum(centers - quarter, 0)
    hi_i = np.minimum(centers + quarter, len(hard))
    counts = csum[hi_i] - csum[lo_i]
    widths = np.maximum(hi_i - lo_i, 1)
    bits = (counts * 2 > widths).astype(np.uint8)
    return _bits_to_bytes_synced(bits)


def hellschreiber_demodulate_ref(
    samples: np.ndarray, baud: float = 122.5, samp_rate: int = 96000, threshold: float = 0.1
) -> str:
    """Reference Hellschreiber receiver (hellschreiber.py:156-186): mean-square
    pixel energy threshold, then each consecutive 7-pixel group (LSB-first)
    matched against ANY row of any glyph — the reference's own naive scheme."""
    from audio_modem_radio.ops.hell import char_map  # wire data only

    spp = int(round(samp_rate / baud))
    n_pix = len(samples) // spp
    if n_pix == 0:
        return ""
    e = (np.asarray(samples[: n_pix * spp], np.float64) ** 2).reshape(n_pix, spp).mean(1)
    pixels = (e > threshold).astype(np.int64)
    cm = char_map()
    weights = 1 << np.arange(7)
    text = []
    for i in range(0, n_pix - 6, 7):
        val = int((pixels[i : i + 7] * weights).sum())
        found = "?"
        for ch, rows in cm.items():
            if val in rows:
                found = ch
                break
        text.append(found)
    return "".join(text)


# --- transmit oracles (reference wire formats) --------------------------------


def _ramped_psk_wave(phases: np.ndarray, carrier: float, spsym: int, samp_rate: int) -> np.ndarray:
    """Per-symbol sine restart with 10% linear edge ramps (modem.py:52-63,
    177-184): every symbol is sin(2πc·t_sym + φ) windowed by the ramp
    envelope, t restarting at 0 each symbol."""
    t = np.arange(spsym) / samp_rate
    env = np.ones(spsym)
    ramp = int(spsym * 0.1)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    sym = np.sin(2 * np.pi * carrier * t[None, :] + phases[:, None]) * env[None, :]
    return sym.reshape(-1).astype(np.float32)


def bpsk_modulate_ref(
    data: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """Reference DBPSK transmitter (modem.py:28-65), vectorized."""
    bits = np.concatenate(
        [np.tile([1, 0], 40), np.unpackbits(np.frombuffer(data, np.uint8))]
    ).astype(np.float64)
    phases = np.cumsum(bits * np.pi)  # bit 1 flips phase, THEN the symbol is sent
    return _ramped_psk_wave(phases, carrier, int(samp_rate / baud), samp_rate)


def qpsk_modulate_ref(
    data: bytes, baud: float = 1200, carrier: float = 3000.0, samp_rate: int = 96000
) -> np.ndarray:
    """Reference DQPSK transmitter (modem.py:139-186), vectorized."""
    bits = np.concatenate(
        [np.tile([0, 0], 30), np.tile([1, 1], 10), np.unpackbits(np.frombuffer(data, np.uint8))]
    )
    if len(bits) % 2:
        bits = np.append(bits, 0)
    dib = bits.reshape(-1, 2)
    # Gray dibit -> phase increment: 00->0, 01->+π/2, 11->+π, 10->-π/2.
    inc_by_key = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi])  # key = 2*b0 + b1
    phases = np.cumsum(inc_by_key[dib[:, 0] * 2 + dib[:, 1]])
    return _ramped_psk_wave(phases, carrier, int(samp_rate / baud), samp_rate)


def fsk_modulate_ref(
    data: bytes,
    baud: float = 1200,
    mark_freq: float = 1200.0,
    space_freq: float = 2200.0,
    samp_rate: int = 96000,
) -> np.ndarray:
    """Reference CPFSK transmitter (modem.py:270-296), vectorized: 4x 0xAA
    preamble, per-bit tone with phase carried across bit boundaries."""
    bits = np.unpackbits(np.frombuffer(b"\xaa\xaa\xaa\xaa" + data, np.uint8))
    spb = int(round(samp_rate / baud))
    t = np.arange(spb) / samp_rate
    freqs = np.where(bits == 1, mark_freq, space_freq)
    dphi = 2 * np.pi * freqs * (spb / samp_rate)
    phi0 = np.concatenate([[0.0], np.cumsum(dphi)[:-1]]) % (2 * np.pi)
    chunks = np.sin(2 * np.pi * freqs[:, None] * t[None, :] + phi0[:, None])
    return (chunks.reshape(-1) * 0.9).astype(np.float32)


def hellschreiber_modulate_ref(
    text: str, baud: float = 122.5, carrier: float = 1000.0, samp_rate: int = 96000
) -> np.ndarray:
    """Reference Hellschreiber transmitter (hellschreiber.py:109-153)."""
    from audio_modem_radio.ops.hell import char_map  # wire data only

    cm = char_map()
    pixels = [1] * (7 * 10)
    for ch in text:
        rows = cm.get(ch)
        if rows is None:
            pixels.extend([0] * (7 * 7 + 2))
            continue
        for row in rows:
            pixels.extend((row >> b) & 1 for b in range(7))
        pixels.extend([0, 0])
    pixels.extend([1] * (7 * 5))
    spp = int(round(samp_rate / baud))
    t = np.arange(spp) / samp_rate
    tone = np.sin(2 * np.pi * carrier * t)
    out = (np.asarray(pixels, np.float64)[:, None] * tone[None, :]).reshape(-1)
    m = np.abs(out).max()
    if m > 0:
        out = out / m * 0.8
    return out.astype(np.float32)


RECEIVERS = {
    "BPSK": bpsk_demodulate_ref,
    "QPSK": qpsk_demodulate_ref,
    "FSK1200": lambda s, baud=1200, samp_rate=96000: fsk_demodulate_ref(
        s, baud, 1200.0, 2200.0, samp_rate
    ),
}
