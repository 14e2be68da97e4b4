"""Hellschreiber (Feld-Hell-style) text fax mode.

Wire-compatible with the reference glyph transmission format
(/root/reference/hellschreiber.py:109-152): 10 all-on 7-pixel sync rows, then
per character 7 rows of 7 pixels each (LSB-first within the row value) plus a
2-pixel inter-character gap, 5 all-on closing rows; each pixel is
``round(sample_rate/baud)`` samples of a 1 kHz tone or silence, normalized to
0.8 peak. The glyph font (7 rows × 5-bit patterns covering printable ASCII
32..126) is shared wire-format data with the reference (hellschreiber.py:11-107),
stored here packed as a base-32 string.

Array-first implementation: pixel synthesis is an outer product
``pixels ⊗ tone`` (one matmul-shaped op instead of a per-pixel Python loop),
and pixel detection is a reshape + per-window mean-square + threshold.

The receive side improves on the reference's decoder, which matches each
7-pixel group against *any single row* of *any* glyph and therefore cannot
round-trip text (hellschreiber.py:167-186). ``hellschreiber_demodulate``
locates the sync run, then classifies whole 7×7 glyph blocks by nearest
glyph-template match — ``decode(modulate(text)) == text`` holds on clean
audio. Pass ``naive=True`` for the reference's per-row behavior.
"""

from __future__ import annotations

import functools
import string
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from .common import matmul_precision

SAMPLE_RATE = 96000
SYNC_ROWS = 10
CLOSE_ROWS = 5
ROW_PIXELS = 7
CHAR_ROWS = 7
GAP_PIXELS = 2
CHAR_PIXELS = CHAR_ROWS * ROW_PIXELS + GAP_PIXELS  # 51

# Glyph font packed as base-32: 95 printable ASCII chars × 7 row values (0..31).
_B32 = string.digits + string.ascii_uppercase
_PACKED_FONT = (
    "00000004444404AAA0000AAVAVAA4FKE5U4OP248J3CIK8LIDC4800002488842842224804LEL4004"
    "4V4400000C48000V00000000CC01248G0EHJLPHE4C4444EEH1248VV2421HE26AIV22VGU11HE68GU"
    "HHEV124888EHHEHHEEHHF12C0CC0CC00CC0C48248G84200V0V008421248EH12404EHNLNGE4AHHVH"
    "HUHHUHHUEHGGGHEUHHHHHUVGGUGGVVGGUGGGEHGJHHFHHHVHHHE44444E72222ICHIKOKIHGGGGGGVH"
    "RLLHHHHPPLJJHEHHHHHEUHHUGGGEHHHLIDUHHUKIHFGGE11UV444444HHHHHHEHHHHHA4HHHLLLAHHA"
    "4AHHHHA4444V1248GVE88888E0G84210E22222E4AH0000000000V840000000E1FHFGGMPHHU00EGG"
    "HE11DJHHF00EHVGE698S8880FHHF1EGGMPHHH40C444E20622ICGGIKOKIC44444E00QLLLL00MPHHH"
    "00EHHHE00UHUGG00DJF1100MPGGG00EGE1U88S889600HHHJD00HHHA400HHLLA00HA4AH00HHF1E00"
    "V248V244844244444448442448000DI00"
)


@functools.lru_cache(maxsize=1)
def char_map() -> Dict[str, List[int]]:
    """Printable-ASCII char -> 7 row values (5-bit patterns)."""
    out: Dict[str, List[int]] = {}
    for i in range(95):
        rows = [_B32.index(c) for c in _PACKED_FONT[i * 7 : (i + 1) * 7]]
        out[chr(32 + i)] = rows
    return out


@functools.lru_cache(maxsize=1)
def _glyph_pixel_templates() -> np.ndarray:
    """(95, 49) float32: each glyph's 7x7 pixel block, rows LSB-first."""
    cm = char_map()
    out = np.zeros((95, CHAR_ROWS * ROW_PIXELS), dtype=np.float32)
    for i in range(95):
        rows = cm[chr(32 + i)]
        for r, val in enumerate(rows):
            for b in range(ROW_PIXELS):
                out[i, r * ROW_PIXELS + b] = (val >> b) & 1
    return out


def text_to_pixels(text: str) -> np.ndarray:
    """Text -> uint8 pixel stream, including sync and closing rows."""
    cm = char_map()
    chunks = [np.ones(SYNC_ROWS * ROW_PIXELS, np.uint8)]
    tmpl = _glyph_pixel_templates()
    gap = np.zeros(GAP_PIXELS, np.uint8)
    for ch in text:
        if ch in cm:
            chunks.append(tmpl[ord(ch) - 32].astype(np.uint8))
            chunks.append(gap)
        else:
            # Unsupported characters transmit as blank glyph space.
            chunks.append(np.zeros(CHAR_PIXELS, np.uint8))
    chunks.append(np.ones(CLOSE_ROWS * ROW_PIXELS, np.uint8))
    return np.concatenate(chunks)


@functools.partial(jax.jit, static_argnames=("spp", "carrier", "sample_rate"))
def _synthesize(pixels: jnp.ndarray, spp: int, carrier: float, sample_rate: int) -> jnp.ndarray:
    t = np.arange(spp, dtype=np.float64) / sample_rate
    tone = jnp.asarray(np.sin(2 * np.pi * carrier * t).astype(np.float32))
    out = (pixels.astype(jnp.float32)[:, None] * tone[None, :]).reshape(-1)
    peak = jnp.max(jnp.abs(out))
    return jnp.where(peak > 0, out / peak * 0.8, out)


def hellschreiber_modulate(
    text: str, baud: float = 122.5, carrier: float = 1000.0, samp_rate: int = SAMPLE_RATE
) -> np.ndarray:
    spp = int(round(samp_rate / baud))
    pixels = text_to_pixels(text)
    return np.asarray(_synthesize(jnp.asarray(pixels), spp, float(carrier), int(samp_rate)))


@functools.partial(jax.jit, static_argnames=("spp", "threshold"))
def _pixel_energies(samples: jnp.ndarray, spp: int, threshold: float) -> jnp.ndarray:
    n_pix = samples.shape[-1] // spp
    windows = samples[: n_pix * spp].reshape(n_pix, spp)
    energy = jnp.mean(windows * windows, axis=1)
    return (energy > threshold).astype(jnp.uint8)


def detect_pixels(
    samples: np.ndarray, baud: float = 122.5, samp_rate: int = SAMPLE_RATE, threshold: float = 0.1
) -> np.ndarray:
    """Per-pixel energy detection (reference hellschreiber.py:160-165)."""
    spp = int(round(samp_rate / baud))
    return np.asarray(_pixel_energies(jnp.asarray(samples, jnp.float32), spp, float(threshold)))


def _decode_naive(pixels: np.ndarray) -> str:
    """Reference-parity decoder: per-7-pixel-row any-glyph-row lookup."""
    cm = char_map()
    text = []
    for i in range(0, len(pixels) - ROW_PIXELS + 1, ROW_PIXELS):
        val = sum(int(b) << j for j, b in enumerate(pixels[i : i + ROW_PIXELS]))
        found = "?"
        for ch, rows in cm.items():
            if val in rows:
                found = ch
                break
        text.append(found)
    return "".join(text)


def _decode_blocks(pixels: np.ndarray) -> str:
    """Glyph-block decoder: skip sync run, nearest-template-match per 7x7 block."""
    px = np.asarray(pixels, dtype=np.float32)
    # Find the end of the leading all-on sync run (>= one full-on row).
    i = 0
    n = len(px)
    while i + ROW_PIXELS <= n and px[i : i + ROW_PIXELS].sum() >= ROW_PIXELS - 0.5:
        i += ROW_PIXELS
    tmpl = _glyph_pixel_templates()  # (95, 49)
    text = []
    while i + CHAR_ROWS * ROW_PIXELS <= n:
        block = px[i : i + CHAR_ROWS * ROW_PIXELS]
        # Stop at the closing all-on rows (they match no glyph well, but an
        # all-on run right here signals end-of-message).
        if block[:ROW_PIXELS].sum() >= ROW_PIXELS - 0.5 and block.sum() >= 0.9 * len(block):
            break
        dist = np.abs(tmpl - block[None, :]).sum(axis=1)
        text.append(chr(32 + int(np.argmin(dist))))
        i += CHAR_PIXELS
    return "".join(text)


def hellschreiber_demodulate(
    samples: np.ndarray,
    baud: float = 122.5,
    carrier: float = 1000.0,
    samp_rate: int = SAMPLE_RATE,
    threshold: float = 0.1,
    naive: bool = False,
) -> str:
    pixels = detect_pixels(samples, baud, samp_rate, threshold)
    return _decode_naive(pixels) if naive else _decode_blocks(pixels)


@functools.partial(jax.jit, static_argnames=("spp", "threshold"))
def hell_demod_text_batch(
    samples: jnp.ndarray, spp: int, threshold: float = 0.1
) -> tuple:
    """(B, N) captures -> (char codes (B, max_blocks) uint8, n_chars, found).

    The batched text-mode receive path: pixel energies are one reshape +
    mean-square, glyph classification is ONE (B, n_blocks, 49) @ (49, 95)
    matmul — for binary vectors the L1 nearest-template match reduces to
    ``argmax(2 t.b - t.sum)`` (``|t-b|_1 = t.sum + b.sum - 2 t.b`` and
    ``b.sum`` is constant per block), so detection is matmul + argmax,
    exactly like the NEURAL codebook.

    Semantics match :func:`_decode_blocks` — glyph blocks start right after
    the leading all-on sync run — with a stricter, padding-safe stop rule:
    decoding ends at the first all-on 7-pixel row. No glyph can produce one
    (the font is 5-bit, so pixels 5..6 of a glyph row are always dark); only
    the sync/closing rows are full-on. This also makes the decode exact on
    bucket-padded captures, where ``_decode_blocks``'s 90%-on block test
    never fires (trailing silence dilutes the closing block) and the host
    decoder runs on into the padding.

    ``found`` gates noise captures out: a transmission always opens with
    ``SYNC_ROWS`` all-on rows (reference hellschreiber.py:118-120); require
    a leading run of at least ``SYNC_ROWS - 2`` (tolerating edge erosion).
    When ``found`` is False, ``n_chars`` is 0.

    ``samples`` is either (B, N) flat captures or (B, n_pix, spp) host
    pre-shaped pixel windows (``host_shape_batch``'s free numpy view, which
    spares the device a reshape of the flat batch). Pre-shaped
    rows may be int16 (scale 32768); energies rescale in the fused
    square-reduce, so no f32 copy materializes.
    """
    b = samples.shape[0]
    if samples.ndim == 3:
        win = samples
        n_pix = win.shape[1]
    else:
        n_pix = samples.shape[-1] // spp
        win = samples[:, : n_pix * spp].reshape(b, n_pix, spp)
    wf = win.astype(jnp.float32)
    if jnp.issubdtype(samples.dtype, jnp.integer):
        wf = wf * (1.0 / 32768.0)
    px = (jnp.mean(wf * wf, axis=-1) > threshold).astype(jnp.float32)
    n_rows = n_pix // ROW_PIXELS
    rows_on = (
        px[:, : n_rows * ROW_PIXELS].reshape(b, n_rows, ROW_PIXELS).sum(-1)
        >= ROW_PIXELS - 0.5
    )
    not_on = ~rows_on
    sync_rows = jnp.where(jnp.any(not_on, axis=1), jnp.argmax(not_on, axis=1), n_rows)
    found = sync_rows >= SYNC_ROWS - 2
    s = sync_rows * ROW_PIXELS
    blk = CHAR_ROWS * ROW_PIXELS
    max_blocks = max(n_pix // CHAR_PIXELS, 1)
    starts = s[:, None] + jnp.arange(max_blocks)[None, :] * CHAR_PIXELS  # (B, K)
    idx = starts[:, :, None] + jnp.arange(blk)[None, None, :]
    valid = (starts + blk) <= n_pix
    blocks = jnp.take_along_axis(
        px, idx.reshape(b, -1).clip(0, max(n_pix - 1, 0)), axis=1
    ).reshape(b, max_blocks, blk)
    tmpl = jnp.asarray(_glyph_pixel_templates())  # (95, 49)
    score = 2.0 * jnp.matmul(blocks, tmpl.T, precision=matmul_precision()) - tmpl.sum(axis=1)[None, None, :]
    chars = (32 + jnp.argmax(score, axis=-1)).astype(jnp.uint8)
    first_row_on = blocks[..., :ROW_PIXELS].sum(-1) >= ROW_PIXELS - 0.5
    stop = first_row_on | ~valid
    n_chars = jnp.where(jnp.any(stop, axis=1), jnp.argmax(stop, axis=1), max_blocks)
    n_chars = jnp.where(found, n_chars, 0)
    return chars, n_chars.astype(jnp.int32), found


def hellschreiber_demodulate_batch(
    batch: np.ndarray,
    baud: float = 122.5,
    samp_rate: int = SAMPLE_RATE,
    threshold: float = 0.1,
) -> List[str]:
    """(B, N) captures -> list of decoded texts (empty where no sync found)."""
    spp = int(round(samp_rate / baud))
    chars, n_chars, _found = hell_demod_text_batch(
        jnp.asarray(batch, jnp.float32), spp, float(threshold)
    )
    chars, n_chars = np.asarray(chars), np.asarray(n_chars)
    return [bytes(chars[i, : n_chars[i]]).decode("ascii") for i in range(len(n_chars))]
