"""Spectral-gate noise reduction for received captures.

The reference declares ``modem.noise_reduction: True`` in its config but no
code reads it (SURVEY.md §5 dead flags). Here the flag does something real —
as an OPT-IN preprocessing stage (``decode... denoise=True`` or the CLI's
``--denoise``): a classic spectral gate estimates the per-bin noise floor
from the quietest spectrogram frames and attenuates bins near that floor.

Kept off by default deliberately: the demodulators are matched-filter-
optimal under AWGN, where any spectral shaping can only lose information;
gating helps when the interference is STRUCTURED (hum, carriers, hiss with
a colored floor) — the operator knows when that is.

Array-shaped: one framed FFT (batch of short FFTs), elementwise gain mask,
overlap-add — all jit, static shapes per bucket.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_FRAME = 2048
_HOP = _FRAME // 2


@functools.partial(jax.jit, static_argnames=("reduction_db",))
def _gate(x: jnp.ndarray, reduction_db: float = 12.0) -> jnp.ndarray:
    """Frequency-selective gate over a 1-D capture (length multiple of _HOP).

    Per-BIN gating, deliberately not per-frame: a modem transmission is a
    continuous narrowband signal, so quiet-frame floor estimates would call
    the signal itself "noise" and gut it. Instead the per-bin median over
    time is compared against the wideband floor (the median across bins —
    most bins carry only noise for a narrowband signal): persistent signal
    bands pass at unity, broadband hiss is attenuated by ``reduction_db``.
    """
    n = x.shape[0]
    n_frames = n // _HOP - 1
    idx = jnp.arange(_FRAME)[None, :] + (jnp.arange(n_frames) * _HOP)[:, None]
    # sqrt-Hann analysis AND synthesis: their product is Hann, which at 50%
    # hop satisfies COLA with constant EXACTLY 1.0 — unity-gain bands come
    # back sample-exact (hann^2 at this hop does NOT: its OLA sum ripples
    # 0.5-1.0, imposing periodic AM on the signal).
    win = jnp.sqrt(jnp.hanning(_FRAME))
    frames = x[idx] * win
    spec = jnp.fft.rfft(frames, axis=-1)
    mag = jnp.abs(spec)

    bin_med = jnp.median(mag, axis=0)  # persistent level per frequency bin
    floor = jnp.median(bin_med) + 1e-12  # wideband noise floor estimate
    gain_min = 10.0 ** (-reduction_db / 20.0)
    # Unity for bins well above the floor, attenuated at/below it.
    gain = jnp.clip(bin_med / (3.0 * floor) - 1.0, 0.0, 1.0) * (1.0 - gain_min) + gain_min
    out_frames = jnp.fft.irfft(spec * gain[None, :], _FRAME, axis=-1) * win

    out = jnp.zeros(n, x.dtype)
    out = out.at[idx.reshape(-1)].add(out_frames.reshape(-1))
    return out


def spectral_gate(samples: np.ndarray, reduction_db: float = 12.0) -> np.ndarray:
    """Denoise a capture; returns float32 of the same length."""
    x = np.asarray(samples, np.float32)
    n = len(x)
    if n < 4 * _FRAME:
        return x
    pad = (-n) % _HOP + _FRAME
    xp = np.pad(x, (0, pad))
    out = np.asarray(_gate(jnp.asarray(xp), float(reduction_db)))
    return out[:n].astype(np.float32)
