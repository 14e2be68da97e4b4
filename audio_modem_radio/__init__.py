"""audio_modem_radio — acoustic file-transfer framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
szumanski/Audio-Modem-Radio ("FileBeep Advanced v2"): compress + frame file
bytes (FBPC wire format), modulate into 96 kHz audio (CPFSK, DBPSK, DQPSK,
Hellschreiber and the reference's aliased modes), and demodulate recorded
captures back to bit-exact files with multi-part reassembly — with the dense
DSP hot path running on the accelerator and batch decode sharded across a
device mesh.
"""

from .config import CONFIG, ConfigManager, get_quality_threshold, set_quality_threshold
from .framing import Frame, pack_frame, parse_frames
from .modem import MODES, SAMPLE_RATE, demodulate, modulate, wav_from_array

__version__ = "0.1.0"

__all__ = [
    "CONFIG",
    "ConfigManager",
    "get_quality_threshold",
    "set_quality_threshold",
    "Frame",
    "pack_frame",
    "parse_frames",
    "MODES",
    "SAMPLE_RATE",
    "modulate",
    "demodulate",
    "wav_from_array",
    "__version__",
]
