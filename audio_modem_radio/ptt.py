"""PTT (push-to-talk) radio keying over a serial line.

Capability parity with the reference PTT layer (/root/reference/ptt.py):
enumerate serial ports, key the transmitter by raising RTS or DTR at 9600
baud with a 0.2 s pre-TX delay, drop both lines and close on un-key, and a
context manager guaranteeing key-down even on exceptions (the reference
duplicates it verbatim in the GUI, filebeep_advanced_v2.py:1464-1486).

pyserial is an optional dependency: without it (or with ``port=None`` /
``"Nenhuma"``/``"None"``) every operation is a safe no-op, and a ``SimulatedPort``
backend records key events for tests and dry runs.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

logger = logging.getLogger("audio_modem_radio")

try:
    import serial
    import serial.tools.list_ports

    SERIAL_AVAILABLE = True
except ImportError:  # pragma: no cover
    serial = None
    SERIAL_AVAILABLE = False

# Port names treated as "no PTT configured" ("Nenhuma" is the reference GUI's
# placeholder entry).
_NULL_PORTS = (None, "", "Nenhuma", "None", "none")

PRE_TX_DELAY_S = 0.2


class SimulatedPort:
    """In-memory serial stand-in; records (timestamp, rts, dtr) transitions."""

    def __init__(self, name: str = "SIM"):
        self.name = name
        self.is_open = True
        self.rts = False
        self.dtr = False
        self.events: List[tuple] = []

    def __setattr__(self, key, value):
        super().__setattr__(key, value)
        if key in ("rts", "dtr") and hasattr(self, "events"):
            self.events.append((time.time(), self.rts, self.dtr))

    def close(self):
        self.is_open = False


class PTTManager:
    """Keys a transmitter via serial RTS/DTR control lines."""

    def __init__(self, pre_tx_delay: float = PRE_TX_DELAY_S):
        self.ser = None
        self.port: Optional[str] = None
        self.method = "RTS"  # or 'DTR'
        self.pre_tx_delay = pre_tx_delay
        self.is_keyed = False

    @staticmethod
    def get_available_ports() -> List[str]:
        if not SERIAL_AVAILABLE:
            return []
        return [p.device for p in serial.tools.list_ports.comports()]

    def connect(self, port_name: Optional[str], method: str = "RTS") -> None:
        self.port = port_name
        self.method = method

    def _open(self):
        if self.port == "SIM":
            return SimulatedPort()
        if not SERIAL_AVAILABLE:
            raise RuntimeError("pyserial not available")
        return serial.Serial(self.port, 9600, timeout=1)

    def ptt_on(self) -> None:
        """Key up: raise the configured control line, wait the pre-TX delay."""
        if self.port in _NULL_PORTS:
            return
        try:
            if self.ser is None or not self.ser.is_open:
                self.ser = self._open()
            if self.method == "RTS":
                self.ser.rts = True
                self.ser.dtr = False
            else:
                self.ser.dtr = True
                self.ser.rts = False
            self.is_keyed = True
            logger.info("PTT ON (%s via %s)", self.port, self.method)
            time.sleep(self.pre_tx_delay)
        except Exception:
            logger.exception("failed to key PTT on %s", self.port)

    def ptt_off(self) -> None:
        """Un-key: drop both lines and close the port."""
        if self.ser and self.ser.is_open:
            try:
                self.ser.rts = False
                self.ser.dtr = False
                self.ser.close()
            except Exception:
                logger.exception("failed to un-key PTT")
            finally:
                self.ser = None
                self.is_keyed = False
                logger.info("PTT OFF")


class PTTContext:
    """Guarantee key-up before and key-down after a transmission block."""

    def __init__(self, port: Optional[str] = None, method: str = "RTS", controller=None):
        self.port = port
        self.method = method
        self.controller = controller or ptt_controller

    def __enter__(self):
        if self.port not in _NULL_PORTS:
            self.controller.connect(self.port, self.method)
            self.controller.ptt_on()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self.port not in _NULL_PORTS:
            self.controller.ptt_off()
        return False  # propagate exceptions


ptt_controller = PTTManager()
