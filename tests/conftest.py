"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU; multi-device sharding is validated on
``xla_force_host_platform_device_count=8`` CPU devices. Must run before jax
imports anywhere, hence the env mutation at module import time.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True)
def _hermetic_assembly_journal(tmp_path_factory, monkeypatch):
    """Point the multi-part assembly journal at a per-test temp dir so tests
    never replay another test's (or another run's) in-flight parts. Journal
    tests that want a specific dir pass journal_dir= explicitly."""
    from audio_modem_radio.config import CONFIG

    d = tmp_path_factory.mktemp("assembly_journal")
    old = CONFIG.get("modem.assembly_journal")
    CONFIG.set("modem.assembly_journal", str(d))
    yield
    CONFIG.set("modem.assembly_journal", old)
