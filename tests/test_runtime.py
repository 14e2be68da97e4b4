"""The JAX set-up module shared by the entry points: compile-cache placement
and the device checks that keep CPU timings from passing as GPU numbers."""

import os
import subprocess
import sys

import jax
import pytest

from audio_modem_radio.utils import runtime


@pytest.fixture
def cache_setting():
    """Restore JAX's compile-cache directory after the test."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_defaults_to_fixed_checkout_path(monkeypatch, cache_setting):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path = runtime.configure_compile_cache()
    assert path == runtime.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == runtime.DEFAULT_CACHE_DIR
    root = os.path.dirname(os.path.dirname(os.path.abspath(runtime.__file__)))
    assert path == os.path.join(os.path.dirname(root), ".jax_cache")


def test_cache_env_wins_without_code_override(monkeypatch, cache_setting, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env itself


def test_cache_path_is_ignored_by_git():
    root = os.path.dirname(runtime.DEFAULT_CACHE_DIR)
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_device_summary_reports_the_backend():
    dev = runtime.device_summary()
    assert dev == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_card_query_fails_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi on this PATH
    with pytest.raises((OSError, subprocess.SubprocessError)):
        runtime.card_name_and_power_limit()


def test_jax_platforms_env_is_honoured_by_jax():
    """JAX_PLATFORMS=cpu alone selects the CPU in a fresh process."""
    code = (
        "import jax, sys;"
        "sys.stdout.write(jax.devices()[0].platform)"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "cpu"


def test_main_path_imports_no_optional_packages():
    """encode/decode, the batch farm and the CLI import nothing beyond jax,
    numpy, scipy, the standard library and soft-optional extras: flax and
    optax stay off the main path."""
    code = (
        "import sys\n"
        "import audio_modem_radio.cli, audio_modem_radio.encoder, audio_modem_radio.decoder\n"
        "import audio_modem_radio.parallel.batch, audio_modem_radio.parallel.sequence\n"
        "from audio_modem_radio.ops import neural\n"
        "neural._codebook()\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'flax', 'optax', 'torch'})\n"
        "sys.stdout.write(','.join(bad))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=300, check=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.stdout.strip() == ""
