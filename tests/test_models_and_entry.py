"""Neural modem (toy + trainable) and driver entry-point tests."""

import numpy as np
import pytest

import jax

from audio_modem_radio.models import neural_modem as nm


def test_toy_neural_api_shapes():
    data = b"neural modem bytes " * 10
    wave = nm.neural_modulate(data)
    assert wave.dtype == np.float32
    assert len(wave) == 1024  # fixed seq_len design, like the reference
    assert np.max(np.abs(wave)) <= 0.81
    out = nm.neural_demodulate(wave)
    assert isinstance(out, bytes)
    assert nm.neural_demodulate(np.zeros(0, np.float32)) == b""


def test_toy_iq_roundtrip_shapes():
    iq = nm.bytes_to_iq(b"abc", seq_len=64)
    assert iq.shape == (64,) and iq.dtype == np.complex128
    assert len(nm.iq_to_bytes(iq)) == 64


@pytest.mark.skipif(not nm.FLAX_AVAILABLE, reason="flax not installed")
def test_learned_modem_trains_to_high_accuracy():
    result = nm.train_learned_modem(
        n_steps=150, batch_size=256, noise_std=0.1, bits_per_symbol=4, hidden=64
    )
    # 16-symbol alphabet at mild noise: a trained autoencoder modem must be
    # nearly perfect; untrained accuracy would be ~1/16.
    assert result["final_accuracy"] > 0.95
    assert np.isfinite(result["final_loss"])


@pytest.mark.skipif(not nm.FLAX_AVAILABLE, reason="flax not installed")
def test_learned_modem_modulate_demodulate_consistency():
    import jax.numpy as jnp

    result = nm.train_learned_modem(n_steps=200, batch_size=256, noise_std=0.1,
                                    bits_per_symbol=4, hidden=64)
    model, params = result["model"], result["params"]
    symbols = jnp.arange(16)
    tx = model.apply(params, symbols, method=model.modulate_symbols)
    assert tx.shape == (16, 16)  # 2 * samples_per_symbol
    power = jnp.mean(tx**2, axis=-1)
    np.testing.assert_allclose(np.asarray(power), 1.0, rtol=1e-3)
    decoded = model.apply(params, tx, method=model.demodulate_iq)
    assert float((decoded == symbols).mean()) > 0.95


def test_graft_entry_single_chip():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    packed, n_valid, found = out
    assert packed.shape[0] == args[0].shape[0]


def test_graft_entry_multichip_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)  # virtual CPU mesh from conftest


def test_graft_entry_multichip_odd_count():
    import __graft_entry__ as g

    g.dryrun_multichip(5)  # non-power-of-two device count must work too


def test_dryrun_multichip_self_provisions_via_subprocess():
    """The round-1 MULTICHIP failure mode: a process with too few devices
    must re-exec into a virtual CPU mesh and run the full dryrun (the test
    process has 8 devices, so asking for 12 forces the re-exec leg)."""
    import __graft_entry__ as g

    g.dryrun_multichip(12)
