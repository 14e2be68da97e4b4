"""Train the production NEURAL-mode constellation and export its codebook.

The deployable artifact of the learned modem is not the flax network — it is
the *codebook*: the encoder evaluated once over the whole symbol alphabet
(2^bits codewords of 2*samples_per_symbol reals, each normalized to unit
average power by the encoder head). At inference, modulation is a gather and
demodulation is one matmul + argmax against this table (maximum-likelihood
nearest-codeword under AWGN, since all codewords have equal norm) — exactly
the matmul-shaped program ops/neural.py runs.

Usage::

    python -m audio_modem_radio.models.train_neural [--steps 3000]
        [--bits 8] [--noise 0.35] [--out <pkg>/models/data/neural_codebook.npz]

The committed artifact ships with the package so NEURAL decodes are
deterministic across backends and sessions (no train-at-import).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


DEFAULT_CODEBOOK = os.path.join(os.path.dirname(__file__), "data", "neural_codebook.npz")


def train_and_export(
    out_path: str = DEFAULT_CODEBOOK,
    bits_per_symbol: int = 8,
    hidden: int = 256,
    samples_per_symbol: int = 8,
    n_steps: int = 3000,
    batch_size: int = 1024,
    noise_std: float = 0.35,
    seed: int = 0,
) -> dict:
    """Train the autoencoder modem, evaluate + export the codebook."""
    import jax
    import jax.numpy as jnp

    from .neural_modem import LearnedModem, create_train_state, make_train_step

    rng = jax.random.PRNGKey(seed)
    model, params, tx, opt_state = create_train_state(
        rng, bits_per_symbol=bits_per_symbol, hidden=hidden,
        samples_per_symbol=samples_per_symbol,
    )
    step = jax.jit(make_train_step(model, tx))
    n_sym = 1 << bits_per_symbol
    loss = acc = None
    for i in range(n_steps):
        rng, k1, k2 = jax.random.split(rng, 3)
        symbols = jax.random.randint(k1, (batch_size,), 0, n_sym)
        params, opt_state, loss, acc = step(params, opt_state, symbols, noise_std, k2)
        if i % 500 == 0:
            print(f"step {i}: loss={float(loss):.4f} acc={float(acc):.4f}", flush=True)

    codebook = np.asarray(
        model.apply(params, jnp.arange(n_sym), method=LearnedModem.modulate_symbols),
        np.float32,
    )
    # Sanity: unit average power per codeword (encoder head guarantees it).
    powers = np.mean(codebook**2, axis=-1)
    assert np.allclose(powers, 1.0, atol=1e-3), "codewords not power-normalized"

    # Nearest-codeword symbol error rate at the training noise level.
    rng_np = np.random.default_rng(seed + 1)
    tx_syms = rng_np.integers(0, n_sym, 4096)
    rx = codebook[tx_syms] + rng_np.normal(0, noise_std, (4096, codebook.shape[1]))
    decided = np.argmax(rx @ codebook.T, axis=-1)
    ser = float(np.mean(decided != tx_syms))

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(
        out_path,
        codebook=codebook,
        bits_per_symbol=bits_per_symbol,
        samples_per_symbol=samples_per_symbol,
        train_noise_std=noise_std,
        train_steps=n_steps,
        train_final_loss=float(loss),
        train_final_acc=float(acc),
        nearest_codeword_ser=ser,
    )
    print(
        f"exported {out_path}: {n_sym} codewords x {codebook.shape[1]} dims, "
        f"train acc={float(acc):.4f}, nearest-codeword SER@sigma={noise_std}: {ser:.4f}"
    )
    return {"codebook": codebook, "ser": ser, "acc": float(acc)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--sps", type=int, default=8)
    ap.add_argument("--noise", type=float, default=0.35)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_CODEBOOK)
    args = ap.parse_args()
    train_and_export(
        args.out, args.bits, args.hidden, args.sps, args.steps, args.batch,
        args.noise, args.seed,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
