"""Random sources (uniform / normal / bits) as counter-based blocks.

Functional parity with ``/root/reference/src/util/rand_node.rs``:
``UniformNode`` (rand_node.rs:25-75), ``NormalNode`` (:97-139) and
``random_bit()`` = Uniform(0, 2) over u8 (:150-152), which produce one
entropy-seeded sample per call.

Design: sources generate whole blocks with ``jax.random``
(threefry counter-based PRNG).  The carried state is the PRNG key —
split once per block — so streams are reproducible, checkpointable,
and identical under any block chopping of the key sequence, unlike
the reference's ``StdRng::from_entropy()`` which is unseedable.
Distribution parity is statistical, not bitwise (different PRNG by
design; the reference's tests are statistical too, rand_node.rs:163+).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "source_init",
    "uniform_block",
    "normal_block",
    "random_bits_block",
    "random_bits_packed_block",
]


def source_init(seed: int):
    """Carried PRNG key."""
    return jax.random.PRNGKey(seed)


def uniform_block(key, n: int, start=0.0, end=1.0, dtype=jnp.float32):
    """Uniform [start, end) block.  Returns ``(samples, new_key)``."""
    new_key, sub = jax.random.split(key)
    x = jax.random.uniform(sub, (int(n),), dtype=dtype,
                           minval=start, maxval=end)
    return x, new_key


def normal_block(key, n: int, mu=0.0, std_dev=1.0, dtype=jnp.float32):
    """Normal(mu, std_dev) block.  Returns ``(samples, new_key)``."""
    new_key, sub = jax.random.split(key)
    x = mu + std_dev * jax.random.normal(sub, (int(n),), dtype=dtype)
    return x, new_key


def random_bits_block(key, n: int, dtype=jnp.int8):
    """Uniform bits in {0, 1} (the reference's ``random_bit()``)."""
    new_key, sub = jax.random.split(key)
    bits = jax.random.randint(sub, (int(n),), 0, 2, dtype=jnp.int32)
    return bits.astype(dtype), new_key


def random_bits_packed_block(key, n: int, dtype=jnp.float32):
    """Uniform bits in {0, 1}, 32 per threefry word (LSB-first).

    32x less PRNG work than :func:`random_bits_block` (which burns a
    full u32 of entropy per bit) — the hot-path source for the fused
    tx chains.  Same distribution, different stream for a given key.
    ``n`` must be a multiple of 32.  Returns ``(bits, new_key)``.
    """
    n = int(n)
    if n % 32:
        raise ValueError(f"bit count {n} must be a multiple of 32")
    new_key, sub = jax.random.split(key)
    words = jax.random.bits(sub, (n // 32,), jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :]
    bits = (words[:, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(-1).astype(dtype), new_key
