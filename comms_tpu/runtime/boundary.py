"""Host<->device boundary codecs.

The framework speaks **float32 re/im pairs** ([..., 2]) at every jit
boundary and converts at the edges inside the compiled program — a
zero-cost view for XLA, and exactly the interleaved layout of the
reference's IQ files (raw_iq.rs:1-5), so file blocks map to device
blocks with no repacking.  Complex values live only inside compiled
programs; the public API never takes or returns them.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "pairs_to_complex",
    "complex_to_pairs",
    "host_complex_to_pairs",
    "host_pairs_to_complex",
    "encode_state",
    "decode_state",
]


def pairs_to_complex(p):
    """[..., 2] float -> [...] complex (inside jit)."""
    p = jnp.asarray(p)
    return jax.lax.complex(p[..., 0], p[..., 1])


def complex_to_pairs(z):
    """[...] complex -> [..., 2] float (inside jit)."""
    z = jnp.asarray(z)
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)


def host_complex_to_pairs(x: np.ndarray) -> np.ndarray:
    """Host-side complex -> float32 pairs (a view when contiguous)."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(*x.shape, 2)


def host_pairs_to_complex(p: np.ndarray) -> np.ndarray:
    """Host-side float32 pairs -> complex64 (a view when contiguous)."""
    p = np.ascontiguousarray(p, dtype=np.float32)
    return p.view(np.complex64).reshape(p.shape[:-1])


def encode_state(state):
    """Map every complex leaf of a state pytree to float pairs, for
    crossing the boundary (checkpointing / step-wise streaming)."""
    return jax.tree_util.tree_map(
        lambda l: complex_to_pairs(l)
        if jnp.issubdtype(jnp.asarray(l).dtype, jnp.complexfloating) else l,
        state,
    )


def decode_state(encoded, like):
    """Inverse of :func:`encode_state`, given the original structure
    ``like`` (whose leaves carry the target dtypes)."""
    return jax.tree_util.tree_map(
        lambda e, l: pairs_to_complex(e)
        if jnp.issubdtype(jnp.asarray(l).dtype, jnp.complexfloating) else e,
        encoded, like,
    )
