"""L0 numerics helpers (reference: ``numerics.hpp``, SURVEY.md section 2 L0).

Pure functions usable inside jit/scan/vmap. The reference leans on Armadillo
for linear algebra; here everything is jnp and shapes are static.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = float(jnp.pi)


def normalize_angle(theta):
    """Wrap an angle (or array of angles) to (-pi, pi].

    Reference capability: angle normalization in ``numerics.hpp``
    (SURVEY.md section 2 L0). Implemented branch-free.
    """
    return jnp.pi - jnp.mod(jnp.pi - theta, 2.0 * jnp.pi)


def wrap_state_angle(x):
    """Wrap the heading component (index 2) of a state (..., 3) array."""
    return x.at[..., 2].set(normalize_angle(x[..., 2]))
