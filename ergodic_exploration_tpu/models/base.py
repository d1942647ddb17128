"""L2 robot models: the model-as-pure-functions interface.

Reference capability: model functors with ``operator()(x,u) -> xdot``,
``fdx(x,u) -> A``, ``fdu(x) -> B`` (``cart.hpp`` / ``omni.hpp``; SURVEY.md
section 2 L2). The reference templates the controller on the model type at
compile time (``ErgodicControl<ModelT>``); the JAX equivalent is a
hashable frozen dataclass of pure jnp methods closed over by ``jax.jit`` —
the same zero-cost static dispatch, realized through tracing.

All methods broadcast over arbitrary leading batch axes. Jacobians are
closed-form (tested against ``jax.jacfwd`` in tests/test_models.py); autodiff
would work too, but closed forms keep the co-state scan lean.

State convention: x = (px, py, theta). Body twist convention:
v = (vx, vy, omega) in the robot frame.
"""

from __future__ import annotations

from typing import Protocol

import jax.numpy as jnp


class KinematicModel(Protocol):
    """Structural interface every model implements (hashable + pure)."""

    nu: int

    def f(self, x, u):  # (..., 3), (..., nu) -> (..., 3)
        """Continuous-time kinematics xdot = f(x, u)."""

    def A(self, x, u):  # -> (..., 3, 3)
        """State Jacobian df/dx (reference: ``fdx``)."""

    def B(self, x, u):  # -> (..., 3, nu)
        """Control Jacobian df/du (reference: ``fdu``)."""

    def twist(self, u):  # (..., nu) -> (..., 3)
        """Control -> body twist (vx, vy, omega)."""

    def from_twist(self, v):  # (..., 3) -> (..., nu)
        """Body twist -> control (least-squares inverse of ``twist``)."""


def make_model(config) -> "KinematicModel":
    """Instantiate the configured model from an :class:`EngineConfig`."""
    from ergodic_exploration_tpu.models.cart import Cart
    from ergodic_exploration_tpu.models.omni import Omni

    if config.model == "cart":
        return Cart(config.cart.wheel_radius, config.cart.wheel_base)
    if config.model == "omni":
        return Omni(config.omni.wheel_radius, config.omni.lx, config.omni.ly)
    raise ValueError(f"unknown model {config.model!r}")


def rotate_body_to_world(theta, vx, vy):
    """Rotate a body-frame planar velocity into the world frame."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return vx * c - vy * s, vx * s + vy * c
