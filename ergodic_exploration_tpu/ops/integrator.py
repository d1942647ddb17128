"""RK4 integration: forward trajectory rollout and backward co-state pass.

Reference capability: ``RungeKutta`` (``integrator.hpp``): single ``step``,
full-horizon ``solve`` producing a (3 x N) trajectory, and the backward
co-state ``step``/``solve`` taking the rho-dot closure (SURVEY.md sections 2
L2 and 4.2).

Design: both passes are ``lax.scan`` bodies with tiny carries
(one state / one co-state vector), so XLA keeps the sequential loop entirely
on-chip and the batch dimension (thousands of scenarios, via vmap/shard_map
outside) provides the parallelism — per SURVEY.md section 8's "hard parts",
throughput comes from the scenario batch, not from inside a solve.

Discretization contract (shared with the NumPy oracle in tests/oracle.py):
- rollout: X = [x_0 .. x_H], x_{t+1} = RK4(f, x_t, u_t, dt), heading wrapped
  to (-pi, pi] after each step.
- co-state: rho_H = 0; for t = H-1 .. 0, rho_t integrates
  rho_dot = -g_t - A_t^T rho backward over one step of length dt with A_t,
  g_t held constant on the step (the reference evaluates its closures at the
  stored trajectory knots, i.e. the same piecewise-constant treatment).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ergodic_exploration_tpu.utils.numerics import normalize_angle, wrap_state_angle


def rk4_step(f, x, u, dt):
    """One classical RK4 step of xdot = f(x, u) with u held constant."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rollout(model, x0, U, dt, unroll: int = 4):
    """Forward-simulate a control sequence.

    Args:
        model: a KinematicModel.
        x0: (3,) initial state.
        U: (H, nu) control sequence.
        dt: step size.
        unroll: scan unroll factor — the per-step bodies are a handful of
            tiny (batch, 3) ops, so some unrolling lets XLA fuse across
            steps instead of paying per-iteration dispatch (H is short).

    Returns:
        X: (H+1, 3) states [x_0 .. x_H] with wrapped headings.
    """

    def body(x, u):
        x_next = wrap_state_angle(rk4_step(model.f, x, u, dt))
        return x_next, x_next

    _, xs = jax.lax.scan(body, x0, U, unroll=unroll)
    return jnp.concatenate([x0[None, :], xs], axis=0)


def costate_rk4_step(rho, A, g, dt):
    """Integrate rho_dot = -g - A^T rho backward over one step of length dt.

    Backward integration of the forward-time ODE: with s = T - t,
    d(rho)/ds = +g + A^T rho; RK4 on that frozen-coefficient linear ODE.
    """

    def fdot(r):
        return g + A.T @ r

    k1 = fdot(rho)
    k2 = fdot(rho + 0.5 * dt * k1)
    k3 = fdot(rho + 0.5 * dt * k2)
    k4 = fdot(rho + dt * k3)
    return rho + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def costate_solve(As, gs, dt, unroll: int = 4):
    """Backward co-state sweep over a horizon.

    Args:
        As: (H, 3, 3) state Jacobians at the trajectory knots.
        gs: (H, 3) running-cost gradients (gamma * ergodic + barrier) at knots.
        dt: step size.
        unroll: scan unroll factor (see :func:`rollout`).

    Returns:
        rhos: (H, 3) co-states [rho_0 .. rho_{H-1}] with rho_H = 0 implicit.
    """

    def body(rho, inputs):
        A, g = inputs
        rho_prev = costate_rk4_step(rho, A, g, dt)
        return rho_prev, rho_prev

    rho_T = jnp.zeros(As.shape[-1], dtype=As.dtype)
    # reverse=True consumes t = H-1 .. 0 but stacks outputs at their input
    # positions, so `rhos` is already [rho_0 .. rho_{H-1}].
    _, rhos = jax.lax.scan(body, rho_T, (As, gs), reverse=True, unroll=unroll)
    return rhos


def constant_twist_poses(x0, tw, ts):
    """Exact poses under a constant BODY twist — the closed-form arc.

    For a constant body twist (vx, vy, w), the pose ODE
    pdot = R(theta) (vx, vy), thetadot = w integrates in closed form:

        theta(t) = theta0 + w t
        p(t)     = p0 + R(theta0) [ vx a(t) - vy b(t), vx b(t) + vy a(t) ]
        a(t) = sin(w t)/w,  b(t) = (1 - cos(w t))/w     (limits t, w t^2/2)

    Used for the DWA candidate rollouts and the emitted-control validation
    loop, where the reference holds the control constant anyway — this
    replaces H sequential RK4 scan steps with one vectorized evaluation
    (exact, and sequential scans are the costly shape on an accelerator:
    tiny per-step compute, serial dependency).

    Args:
        x0: (..., 3) start pose.
        tw: (..., 3) body twist (vx, vy, omega).
        ts: (T,) times at which to evaluate (e.g. dt * [1..T]).

    Returns:
        (..., T, 3) poses.
    """
    vx, vy, w = tw[..., 0:1], tw[..., 1:2], tw[..., 2:3]  # (..., 1)
    th0 = x0[..., 2:3]
    wt = w * ts  # (..., T)
    s, c = jnp.sin(wt), jnp.cos(wt)
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    a = jnp.where(small, ts * (1.0 - wt * wt / 6.0), s / w_safe)
    b = jnp.where(small, w * ts * ts * 0.5, (1.0 - c) / w_safe)
    dx_b = vx * a - vy * b
    dy_b = vx * b + vy * a
    c0, s0 = jnp.cos(th0), jnp.sin(th0)
    px = x0[..., 0:1] + c0 * dx_b - s0 * dy_b
    py = x0[..., 1:2] + s0 * dx_b + c0 * dy_b
    th = normalize_angle(th0 + wt)
    return jnp.stack([px, py, th], axis=-1)
