"""Dynamic Window Approach safety fallback, fully batched.

Reference capability: ``DynamicWindow::control(collision, grid, x, vb,
u_ref)`` (``dynamic_window.hpp``): sample (vx, vy, omega) candidates inside
the acceleration window around the current body twist, roll each out, reject
colliding candidates, and return the closest collision-free control to the
ergodic one (SURVEY.md sections 2 L4, 3, and A.6; Fox et al. 1997).

Design: the candidate grid is one big vmap — every (vx, vy, omega) cell
is rolled out in parallel, feasibility is a mask, and the argmin is a
masked reduction. No branches; the whole fallback fuses into the batched
controller step (SURVEY.md section 8 "branchy safety logic").

Candidates live in body-twist space exactly as in A.6; conversion to/from
wheel controls goes through the model's ``twist``/``from_twist`` maps, so
one implementation serves cart (n_vy = 1) and omni.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ergodic_exploration_tpu.ops.collision import CRASH, check_trajectory

INFEASIBLE_COST = 1.0e9


def _axis_samples(center, acc, dt, vmax, n: int):
    """n samples spanning the accel window [center - acc dt, center + acc dt],
    clipped to [-vmax, vmax]. n == 1 collapses to {0} (non-holonomic axes)."""
    if n == 1:
        return jnp.zeros((1,), dtype=jnp.float32)
    lo = jnp.clip(center - acc * dt, -vmax, vmax)
    hi = jnp.clip(center + acc * dt, -vmax, vmax)
    frac = jnp.arange(n, dtype=jnp.float32) / (n - 1)
    return lo + (hi - lo) * frac


def candidate_twists(vb, dwa_cfg):
    """All (n_vx * n_vy * n_omega, 3) candidate body twists around ``vb``."""
    nvx, nvy, nw = dwa_cfg.samples
    ax, ay, aw = dwa_cfg.acc_lim
    mx, my, mw = dwa_cfg.vel_lim
    vxs = _axis_samples(vb[0], ax, dwa_cfg.dt, mx, nvx)
    vys = _axis_samples(vb[1], ay, dwa_cfg.dt, my, nvy)
    ws = _axis_samples(vb[2], aw, dwa_cfg.dt, mw, nw)
    g = jnp.stack(jnp.meshgrid(vxs, vys, ws, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def dwa_control(model, x, vb, u_ref, domain, dist_field, cfg):
    """Best collision-free control near ``u_ref``.

    Args:
        model: KinematicModel.
        x: (3,) current state.
        vb: (3,) current body twist (the accel window center).
        u_ref: (nu,) the ergodic control being replaced.
        domain, dist_field: world data for collision checks.
        cfg: EngineConfig (uses cfg.dwa, boundary_radius, d_safe).

    Returns:
        (u (nu,), feasible (bool)). Infeasible -> zero control (stop), per
        A.6's "stop command if none feasible".
    """
    from ergodic_exploration_tpu.ops.integrator import constant_twist_poses

    dwa = cfg.dwa
    tws = candidate_twists(vb, dwa)  # (C, 3)
    us = model.from_twist(tws)  # (C, nu)
    # For non-holonomic models from_twist drops vy; re-derive the realized
    # twist so the cost compares what would actually be executed.
    tws_real = model.twist(us)

    # Constant-twist candidates integrate in closed form: all C x T poses in
    # one vectorized op (no per-candidate RK4 scan), then one clearance
    # gather per pose. This was the batched-throughput bottleneck.
    ts = dwa.dt * jnp.arange(1, dwa.horizon + 1, dtype=jnp.float32)
    X = constant_twist_poses(x[None, :], tws_real, ts)  # (C, T, 3)
    codes = jax.vmap(
        lambda P: check_trajectory(P, domain, dist_field, cfg.boundary_radius, cfg.d_safe)
    )(X[..., :2])  # (C,)
    if cfg.dwa.cost_space == "control":
        # reference cost (SURVEY.md A.6): ||u_cand - u_ergodic||^2 in
        # wheel-velocity space
        cost = jnp.sum((us - u_ref[None, :]) ** 2, axis=-1)
    else:  # "twist": distance between realized body twists
        tw_ref = model.twist(u_ref)
        cost = jnp.sum((tws_real - tw_ref[None, :]) ** 2, axis=-1)
    cost = jnp.where(codes >= CRASH, INFEASIBLE_COST, cost)
    best = jnp.argmin(cost)
    feasible = cost[best] < INFEASIBLE_COST
    u_best = jnp.where(feasible, us[best], jnp.zeros_like(u_ref))
    return u_best, feasible
