"""The receding-horizon ergodic controller — one jitted solve per tick.

Reference capability: ``ErgodicControl<ModelT>::control(grid, x) -> u``
(``ergodic_control.hpp``): per tick, refresh target coefficients, RK4-roll
the warm-started control sequence, compute trajectory coefficients over
[history || rollout], the ergodic-measure gradient, barrier gradients,
integrate the co-state backward, update u = sat(-R^-1 B^T rho), validate the
emitted control, and fall back to DWA on collision (SURVEY.md sections 2 L3,
4.2 — the hot path — and Appendix A; one descent step per replan, warm
started, receding-horizon SAC style).

Design:
- The controller is a hashable dataclass of pure functions; ``step`` is one
  fused computation (rollout scan -> basis matmuls -> backward scan ->
  saturation -> masked safety select) that jits once and vmaps over
  thousands of scenarios (the engine adds vmap/shard_map).
- The branchy reference logic (collision enum, DWA fallback) is computed
  unconditionally and selected with ``jnp.where`` — batch-uniform control
  flow (SURVEY.md section 8).
- History enters c_k either as a reference-parity ring buffer or as an O(K^2)
  running basis-sum ("accumulate" mode, the fast path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ergodic_exploration_tpu.config import EngineConfig
from ergodic_exploration_tpu.grid import Domain
from ergodic_exploration_tpu.models import make_model
from ergodic_exploration_tpu.ops import basis
from ergodic_exploration_tpu.ops.barrier import barrier
from ergodic_exploration_tpu.ops.buffer import RingBuffer
from ergodic_exploration_tpu.ops.collision import CRASH, validate_control
from ergodic_exploration_tpu.ops.distance import DistanceField
from ergodic_exploration_tpu.ops.dwa import dwa_control
from ergodic_exploration_tpu.ops.patch import extract_patch
from ergodic_exploration_tpu.ops.integrator import costate_solve, rollout


class World(NamedTuple):
    """Per-scenario world data, refreshed per replan (batch with vmap)."""

    domain: Domain
    dist: DistanceField
    # Optional (N,) free-space weights at the engine's phi sample lattice
    # (1 = free/unknown, 0 = occupied). Used by the target refresh so phi is
    # normalized over FREE space (reference ``target.hpp`` semantics,
    # SURVEY.md A.3); the controller itself never reads it. None = no mask.
    free_mask: Optional[jnp.ndarray] = None

    @staticmethod
    def empty(domain: Domain, shape=(2, 2)) -> "World":
        """Obstacle-free world over ``domain`` (configs 1 and 2)."""
        return World(domain=domain, dist=DistanceField.empty(shape, origin=domain.origin))


class ControllerState(NamedTuple):
    """Warm-started solver state for one scenario — a tiny pytree, so it is
    cheap to donate, checkpoint, and re-shard (SURVEY.md section 6)."""

    U: jnp.ndarray  # (H, nu) control sequence
    buffer: RingBuffer  # visited-state history (ring mode)
    ck_sum: jnp.ndarray  # (K, K) running sum of F_k over visited states (accumulate mode)
    hist_count: jnp.ndarray  # () int32
    rng: jnp.ndarray  # PRNG key (buffer subsampling)


class StepDiagnostics(NamedTuple):
    ergodic_metric: jnp.ndarray  # ()
    barrier_cost: jnp.ndarray  # () mean barrier value along the horizon
    collision_code: jnp.ndarray  # () int32 validation result for u0
    dwa_active: jnp.ndarray  # () bool: emitted control came from DWA
    dwa_feasible: jnp.ndarray  # () bool
    diverged: jnp.ndarray  # () bool: non-finite solve; scenario was reset
    orbit_reset: jnp.ndarray  # () bool: orbit guard reset the warm start


def orbit_guard(cfg: EngineConfig, buffer: RingBuffer, p_now):
    """True when this scenario is trapped in a closed orbit (round-5 failure
    detection, the warm-start twin of the divergence guard).

    The receding-horizon update map has saturated closed-orbit attractors:
    once the warm-started control sequence curls into a loop shorter than
    the horizon, each replan reproduces it and the robot circles one spot at
    full speed forever (measured round 5: stalled scenarios moved at the
    saturated ~0.3 m/s with < 3 cm net displacement per 60 s — see
    docs/PERFORMANCE.md). Detection is net displacement over the last
    ``cfg.orbit_window`` ticks below ``cfg.orbit_eps``, read from the replay
    buffer (one one-hot contraction — no extra state, no gathers). The
    caller resets the warm start (U = 0: a fresh solve, which measured
    unsaturated and frontier-directed at the same states) when it fires.
    """
    W = cfg.orbit_window
    if W <= 0:
        return jnp.zeros((), dtype=bool)
    cap = buffer.capacity
    # effective window clamps to the ring capacity: count saturates there,
    # so a larger configured window would make the guard silently inert
    # (round-5 review finding) — clamping keeps it armed at the longest
    # observable displacement baseline instead
    W = min(W, cap)
    idx = (buffer.cursor - W) % cap
    hot = (jnp.arange(cap) == idx).astype(buffer.states.dtype)
    prev = jnp.matmul(buffer.states, hot,
                      precision=jax.lax.Precision.HIGHEST)  # (2,) W ticks ago
    disp2 = jnp.sum((p_now - prev) ** 2)
    return (buffer.count >= W) & (disp2 < cfg.orbit_eps * cfg.orbit_eps)


@dataclass(frozen=True)
class ErgodicController:
    """Single-scenario ergodic MPC. Hashable; close over it in jit."""

    config: EngineConfig

    def __post_init__(self):
        self.config.validate()

    @property
    def model(self):
        return make_model(self.config)

    # ------------------------------------------------------------------
    # state management
    # ------------------------------------------------------------------

    def init_state(self, rng=None) -> ControllerState:
        cfg = self.config
        if rng is None:
            rng = jax.random.PRNGKey(0)
        K = cfg.num_basis
        return ControllerState(
            U=jnp.zeros((cfg.horizon, cfg.nu), dtype=jnp.float32),
            buffer=RingBuffer.create(cfg.buffer_capacity),
            ck_sum=jnp.zeros((K, K), dtype=jnp.float32),
            hist_count=jnp.zeros((), dtype=jnp.int32),
            rng=rng,
        )

    # ------------------------------------------------------------------
    # target helper
    # ------------------------------------------------------------------

    def target_coefficients(self, phi_vals, points, domain: Domain):
        """phi_k from normalized phi samples (reference ``spatialCoeff``)."""
        cfg = self.config
        tbl = basis.tables(points, cfg.num_basis, domain)
        hk = basis.hk_norm(cfg.num_basis, domain.lengths)
        return basis.coefficients(tbl, phi_vals, hk)

    # ------------------------------------------------------------------
    # the hot path: one replan tick (SURVEY.md section 4.2)
    # ------------------------------------------------------------------

    def step(self, state: ControllerState, x, vb, phik, world: World):
        """One ergodic-MPC iteration.

        Args:
            state: warm-started ControllerState.
            x: (3,) current pose.
            vb: (3,) current body twist (DWA accel-window center).
            phik: (K, K) target coefficients (see ``target_coefficients``).
            world: domain + distance field.

        Returns:
            (new_state, u_cmd (nu,), StepDiagnostics)
        """
        cfg = self.config
        model = self.model
        K = cfg.num_basis
        H = cfg.horizon
        domain = world.domain

        lam = basis.lambda_weights(K)
        hk = basis.hk_norm(K, domain.lengths)

        # Local distance-field window around the pose: every map query this
        # tick (barrier knots, validation, DWA candidates) goes through it
        # as one-hot/hat matmuls — no gathers (ops/patch.py).
        patch = extract_patch(world.dist, x[:2], cfg.patch_cells)

        # 0. orbit guard: reset the warm start when the scenario is circling
        # one spot (closed-orbit attractor of the replan map; see
        # ``orbit_guard``). Branch-free per-scenario, like the divergence
        # guard in 7b.
        orbiting = orbit_guard(cfg, state.buffer, x[:2])
        U_warm = jnp.where(orbiting, 0.0, state.U)

        # 1. forward rollout of the warm-started sequence
        X = rollout(model, x, U_warm, cfg.dt, unroll=cfg.scan_unroll)  # (H+1, 3)
        knots = X[:-1]  # states x_0..x_{H-1}, aligned with u_0..u_{H-1}
        P = knots[:, :2]
        tbl_roll = basis.tables(P, K, domain)

        # 2. trajectory coefficients over [history || rollout]
        rng, sub = jax.random.split(state.rng)
        roll_sum = basis.coefficients(tbl_roll, jnp.ones(H, dtype=X.dtype), hk)
        if cfg.history == "ring":
            if cfg.buffer_batch is not None:
                # compacted sampled batch: per-state basis work on `batch`
                # rows, not `capacity` rows (ops/buffer.py sample_states)
                s_buf, n_hist = state.buffer.sample_states(cfg.buffer_batch, sub)
                Cbx, Cby = basis.cos_tables(s_buf, K, domain)
                w_buf = jnp.full(s_buf.shape[0], jnp.where(n_hist > 0, 1.0, 0.0))
            else:
                Cbx, Cby = basis.cos_tables(state.buffer.positions, K, domain)
                w_buf = state.buffer.sample_mask(None, sub)  # (cap,)
                n_hist = jnp.sum(w_buf)
            hist_sum = basis.coefficients_cos(Cbx, Cby, w_buf, hk)
        else:  # accumulate
            hist_sum = state.ck_sum
            n_hist = state.hist_count.astype(jnp.float32)
        M = n_hist + H
        ck = (hist_sum + roll_sum) / M

        # 3. ergodic gradient at the rollout knots
        e = basis.ergodic_gradient(tbl_roll, ck, phik, lam, hk, M)  # (H, 2)

        # 4. barrier value + gradient at the knots
        bval, bgrad = barrier(P, domain, patch, cfg)

        # 5. co-state backward sweep
        g_xy = cfg.ergodic_weight * e + cfg.barrier_weight * bgrad
        gs = jnp.concatenate([g_xy, jnp.zeros((H, 1), dtype=g_xy.dtype)], axis=-1)
        As = model.A(knots, U_warm)  # (H, 3, 3)
        rho = costate_solve(As, gs, cfg.dt, unroll=cfg.scan_unroll)  # (H, 3)

        # 6. control update u = sat(-R^-1 B^T rho)
        Bs = model.B(knots, U_warm)  # (H, 3, nu)
        r_inv = 1.0 / jnp.asarray(cfg.r_diag, dtype=jnp.float32)
        u_star = -jnp.einsum("tiu,ti->tu", Bs, rho) * r_inv[None, :]
        u_min = jnp.asarray(cfg.u_min, dtype=jnp.float32)
        u_max = jnp.asarray(cfg.u_max, dtype=jnp.float32)
        U_new = jnp.clip(u_star, u_min[None, :], u_max[None, :])
        u0 = U_new[0]

        # 7. safety: validate u0; DWA fallback on predicted collision (A.7).
        # Safety queries reach <= vel_lim * horizon * dt from the pose, so
        # they run against a central crop of the patch (exact; ~9x less
        # contraction work than the barrier's full window).
        if cfg.enable_safety:
            patch_s = patch.center_crop(cfg.safety_patch_cells)
            code = validate_control(model, x, u0, domain, patch_s, cfg)
            u_dwa, feasible = dwa_control(model, x, vb, u0, domain, patch_s, cfg)
            use_dwa = code >= CRASH
            u_cmd = jnp.where(use_dwa, u_dwa, u0)
        else:
            code = jnp.zeros((), dtype=jnp.int32)
            feasible = jnp.ones((), dtype=bool)
            use_dwa = jnp.zeros((), dtype=bool)
            u_cmd = u0

        # 7b. divergence guard (SURVEY.md section 6, failure detection): a
        # non-finite solve (exploding co-state, bad map data) resets THIS
        # scenario's control sequence to zeros and emits a stop command —
        # the reference's implicit fresh-start behavior, done per-scenario
        # and branch-free so one bad scenario cannot poison the batch.
        diverged = ~(jnp.all(jnp.isfinite(U_new)) & jnp.all(jnp.isfinite(u_cmd)))
        U_new = jnp.where(diverged, 0.0, U_new)
        u_cmd = jnp.where(diverged, 0.0, u_cmd)

        # 8. warm start next tick: shift left, pad zero (reference shift rule)
        U_next = jnp.concatenate([U_new[1:], jnp.zeros((1, cfg.nu), dtype=U_new.dtype)])

        # 9. history: append the ACTUAL current pose (A.7)
        p_now = x[:2]
        new_buffer = state.buffer.append(p_now)
        Cnx, Cny = basis.cos_tables(p_now[None, :], K, domain)
        ck_sum = state.ck_sum + basis.coefficients_cos(Cnx, Cny, jnp.ones(1, dtype=X.dtype), hk)

        new_state = ControllerState(
            U=U_next,
            buffer=new_buffer,
            ck_sum=ck_sum,
            hist_count=state.hist_count + 1,
            rng=rng,
        )
        diag = StepDiagnostics(
            ergodic_metric=basis.ergodic_metric(ck, phik, lam),
            barrier_cost=jnp.mean(bval),
            collision_code=code,
            dwa_active=use_dwa,
            dwa_feasible=feasible,
            diverged=diverged,
            orbit_reset=orbiting,
        )
        return new_state, u_cmd, diag

    def predicted_path(self, state: ControllerState, x):
        """Forward-simulated path for the current sequence (RViz-path parity:
        the reference publishes this as ``nav_msgs/Path``)."""
        return rollout(self.model, x, state.U, self.config.dt)
