"""The batched engine: thousands of ergodic-MPC scenarios per step on a mesh.

This is the build-side replacement for the reference's ROS node (SURVEY.md
section 2 L5 and section 4.1): instead of one robot replanning at 10 Hz over
TCPROS, the engine exposes an array-in/array-out API —

    engine = Engine(config, mesh)
    sc     = engine.init_scenarios(x0s)                  # batched pytree
    sc, us, diags = engine.replan(sc, phiks, world)      # one tick, jitted
    out    = engine.explore(sc, phiks, world, n_ticks)   # closed loop on-device

Parallelism (SURVEY.md section 3 "Parallelism inventory"):
- Scenario parallelism ("DP"): every batched array carries a leading
  ``scenario`` axis laid out over the mesh's ``scenario`` dimension with
  ``NamedSharding``. Each scenario's solve is independent — XLA partitions
  the whole step with zero cross-scenario communication, which is exactly
  the reference workload repeated 4096x.
- Cross-host: the same code runs under ``jax.distributed.initialize`` with a
  multi-host mesh; the leading axis then spans hosts transparently.

Solver state is donated across ticks, so warm-started control sequences and
replay buffers never round-trip through HBM copies.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ergodic_exploration_tpu.config import EngineConfig
from ergodic_exploration_tpu.controller import (
    ControllerState,
    ErgodicController,
    StepDiagnostics,
    World,
)
from ergodic_exploration_tpu.grid import Domain, GridMap
from ergodic_exploration_tpu.ops import target as target_ops
from ergodic_exploration_tpu.ops.distance import DistanceField
from ergodic_exploration_tpu.ops.integrator import rollout


class Scenarios(NamedTuple):
    """Batched solver state: one entry per (map, start-pose) scenario."""

    state: ControllerState  # leaves with leading (S, ...) axis
    x: jnp.ndarray  # (S, 3) poses
    vb: jnp.ndarray  # (S, 3) body twists


class ExploreOutput(NamedTuple):
    scenarios: Scenarios  # final state after n_ticks
    trajectory: jnp.ndarray  # (T, S, 3) poses over time
    controls: jnp.ndarray  # (T, S, nu) emitted controls
    diag: "StepDiagnostics"  # full per-tick diagnostics, leaves (T, S)

    @property
    def ergodic_metric(self):
        return self.diag.ergodic_metric


class Engine:
    """Batched, mesh-sharded ergodic-MPC engine.

    Args:
        config: controller configuration (static; triggers recompilation on
            change, like the reference's rosparam load at node startup).
        mesh: optional ``jax.sharding.Mesh`` with a ``scenario`` axis. When
            None, runs unsharded on the default device (single-chip mode).
    """

    SCENARIO_AXIS = "scenario"
    SAMPLE_AXIS = "sample"

    def __init__(self, config: EngineConfig, mesh: Optional[Mesh] = None):
        self.config = config.validate()
        self.controller = ErgodicController(config)
        self.mesh = mesh
        if mesh is not None and self.SCENARIO_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a {self.SCENARIO_AXIS!r} axis, got {mesh.axis_names}")

        ctrl = self.controller
        model = ctrl.model
        dt = config.dt

        def _tick(state, x, vb, phik, world):
            """One replan + one dt of real motion (the closed-loop body)."""
            state, u, diag = ctrl.step(state, x, vb, phik, world)
            x_next = rollout(model, x, u[None, :], dt)[-1]
            vb_next = model.twist(u)
            return state, x_next, vb_next, u, diag

        self._step_one = ctrl.step
        self._tick_one = _tick

        # batched cores (scenario axis = leading axis everywhere)
        self._replan_batched = jax.vmap(ctrl.step)
        self._tick_batched = jax.vmap(_tick)

        self._replan_jit = self._shard_jit(self._replan_fn, donate=(0,))
        self._explore_jit = self._shard_jit(self._explore_fn, static_argnums=(3,), donate=(0,))
        # cached jitted preprocessing (re-wrapping per call would recompile)
        self._prepare_world_jit = jax.jit(jax.vmap(self._world_one))
        self._phik_from_gmm_jit = jax.jit(self._phik_from_gmm_fn)
        self._phik_gmm_sharded_jit = jax.jit(self._phik_gmm_sharded_fn)
        self._phik_grid_jits = {}  # sensor_radius_cells -> jitted batched fn
        self._phik_grid_sharded_jits = {}  # sensor_radius_cells -> jitted sharded fn

    # ------------------------------------------------------------------
    # shared-geometry contract guards (utils/validation.py)
    # ------------------------------------------------------------------

    def _check_shared_world(self, world: "World") -> None:
        if self.config.shared_maps and self.config.validate_shared:
            from ergodic_exploration_tpu.utils.validation import check_shared_world

            check_shared_world(world)

    def _check_shared_grids(self, grids: GridMap) -> None:
        if self.config.validate_shared:
            from ergodic_exploration_tpu.utils.validation import (
                check_shared_grid_geometry,
            )

            check_shared_grid_geometry(grids)

    # ------------------------------------------------------------------
    # sharding plumbing
    # ------------------------------------------------------------------

    def _sharding(self, spec):
        return NamedSharding(self.mesh, spec)

    def shard_scenarios(self, tree):
        """Lay a batched pytree out over the mesh's scenario axis.

        Leaves are GLOBAL-shaped. Single-process: one ``device_put`` per
        leaf. Multi-process (``jax.distributed``): every process passes the
        same global value, and only this process's scenario slice is fed to
        its devices via ``jax.make_array_from_process_local_data`` — no
        host-side materialization of remote shards (SURVEY.md section 3
        "multi-host launcher": per-host data feeding). Leaves that are
        already global (non-fully-addressable) jax.Arrays — outputs of the
        engine's own sharded steps — pass through untouched.
        """
        if self.mesh is None:
            return tree
        sh = self._sharding(P(self.SCENARIO_AXIS))
        if jax.process_count() > 1:
            import numpy as np

            from ergodic_exploration_tpu.parallel import process_scenario_slice

            def one(a):
                if isinstance(a, jax.Array) and not a.is_fully_addressable:
                    return a  # already laid out by a sharded computation
                a = np.asarray(a)
                start, stop = process_scenario_slice(a.shape[0])
                return jax.make_array_from_process_local_data(sh, a[start:stop], a.shape)

            return jax.tree.map(one, tree)
        return jax.tree.map(lambda a: jax.device_put(a, sh), tree)

    def shard_scenarios_from_local(self, tree):
        """Form global scenario-sharded arrays from THIS PROCESS's slice.

        The production multi-host feeding path: each host materializes only
        its ``parallel.process_scenario_slice`` of the batch (leaves shaped
        (S/process_count, ...)) and the global array is assembled without
        any cross-host transfer of scenario data. Single-process (or no
        mesh), the local slice IS the batch and this equals
        :meth:`shard_scenarios`.
        """
        if self.mesh is None or jax.process_count() == 1:
            return self.shard_scenarios(tree)
        import numpy as np

        sh = self._sharding(P(self.SCENARIO_AXIS))
        n = jax.process_count()

        def one(a):
            a = np.asarray(a)
            global_shape = (a.shape[0] * n,) + a.shape[1:]
            return jax.make_array_from_process_local_data(sh, a, global_shape)

        return jax.tree.map(one, tree)

    def _shard_jit(self, fn, static_argnums=(), donate=()):
        if self.mesh is None:
            return jax.jit(fn, static_argnums=static_argnums, donate_argnums=donate)
        # Every batched input/output is sharded on its leading scenario axis;
        # XLA propagates the layout through the whole step (no collectives —
        # scenarios are independent).
        return jax.jit(
            fn,
            static_argnums=static_argnums,
            donate_argnums=donate,
            in_shardings=None,  # inferred from operands laid out by shard_scenarios
            out_shardings=None,
        )

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def init_scenarios(self, x0, vb0=None, rng=None) -> Scenarios:
        """Batched initial state for poses ``x0`` (S, 3 — the GLOBAL batch;
        every process passes the same value under ``jax.distributed``, and
        each host only computes + feeds its own scenario slice)."""
        x0 = jnp.asarray(x0, dtype=jnp.float32)
        S = x0.shape[0]
        if vb0 is None:
            vb0 = jnp.zeros((S, 3), dtype=jnp.float32)
        if rng is None:
            rng = jax.random.PRNGKey(0)
        if self.config.shared_history_draw:
            # one key for ALL scenarios: per-scenario history draws are then
            # identical each tick (see config.shared_history_draw)
            keys = jax.vmap(lambda _: rng)(jnp.arange(S))
        else:
            keys = jax.random.split(rng, S)  # process-independent
        if self.mesh is not None and jax.process_count() > 1:
            from ergodic_exploration_tpu.parallel import process_scenario_slice

            lo, hi = process_scenario_slice(S)
            state = jax.vmap(lambda k: self.controller.init_state(k))(keys[lo:hi])
            return self.shard_scenarios_from_local(
                Scenarios(state=state, x=x0[lo:hi], vb=vb0[lo:hi])
            )
        state = jax.vmap(lambda k: self.controller.init_state(k))(keys)
        return self.shard_scenarios(Scenarios(state=state, x=x0, vb=vb0))

    def _free_mask_one(self, g: GridMap, domain: Domain) -> jnp.ndarray:
        """(N,) free-space weights at the phi sample lattice: 1 where the map
        is below the occupancy threshold (unknown cells count as free, like
        the single-robot node), 0 in obstacles. Reference ``target.hpp``:
        "GMM phi normalized over free space" (SURVEY.md section 3 / A.3)."""
        pts = domain.sample_lattice(self.config.grid_samples)
        occ = g.occupancy_at(pts)
        return (occ < self.config.occupied_threshold).astype(jnp.float32)

    def _world_one(self, g: GridMap, domain: Optional[Domain] = None) -> World:
        dom = g.domain() if domain is None else domain
        return World(
            domain=dom,
            dist=DistanceField.from_grid(g, self.config.occupied_threshold),
            free_mask=self._free_mask_one(g, dom),
        )

    def prepare_world(self, grids: GridMap, domain: Optional[Domain] = None) -> World:
        """Batched world preprocessing: EDT + gradient + free-space phi mask
        per map (the build-side ``mapCallback``, SURVEY.md section 4.3).
        ``grids`` leaves carry a leading (S, ...) axis. The domain is each
        map's extent (``domain`` arg kept for backward compatibility;
        ignored when None)."""
        # normalize to strong float32: a weak-typed leaf (e.g. from a bare
        # jnp.full) would otherwise silently retrace every jitted consumer
        grids = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), grids)
        if self.config.shared_maps and self.config.validate_shared:
            # shared_maps promises IDENTICAL maps across scenarios (data +
            # geometry) — misuse silently gives every scenario row 0's
            # obstacles. One host readback per distinct grids object.
            from ergodic_exploration_tpu.utils.validation import check_rows_shared

            check_rows_shared(grids, "grids (cfg.shared_maps)")
        if domain is not None:
            return self.shard_scenarios(
                jax.jit(jax.vmap(lambda g: self._world_one(g, domain)))(grids)
            )
        return self.shard_scenarios(self._prepare_world_jit(grids))

    def empty_world(self, domain: Domain, n: int) -> World:
        """Obstacle-free batched world (configs 1 and 2)."""
        one = World.empty(domain)
        return self.shard_scenarios(jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape), one))

    def _phik_from_gmm_fn(self, gmm, domain: Domain, free_mask=None) -> jnp.ndarray:
        """Pure batched target-coefficient computation (traceable).

        Shared-domain fast path: when ``domain`` is unbatched, the sample
        lattice and the dense basis table D (N, K^2) are scenario-invariant,
        so the whole batch reduces in one (S, N) @ (N, K^2) matmul — the
        "10k grid samples" reduction of the headline metric with no
        per-scenario (N, K) tables.

        ``free_mask``: optional (S, N) free-space weights; phi is masked
        before normalization (reference A.3 "normalized over free space")."""
        from ergodic_exploration_tpu.ops import basis

        if self._use_sample_sharding(domain):
            # SP analog: sample-axis sharded reduction with psum combines —
            # replan_refresh and phik_from_gmm both ride this when the mesh
            # has a populated ``sample`` axis (SURVEY.md section 3).
            return self._phik_gmm_sharded_fn(gmm, domain, free_mask)

        cfg = self.config
        K = cfg.num_basis
        if domain.origin.ndim == 1:  # shared domain -> dense-table path
            pts = domain.sample_lattice(cfg.grid_samples)
            hk = basis.hk_norm(K, domain.lengths)
            tbl = basis.tables(pts, K, domain)
            D = basis.dense_table(tbl, hk)
            renorm = None
            if free_mask is not None and cfg.shared_maps:
                # Shared-map fast path: fold the (identical-per-scenario)
                # mask INTO the dense table, then repair the free-space
                # normalizer from the k=(0,0) coefficient. With
                # D'_nk = m_n F_k(p_n): ck_raw = (phi @ D') / sum(phi) and
                # phi@m = h00 * ck_raw[0,0] * sum(phi), so the true
                # free-space-normalized ck = ck_raw / (h00 * ck_raw[0,0]) —
                # the masked refresh costs exactly the unmasked refresh
                # (no (S, N) mask traffic).
                m = free_mask[0] if free_mask.ndim == 2 else free_mask
                D = D * m.astype(D.dtype)[:, None]
                renorm = hk[0, 0]
                # uniform-over-mask fallback (normalize_phi parity): a
                # scenario whose phi has no mass on the free space falls
                # back to (m @ D) / sum(m) — with the mask folded into D
                # that is colsum(D)/sum(m), one shared (K, K) constant
                mask_ck = (
                    jnp.sum(D, axis=0) / jnp.maximum(jnp.sum(m), 1.0)
                ).reshape(K, K)
                free_mask = None

            def _renorm(ck):
                if renorm is None:
                    return ck
                denom = renorm * ck[:, 0, 0]  # = phi mass on the free space
                return jnp.where(
                    (denom > 1e-12)[:, None, None],
                    ck / jnp.maximum(denom, 1e-12)[:, None, None],
                    mask_ck[None, :, :],
                )

            if free_mask is None:
                phi = jax.vmap(lambda g: target_ops.gmm_target_values(pts, g))(gmm)
            else:
                phi = jax.vmap(
                    lambda g, m: target_ops.gmm_target_values(pts, g, free_mask=m)
                )(gmm, free_mask)  # (S, N)
            return _renorm(basis.coefficients_dense(phi, D, K))

        def one(g, dom, m):
            pts = dom.sample_lattice(cfg.grid_samples)
            phi = target_ops.gmm_target_values(pts, g, free_mask=m)
            return self.controller.target_coefficients(phi, pts, dom)

        if free_mask is None:
            return jax.vmap(lambda g, dom: one(g, dom, None))(gmm, domain)
        return jax.vmap(one)(gmm, domain, free_mask)

    def phik_from_gmm(self, gmm, domain: Domain, free_mask=None) -> jnp.ndarray:
        """Batched target coefficients for GMM targets; gmm leaves (S, ...).

        ``free_mask`` may be an (S, N) array or a batched :class:`World`
        (its ``free_mask`` field is used) so callers can do
        ``engine.phik_from_gmm(gmm, domain, world)``."""
        if isinstance(free_mask, World):
            free_mask = free_mask.free_mask
        if self._use_sample_sharding(domain):
            return self.phik_from_gmm_sample_sharded(gmm, domain, free_mask)
        return self.shard_scenarios(self._phik_from_gmm_jit(gmm, domain, free_mask))

    def _use_sample_sharding(self, domain: Domain) -> bool:
        return (
            self.mesh is not None
            and self.SAMPLE_AXIS in self.mesh.axis_names
            and self.mesh.shape[self.SAMPLE_AXIS] > 1
            and domain.origin.ndim == 1
        )

    def _phik_gmm_sharded_fn(self, gmm, domain: Domain, free_mask=None) -> jnp.ndarray:
        """Traceable phi_k with the GRID-SAMPLE axis sharded across the
        mesh's ``sample`` dimension — this project's sequence-parallelism
        analog (SURVEY.md sections 3 and 6: the "long axis" is the
        10k-sample ergodic reduction, combined with ``psum``
        collectives). Composes under the engine's jitted tick, so
        :meth:`replan_refresh` rides it when the mesh has a sample axis.

        Layout: sample lattice and dense basis table D split over
        ``sample``; each device evaluates (and free-space-masks) its phi
        shard, a first psum forms the global normalizer, a second psum
        reduces the (S, K^2) partial coefficient products. Requires an
        unbatched (shared) domain.
        """
        from functools import partial

        from jax import shard_map

        from ergodic_exploration_tpu.ops import basis

        cfg = self.config
        K = cfg.num_basis
        pts = domain.sample_lattice(cfg.grid_samples)  # (N, 2)
        tbl = basis.tables(pts, K, domain)
        hk = basis.hk_norm(K, domain.lengths)
        D = basis.dense_table(tbl, hk)  # (N, K^2)

        mask_spec = (
            P() if free_mask is None else P(self.SCENARIO_AXIS, self.SAMPLE_AXIS)
        )

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(
                jax.tree.map(lambda _: P(self.SCENARIO_AXIS), gmm),
                P(self.SAMPLE_AXIS, None),
                P(self.SAMPLE_AXIS, None),
                mask_spec,
            ),
            out_specs=P(self.SCENARIO_AXIS, None, None),
        )
        def block(gmm_blk, pts_blk, D_blk, mask_blk):
            phi_un = jax.vmap(lambda g: target_ops.gmm_eval(pts_blk, g))(gmm_blk)
            phi_un = jnp.maximum(phi_un, 0.0)  # (S_blk, N_blk)
            if mask_blk is not None:
                m = mask_blk.astype(phi_un.dtype)
                phi_un = phi_un * m
            total = jax.lax.psum(jnp.sum(phi_un, axis=1), self.SAMPLE_AXIS)  # (S_blk,)
            # Degenerate fallback — same rule as target.normalize_phi: a
            # scenario whose masked phi sums to ~0 (fully occupied map)
            # falls back to uniform over the mask, not ~0 coefficients.
            if mask_blk is not None:
                m_total = jax.lax.psum(jnp.sum(m, axis=1), self.SAMPLE_AXIS)
                fallback = m / jnp.maximum(m_total, 1.0)[:, None]
            else:
                n_global = pts_blk.shape[0] * self.mesh.shape[self.SAMPLE_AXIS]
                fallback = jnp.full_like(phi_un, 1.0 / n_global)
            phi = jnp.where(
                (total > 1e-12)[:, None],
                phi_un / jnp.maximum(total, 1e-12)[:, None],
                fallback,
            )
            partial_ck = jnp.matmul(
                phi, D_blk, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            ck = jax.lax.psum(partial_ck, self.SAMPLE_AXIS)  # (S_blk, K^2)
            return ck.reshape(ck.shape[0], K, K)

        return block(gmm, pts, D, free_mask)

    def phik_from_gmm_sample_sharded(self, gmm, domain: Domain, free_mask=None) -> jnp.ndarray:
        """Sample-sharded phi_k through the engine's CACHED jit (one compile
        per (structure, mask-presence) signature — re-wrapping a fresh
        closure per call used to recompile every tick)."""
        if isinstance(free_mask, World):
            free_mask = free_mask.free_mask
        return self._phik_gmm_sharded_jit(gmm, domain, free_mask)

    def _phik_grid_sharded_fn(self, grids: GridMap, sensor_radius_cells: int = 0) -> jnp.ndarray:
        """Traceable MI-target phi_k with the sample axis sharded (the MI
        twin of :meth:`_phik_gmm_sharded_fn`): each device computes the full
        per-scenario information map (map-space work is not shardable along
        samples), gathers its OWN shard of the lattice, and the normalizer +
        coefficient reductions combine with ``psum``."""
        from functools import partial

        from jax import shard_map

        from ergodic_exploration_tpu.ops import basis

        cfg = self.config
        K = cfg.num_basis
        # All scenarios must share the lattice for sample sharding; use the
        # first map's domain (callers batch identical extents).
        g0 = jax.tree.map(lambda a: a[0], grids)
        dom = g0.domain()
        pts = dom.sample_lattice(cfg.grid_samples)
        tbl = basis.tables(pts, K, dom)
        hk = basis.hk_norm(K, dom.lengths)
        D = basis.dense_table(tbl, hk)

        @partial(
            shard_map,
            mesh=self.mesh,
            in_specs=(
                jax.tree.map(lambda _: P(self.SCENARIO_AXIS), grids),
                P(self.SAMPLE_AXIS, None),
                P(self.SAMPLE_AXIS, None),
            ),
            out_specs=P(self.SCENARIO_AXIS, None, None),
        )
        def block(grids_blk, pts_blk, D_blk):
            def vals_one(g):
                info = target_ops.mutual_information_map(
                    g, sensor_radius_cells, cfg.mi_frontier_cells,
                    cfg.occupied_threshold)
                return jnp.maximum(target_ops.sample_map_at(info, g, pts_blk), 0.0)

            vals = jax.vmap(vals_one)(grids_blk)  # (S_blk, N_blk)
            total = jax.lax.psum(jnp.sum(vals, axis=1), self.SAMPLE_AXIS)
            # normalize_phi parity: all-zero info (fully occupied map) falls
            # back to uniform over the full lattice, not ~0 coefficients
            n_global = pts_blk.shape[0] * self.mesh.shape[self.SAMPLE_AXIS]
            phi = jnp.where(
                (total > 1e-12)[:, None],
                vals / jnp.maximum(total, 1e-12)[:, None],
                jnp.full_like(vals, 1.0 / n_global),
            )
            partial_ck = jnp.matmul(
                phi, D_blk, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )
            ck = jax.lax.psum(partial_ck, self.SAMPLE_AXIS)
            return ck.reshape(ck.shape[0], K, K)

        return block(grids, pts, D)

    def _phik_grid_one(self, g: GridMap, sensor_radius_cells: int = 0):
        """One scenario's MI target coefficients, gather-free (the separable
        one-hot contraction of ops/target.py — config 4's per-tick refresh;
        parity vs the gather path is pinned by tests/test_target.py).
        General per-scenario geometry; for a SHARED domain the batched
        dense path (:meth:`_phik_grid_batch_dense_fn`) batches the work."""
        cfg = self.config
        return target_ops.phik_from_grid_separable(
            g, cfg.num_basis, cfg.grid_samples,
            sensor_radius_cells=sensor_radius_cells,
            frontier_cells=cfg.mi_frontier_cells,
            occupied_threshold=cfg.occupied_threshold,
        )

    def _phik_grid_batch_dense_fn(self, grids: GridMap, domain: Domain,
                                  sensor_radius_cells: int):
        """Batched MI target coefficients on a SHARED (unbatched) domain:
        per-scenario entropy map -> gather-free one-hot lattice resample
        with the SENSOR-FOOTPRINT BLUR FOLDED INTO the sampling matrices ->
        ONE (S, N) @ (N, K^2) dense contraction. Same values as the
        separable/gather paths (parity-pinned by tests/test_target.py).

        Layout choices:
        - the box blur is LINEAR, so blur-then-sample folds into exact
          small-integer count matrices (target_ops.blur_count_matrix) at
          trace time — the blur's cumsum passes over (S, H, W) disappear
          and the (2r+1)^2 scale cancels in phi normalization;
        - the occupied-cell zeroing happens AFTER the blur in
          mutual_information_map; nearest-cell sampling commutes with
          elementwise products, so it becomes a resampled 0/1 mask — a
          one-hot matmul that is exact at DEFAULT precision (0/1 and small
          integer operands survive bf16 and TF32 rounding).
        """
        from ergodic_exploration_tpu.ops import basis

        cfg = self.config
        K = cfg.num_basis
        r = sensor_radius_cells
        nsx, nsy = cfg.grid_samples
        pts = domain.sample_lattice(cfg.grid_samples)
        hk = basis.hk_norm(K, domain.lengths)
        D = basis.dense_table(basis.tables(pts, K, domain), hk)
        h, w = grids.data.shape[-2:]
        _HI = jax.lax.Precision.HIGH
        _DEF = jax.lax.Precision.DEFAULT

        # The shared-domain contract extends to shared GRID GEOMETRY (the
        # sharded MI path documents the same assumption): sampling + blur
        # matrices are built ONCE from scenario 0's geometry, so the whole
        # batch reduces through shared-RHS batched GEMMs instead of
        # per-scenario matrix construction under vmap.
        g0 = jax.tree.map(lambda a: a[0], grids)
        Ax, Ay = target_ops.sampling_one_hots(g0, cfg.grid_samples, domain)
        Bx = target_ops.blur_count_matrix(w, r)
        By = target_ops.blur_count_matrix(h, r)
        Axb = jnp.matmul(Ax, Bx, precision=_DEF)  # (nsx, w) small-int exact
        Ayb = jnp.matmul(Ay, By, precision=_DEF)  # (nsy, h)

        info = target_ops.entropy(grids.prob())  # (S, h, w), unblurred
        fc = cfg.mi_frontier_cells
        occ_t = cfg.occupied_threshold
        zfree = (~grids.occupied(occ_t)).astype(jnp.float32)  # (S, h, w)
        # blurred info at the lattice, scaled by (2r+1)^2 (cancels below):
        # sampled[s, ix, iy] = (Axb info[s]^T Ayb^T)[ix, iy]
        t1 = jnp.matmul(info, Axb.T, precision=_HI,
                        preferred_element_type=jnp.float32)  # (S, h, nsx)
        sampled = jnp.matmul(
            jnp.transpose(t1, (0, 2, 1)), Ayb.T,
            precision=_HI, preferred_element_type=jnp.float32)  # (S, nsx, nsy)
        z1 = jnp.matmul(zfree, Ax.T, precision=_DEF)  # (S, h, nsx)
        zs = jnp.matmul(jnp.transpose(z1, (0, 2, 1)), Ay.T, precision=_DEF)
        if fc > 0:
            # Frontier mask (target_ops.frontier_adjacency): nearest-cell
            # sampling commutes with elementwise products AND monotone
            # thresholds, so instead of masking in cell space (which would
            # unfold the blur and cost explicit (S, h, w) transposes) the
            # known-free COUNT field is sampled through count-folded one-hots
            # (Ax @ Fx, small ints <= (2fc+1)^2, exact at DEFAULT) and
            # thresholded at the lattice: sample(adj (.) blur(E)) ==
            # (sample counts > 0) (.) sample(blur(E)) exactly.
            kf = ((grids.data >= 0.0) & (~grids.occupied(occ_t))).astype(jnp.float32)
            Axf = jnp.matmul(Ax, target_ops.blur_count_matrix(w, fc),
                             precision=_DEF)  # (nsx, w)
            Ayf = jnp.matmul(Ay, target_ops.blur_count_matrix(h, fc),
                             precision=_DEF)  # (nsy, h)
            k1 = jnp.matmul(kf, Axf.T, precision=_DEF)  # (S, h, nsx)
            ks = jnp.matmul(jnp.transpose(k1, (0, 2, 1)), Ayf.T,
                            precision=_DEF)  # (S, nsx, nsy)
            zs = zs * (ks > 0.5).astype(zs.dtype)
        vals = jnp.maximum((sampled * zs).reshape(-1, nsx * nsy), 0.0)  # (S, N)
        ck_raw = basis.coefficients_dense(vals, D, K)
        total = ck_raw[:, 0, 0] * hk[0, 0]  # scaled sum — scale cancels
        n = float(pts.shape[0])
        fallback = (jnp.sum(D, axis=0) / n).reshape(K, K)[None]
        return jnp.where(
            (total > 1e-12)[:, None, None],
            ck_raw / jnp.maximum(total, 1e-12)[:, None, None],
            fallback,
        )

    def phik_from_grid(self, grids: GridMap, sensor_radius_cells: int = 0,
                       domain: Optional[Domain] = None) -> jnp.ndarray:
        """Batched mutual-information target coefficients recomputed from the
        (evolving) occupancy grids — BASELINE config 4. Rides the sample-
        sharded reduction when the mesh has a populated ``sample`` axis.

        ``domain``: pass the (unbatched) shared exploration domain when all
        grids share it — enables the dense batched path; omitted, the
        general per-scenario separable path runs."""
        r = sensor_radius_cells
        if (
            self.mesh is not None
            and self.SAMPLE_AXIS in self.mesh.axis_names
            and self.mesh.shape[self.SAMPLE_AXIS] > 1
        ):
            self._check_shared_grids(grids)  # lattice from scenario 0's domain
            f = self._phik_grid_sharded_jits.get(r)
            if f is None:
                f = jax.jit(lambda g: self._phik_grid_sharded_fn(g, r))
                self._phik_grid_sharded_jits[r] = f
            return f(grids)
        dense = domain is not None and domain.origin.ndim == 1
        if dense:
            self._check_shared_grids(grids)  # dense path: scenario-0 geometry
        f = self._phik_grid_jits.get((r, dense))
        if f is None:
            if dense:
                f = jax.jit(lambda g, d: self._phik_grid_batch_dense_fn(g, d, r))
            else:
                f = jax.jit(lambda g, d: jax.vmap(
                    lambda g1: self._phik_grid_one(g1, r))(g))
            self._phik_grid_jits[(r, dense)] = f
        return self.shard_scenarios(f(grids, domain))

    # ------------------------------------------------------------------
    # startup (SURVEY.md section 4.1: compilation is the startup cost)
    # ------------------------------------------------------------------

    def warmup(self, S: int, domain: Domain, map_shape=None,
               gmm_components: int = 1, n_ticks=(), persistent_cache=None) -> dict:
        """Deliberately compile the hot entry points with dummy data so the
        first real tick never stalls (AOT warm-up; the reference's analog is
        doing all construction in the node ctor, SURVEY.md section 4.1).

        Compiles: the batched replan, the full refresh+replan tick, phi_k
        refresh (GMM + MI when ``map_shape`` is given), world preparation,
        and ``explore`` for each length in ``n_ticks``. With
        ``persistent_cache`` (a directory path or True for the default),
        compiled executables survive process restarts.

        Returns {stage: seconds} so callers can log the startup budget.
        """
        import time as _time

        import numpy as np

        if persistent_cache:
            from ergodic_exploration_tpu.utils.compile_cache import (
                enable_persistent_cache,
            )

            enable_persistent_cache(
                None if persistent_cache is True else persistent_cache
            )

        timings = {}

        def timed(name, fn):
            t0 = _time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            timings[name] = round(_time.perf_counter() - t0, 3)
            return out

        J = gmm_components
        gmm = target_ops.GaussianMixture.create(
            means=np.full((S, J, 2), 0.5, np.float32),
            covs=np.tile(np.eye(2, dtype=np.float32)[None, None], (S, J, 1, 1)),
            weights=np.ones((S, J), np.float32),
        )
        sc = timed("init_scenarios", lambda: self.init_scenarios(
            np.zeros((S, 3), np.float32)))
        if map_shape is not None:
            res = float(domain.lengths[0]) / map_shape[1]
            grids = GridMap(
                data=jnp.zeros((S,) + tuple(map_shape), jnp.float32),
                origin=jnp.broadcast_to(domain.origin, (S, 2)),
                resolution=jnp.full((S,), res, jnp.float32),
            )
            world = timed("prepare_world", lambda: self.prepare_world(grids))
            timed("phik_from_grid", lambda: self.phik_from_grid(grids))
            timed("replan_refresh_mi", lambda: self.replan_refresh_mi(
                _copy_tree(sc), grids, world, domain=domain)[1])
        else:
            world = self.empty_world(domain, S)
        phik = timed("phik_from_gmm", lambda: self.phik_from_gmm(
            gmm, domain, world.free_mask))
        timed("replan", lambda: self.replan(_copy_tree(sc), phik, world)[1])
        timed("replan_refresh", lambda: self.replan_refresh(
            _copy_tree(sc), gmm, domain, world)[1])
        for n in n_ticks:
            timed(f"explore_{n}", lambda n=n: self.explore(
                _copy_tree(sc), phik, world, n).controls)
        return timings

    # ------------------------------------------------------------------
    # checkpoint / resume (SURVEY.md section 6)
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str, sc: Scenarios) -> None:
        """Snapshot the full batched solver state to ``path`` (.npz)."""
        from ergodic_exploration_tpu.utils.checkpoint import save_pytree

        save_pytree(path, sc)

    def load_checkpoint(self, path: str) -> Scenarios:
        """Restore :class:`Scenarios` saved by :meth:`save_checkpoint`,
        re-laid-out over this engine's mesh (device topology may differ
        from the run that wrote the file)."""
        import numpy as np

        from ergodic_exploration_tpu.utils.checkpoint import load_pytree

        with np.load(path) as data:
            # every Scenarios leaf has the scenario count as its leading axis
            leaf_keys = sorted(k for k in data.files if k.startswith("leaf_"))
            S = data[leaf_keys[0]].shape[0]
        like = self.init_scenarios(np.zeros((S, 3), np.float32))
        return self.shard_scenarios(load_pytree(path, like))

    # ------------------------------------------------------------------
    # the batched API
    # ------------------------------------------------------------------

    def _replan_fn(self, sc: Scenarios, phik, world: World):
        state, u, diag = self._replan_batched(sc.state, sc.x, sc.vb, phik, world)
        return Scenarios(state=state, x=sc.x, vb=sc.vb), u, diag

    def replan(self, sc: Scenarios, phik, world: World):
        """One batched replan tick: (S,) solves -> (S, nu) controls.

        Does NOT advance the poses — mirror of the reference's per-tick
        ``control()`` call; the host (or :meth:`explore`) owns the plant.
        """
        self._check_shared_world(world)
        return self._replan_jit(sc, phik, world)

    def _refresh_and_replan_fn(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """Target refresh (10k-sample phi_k reduction, free-space masked) +
        batched solve in one trace — the reference's FULL per-tick work
        (SURVEY.md section 4.2 step 1 + steps 2-7). This is the benchmarked
        'solve'."""
        phik = self._phik_from_gmm_fn(gmm, domain, world.free_mask)
        return self._replan_fn(sc, phik, world)

    def replan_refresh(self, sc: Scenarios, gmm, domain: Domain, world: World):
        """One batched tick including the per-tick GMM target refresh, fused
        in a single jitted program (the full reference tick; what bench.py
        measures). Use :meth:`replan` when phi_k is precomputed/static."""
        self._check_shared_world(world)
        if not hasattr(self, "_replan_refresh_jit"):
            self._replan_refresh_jit = self._shard_jit(self._refresh_and_replan_fn, donate=(0,))
        return self._replan_refresh_jit(sc, gmm, domain, world)

    def _refresh_mi_and_replan_fn(self, sc: Scenarios, grids: GridMap,
                                  world: World, sensor_radius_cells: int,
                                  domain: Optional[Domain] = None):
        """MI target refresh from the evolving occupancy grids + batched
        solve in one trace — BASELINE config 4's FULL per-tick work
        ("mutual-information target recomputed from an evolving occupancy
        grid each replan", SURVEY.md sections 3 and 4.3). Gather-free: the
        sample-axis-sharded psum reduction when the mesh has a populated
        ``sample`` axis (same dispatch as standalone :meth:`phik_from_grid`),
        else the dense resample+contract path when a shared ``domain`` is
        given, else the per-scenario separable contraction (ops/target.py)."""
        if (
            self.mesh is not None
            and self.SAMPLE_AXIS in self.mesh.axis_names
            and self.mesh.shape[self.SAMPLE_AXIS] > 1
        ):
            phik = self._phik_grid_sharded_fn(grids, sensor_radius_cells)
        elif domain is not None and domain.origin.ndim == 1:
            phik = self._phik_grid_batch_dense_fn(grids, domain, sensor_radius_cells)
        else:
            phik = jax.vmap(
                lambda g: self._phik_grid_one(g, sensor_radius_cells)
            )(grids)
        return self._replan_fn(sc, phik, world)

    def replan_refresh_mi(self, sc: Scenarios, grids: GridMap, world: World,
                          sensor_radius_cells: int = 0,
                          domain: Optional[Domain] = None):
        """One batched tick including the per-tick MUTUAL-INFORMATION target
        refresh (config 4's hot path).
        ``world`` carries the distance field built from the same beliefs at
        map cadence (the reference's ~1 Hz SLAM refresh vs its 10 Hz control
        loop, SURVEY.md section 4.3). Pass the shared ``domain`` when all
        grids span it — the refresh then rides the dense batched path."""
        self._check_shared_world(world)
        if domain is not None and domain.origin.ndim == 1:
            self._check_shared_grids(grids)  # dense path: scenario-0 geometry
        jits = getattr(self, "_replan_refresh_mi_jits", None)
        if jits is None:
            jits = self._replan_refresh_mi_jits = {}
        key = (sensor_radius_cells, domain is not None and domain.origin.ndim == 1)
        f = jits.get(key)
        if f is None:
            f = self._shard_jit(self._refresh_mi_and_replan_fn,
                                static_argnums=(3,), donate=(0,))
            jits[key] = f
        return f(sc, grids, world, sensor_radius_cells, domain)

    def _explore_fn(self, sc: Scenarios, phik, world: World, n_ticks: int):
        def body(carry, _):
            state, x, vb = carry
            state, x2, vb2, u, diag = self._tick_batched(state, x, vb, phik, world)
            return (state, x2, vb2), (x2, u, diag)

        (state, x, vb), (X, Us, D) = jax.lax.scan(
            body, (sc.state, sc.x, sc.vb), None, length=n_ticks
        )
        return ExploreOutput(
            scenarios=Scenarios(state=state, x=x, vb=vb),
            trajectory=X,
            controls=Us,
            diag=D,
        )

    def explore(self, sc: Scenarios, phik, world: World, n_ticks: int) -> ExploreOutput:
        """Closed-loop batched exploration, entirely on-device.

        Each tick = replan + apply the emitted control for one dt through
        the true kinematics (the reference's node loop + robot plant,
        SURVEY.md section 4.2, fused into one ``lax.scan``).
        """
        return self._explore_jit(sc, phik, world, n_ticks)

    def explore_mapping(self, sc: Scenarios, truth: GridMap, n_ticks: int,
                        sensor_range: float = 1.5, refresh_every: int = 10,
                        belief: Optional[GridMap] = None,
                        sensor_model: str = "raycast"):
        """Closed-loop exploration WITH online mapping (BASELINE config 4,
        end-to-end): per-scenario beliefs start unknown, a range sensor
        reveals the hidden ground-truth maps as the robots move, and the
        mutual-information target + distance field are recomputed from the
        evolving beliefs every ``refresh_every`` ticks (the reference's
        ~1 Hz SLAM map cadence against its 10 Hz control loop).

        ``sensor_model``: "raycast" (default; occlusion-aware — cells behind
        walls stay unknown, matching the reference's SLAM-sourced ``/map``,
        SURVEY.md section 4.3) or "disc" (x-ray disc; the round-1/2 model).

        Returns (ExploreOutput of the final chunk, belief GridMap,
        coverage (n_refreshes,) fraction-known history).
        """
        from ergodic_exploration_tpu.ops import sensor

        if belief is None:
            belief = truth._replace(data=jnp.full_like(truth.data, -1.0))
        if sensor_model == "raycast":
            res = float(jnp.min(truth.resolution))
            win = sensor.raycast_window_cells(sensor_range, res)

            def reveal_one(b, t, x):
                return sensor.reveal_raycast(
                    b, t, x, sensor_range, win,
                    occupied_threshold=self.config.occupied_threshold)

            reveal_b = jax.jit(jax.vmap(reveal_one))
        elif sensor_model == "disc":
            reveal_b = jax.jit(jax.vmap(sensor.reveal, in_axes=(0, 0, 0, None)),
                               static_argnums=(3,))
            reveal_b = (lambda f: lambda b, t, x: f(b, t, x, sensor_range))(reveal_b)
        else:
            raise ValueError(f"unknown sensor_model {sensor_model!r}")
        coverage = []
        out = None
        for _ in range(max(1, n_ticks // refresh_every)):
            belief = reveal_b(belief, truth, sc.x)
            phik = self.phik_from_grid(belief)
            world = self.prepare_world(belief)
            out = self.explore(sc, phik, world, refresh_every)
            sc = out.scenarios
            coverage.append(sensor.fraction_known(belief))
        return out, belief, jnp.stack(coverage)

    def explore_mapping_fused(self, sc: Scenarios, truth: GridMap,
                              n_refreshes: int, refresh_every: int = 10,
                              sensor_range: float = 1.5,
                              sensor_radius_cells: int = 0):
        """:meth:`explore_mapping`, entirely ON-DEVICE: one jitted
        ``lax.scan`` over map-refresh chunks, each = occlusion-aware reveal
        -> MI target refresh (dense path) -> EDT world rebuild -> an inner
        ``explore`` scan of ``refresh_every`` ticks. Zero host round trips
        between refreshes — the whole config-4 closed loop (sense, map,
        target, plan, act; SURVEY.md section 4.3) is one XLA program, so
        thousands of mapping scenarios run at device speed.

        Requires identically-shaped grids sharing one domain (the batched
        engine's standard setup). Returns (Scenarios, belief GridMap,
        coverage (n_refreshes,) history, trajectory (n_refreshes,
        refresh_every, S, 3), ergodic metric (n_refreshes, refresh_every, S)
        — the per-tick metric against each refresh's CURRENT MI target, the
        config-4 quality curve).
        """
        from ergodic_exploration_tpu.ops import sensor

        g0 = jax.tree.map(lambda a: a[0], truth)
        res = float(jnp.min(truth.resolution))
        win = sensor.raycast_window_cells(sensor_range, res)
        dom = Domain(origin=g0.origin, lengths=g0.domain().lengths)

        jits = getattr(self, "_explore_mapping_fused_jits", None)
        if jits is None:
            jits = self._explore_mapping_fused_jits = {}
        key = (n_refreshes, refresh_every, win, sensor_radius_cells,
               float(sensor_range))
        f = jits.get(key)
        if f is None:
            def run(sc_, truth_, belief_, dom_):
                def chunk(carry, _):
                    sc_c, belief_c = carry
                    belief_c = jax.vmap(lambda b, t, x: sensor.reveal_raycast(
                        b, t, x, sensor_range, win,
                        occupied_threshold=self.config.occupied_threshold))(
                            belief_c, truth_, sc_c.x)
                    phik = self._phik_grid_batch_dense_fn(
                        belief_c, dom_, sensor_radius_cells)
                    world = jax.vmap(self._world_one)(belief_c)
                    out = self._explore_fn(sc_c, phik, world, refresh_every)
                    return (out.scenarios, belief_c), (
                        sensor.fraction_known(belief_c), out.trajectory,
                        out.diag.ergodic_metric)

                (sc2, b2), (cov, traj, em) = jax.lax.scan(
                    chunk, (sc_, belief_), None, length=n_refreshes)
                return sc2, b2, cov, traj, em

            f = self._shard_jit(run, donate=(0,))
            jits[key] = f
        belief = truth._replace(data=jnp.full_like(truth.data, -1.0))
        return f(sc, truth, belief, dom)


def _copy_tree(tree):
    """Fresh buffers for donation-safe warm-up calls."""
    return jax.tree.map(jnp.copy, tree)


def make_scenario_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the scenario axis (single- or multi-host; under
    ``jax.distributed.initialize`` ``jax.devices()`` spans all hosts)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (Engine.SCENARIO_AXIS,))


def make_mesh(n_scenario: int, n_sample: int = 1, devices=None) -> Mesh:
    """2-D (scenario, sample) mesh: scenario-parallel solves with the grid-
    sample reduction optionally sharded across ``n_sample`` devices each."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    need = n_scenario * n_sample
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_scenario, n_sample)
    return Mesh(arr, (Engine.SCENARIO_AXIS, Engine.SAMPLE_AXIS))
