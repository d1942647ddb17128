"""The batched Engine (``jax.vmap(ErgodicController.step)``) == a loop of
single-scenario controller steps.

Each case runs a multi-tick closed batch with obstacles, history sampling
and live safety through the Engine's public entry points, then replays every
scenario alone through the jitted single-scenario controller (the path the
oracle tests pin, tests/test_controller.py) and requires the same controls,
metrics, collision codes, DWA decisions and solver state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ergodic_exploration_tpu.config import default_config
from ergodic_exploration_tpu.controller import ErgodicController
from ergodic_exploration_tpu.engine import Engine, make_scenario_mesh
from ergodic_exploration_tpu.grid import Domain, GridMap
from ergodic_exploration_tpu.ops import target as target_ops
from ergodic_exploration_tpu.ops.integrator import rollout


def _case(model: str, S: int = 8, seed: int = 3):
    cfg = default_config(model).replace(num_basis=6, buffer_capacity=64)
    domain = Domain.create(0.0, 0.0, 3.0, 3.0)
    rng = np.random.default_rng(seed)
    x0 = np.concatenate(
        [rng.uniform(0.4, 2.6, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))], axis=1
    ).astype(np.float32)
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0  # wall through the middle
    grids = GridMap(
        data=jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
        origin=jnp.zeros((S, 2), jnp.float32),
        resolution=jnp.full((S,), 0.05, jnp.float32),
    )
    gmm = target_ops.GaussianMixture.create(
        means=rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32),
        covs=np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32),
    )
    return cfg, domain, x0, grids, gmm


def _row(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _single_phik(cfg, gmm, domain, world, i, masked=True):
    """Scenario i's target coefficients the single-robot way (node.py):
    phi normalized over the free mask, then the controller's reduction."""
    ctrl = ErgodicController(cfg)
    pts = domain.sample_lattice(cfg.grid_samples)
    mask = world.free_mask[i] if masked else None
    phi = target_ops.gmm_target_values(pts, _row(gmm, i), free_mask=mask)
    return ctrl.target_coefficients(phi, pts, domain)


def _single_loop(eng, sc0, phiks, world, n_ticks, plant=False):
    """Every scenario alone through the jitted single-scenario step.

    Returns ({"u": controls (T, S, nu), "m": metrics, "c": codes, "d": DWA
    active, "f": DWA feasible, "o": orbit resets, "x": poses (T, S, 3)},
    final per-scenario states)."""
    ctrl = eng.controller
    step = jax.jit(ctrl.step)
    model = ctrl.model
    S = sc0.x.shape[0]
    out = {k: [] for k in ("u", "m", "c", "d", "f", "o", "x")}
    states = []
    for i in range(S):
        st, x, vb = _row(sc0.state, i), sc0.x[i], sc0.vb[i]
        w = _row(world, i)
        cols = {k: [] for k in out}
        for _ in range(n_ticks):
            st, u, diag = step(st, x, vb, phiks[i], w)
            if plant:
                x = rollout(model, x, u[None, :], eng.config.dt)[-1]
                vb = model.twist(u)
            cols["u"].append(np.asarray(u))
            cols["m"].append(float(diag.ergodic_metric))
            cols["c"].append(int(diag.collision_code))
            cols["d"].append(bool(diag.dwa_active))
            cols["f"].append(bool(diag.dwa_feasible))
            cols["o"].append(bool(diag.orbit_reset))
            cols["x"].append(np.asarray(x))
        for k in out:
            out[k].append(np.stack(cols[k]))
        states.append(jax.tree.map(np.asarray, st))
    res = {k: np.stack(v, axis=1) for k, v in out.items()}  # (T, S, ...)
    return res, states


def _batched_replan(eng, sc, phik, world, n_ticks, refresh=None):
    res = {k: [] for k in ("u", "m", "c", "d", "f", "o")}
    for _ in range(n_ticks):
        if refresh is None:
            sc, u, diag = eng.replan(sc, phik, world)
        else:
            gmm, domain = refresh
            sc, u, diag = eng.replan_refresh(sc, gmm, domain, world)
        res["u"].append(np.asarray(u))
        res["m"].append(np.asarray(diag.ergodic_metric))
        res["c"].append(np.asarray(diag.collision_code))
        res["d"].append(np.asarray(diag.dwa_active))
        res["f"].append(np.asarray(diag.dwa_feasible))
        res["o"].append(np.asarray(diag.orbit_reset))
    return {k: np.stack(v) for k, v in res.items()}, jax.tree.map(np.asarray, sc)


def _assert_match(got, want, atol=5e-5):
    np.testing.assert_allclose(got["u"], want["u"], atol=atol)
    np.testing.assert_allclose(got["m"], want["m"], rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(got["c"], want["c"])
    np.testing.assert_array_equal(got["d"], want["d"])
    np.testing.assert_array_equal(got["o"], want["o"])


def _assert_states(sc, states, atol=5e-5):
    for i, st in enumerate(states):
        np.testing.assert_allclose(sc.state.U[i], st.U, atol=atol)
        np.testing.assert_allclose(sc.state.buffer.states[i], st.buffer.states, atol=1e-6)
        np.testing.assert_allclose(sc.state.ck_sum[i], st.ck_sum, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("model", ["cart", "omni"])
@pytest.mark.parametrize("history", ["ring", "accumulate"])
def test_batched_replan_matches_single_controller(model, history):
    cfg, domain, x0, grids, gmm = _case(model)
    eng = Engine(cfg.replace(history=history))
    sc = eng.init_scenarios(x0)
    phik = eng.phik_from_gmm(gmm, domain)
    world = eng.prepare_world(grids)
    want, states = _single_loop(eng, sc, np.asarray(phik), world, 3)
    got, sc_b = _batched_replan(eng, sc, phik, world, 3)
    _assert_match(got, want)
    _assert_states(sc_b, states)


def test_batched_shared_history_draw_matches_single():
    """shared_history_draw=True: one key for every scenario, so each
    scenario's history draw equals the single controller's with that key;
    controls still differ across scenarios (no accidental collapse)."""
    cfg, domain, x0, grids, gmm = _case("cart")
    eng = Engine(cfg.replace(shared_history_draw=True))
    sc = eng.init_scenarios(x0)
    keys = np.asarray(sc.state.rng)
    assert (keys == keys[0]).all()
    phik = eng.phik_from_gmm(gmm, domain)
    world = eng.prepare_world(grids)
    want, states = _single_loop(eng, sc, np.asarray(phik), world, 4)
    got, sc_b = _batched_replan(eng, sc, phik, world, 4)
    _assert_match(got, want)
    _assert_states(sc_b, states)
    assert not np.allclose(got["u"][-1][0], got["u"][-1][1])


@pytest.mark.parametrize("model", ["cart", "omni"])
def test_shared_maps_refresh_tick_matches_single(model):
    """shared_maps=True folds the free mask into the basis table; the
    batched refresh + solve must equal the single robot's masked target
    and step over multiple ticks with obstacles."""
    cfg, domain, x0, grids, gmm = _case(model)
    eng = Engine(cfg.replace(shared_maps=True))
    sc = eng.init_scenarios(x0)
    world = eng.prepare_world(grids)
    phiks = [_single_phik(eng.config, gmm, domain, world, i) for i in range(len(x0))]
    want, _ = _single_loop(eng, sc, phiks, world, 3)
    got, _ = _batched_replan(eng, sc, None, world, 3, refresh=(gmm, domain))
    _assert_match(got, want)


def test_batched_sharded_matches_single():
    """The batched replan on an 8-device scenario mesh == the single loop."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, domain, x0, grids, gmm = _case("cart", S=16)
    eng = Engine(cfg, mesh=make_scenario_mesh(8))
    sc = eng.init_scenarios(x0)
    phik = eng.phik_from_gmm(gmm, domain)
    world = eng.prepare_world(grids)
    want, _ = _single_loop(eng, sc, np.asarray(phik), world, 1)
    got, _ = _batched_replan(eng, sc, phik, world, 1)
    np.testing.assert_allclose(got["u"], want["u"], rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got["c"], want["c"])
    assert len(sc.x.sharding.device_set) == 8


@pytest.mark.parametrize("shared", [False, True])
def test_empty_world_and_boundary_match_single(shared):
    """Obstacle-free world (FAR distance field) + starts near the boundary:
    the boundary barrier path and the FAR plateau match the single step."""
    cfg = default_config("cart").replace(num_basis=5, buffer_capacity=32,
                                         shared_maps=shared)
    domain = Domain.create(0.0, 0.0, 2.0, 2.0)
    S = 8
    x0 = np.array(
        [[0.08, 0.1, 2.5], [1.9, 1.92, -0.5], [1.0, 0.05, 3.0], [0.1, 1.9, 0.1],
         [0.5, 0.5, 1.0], [1.5, 1.5, -2.0], [1.0, 1.0, 0.0], [0.2, 1.0, -1.0]],
        np.float32,
    )
    gmm = target_ops.GaussianMixture.create(
        means=np.tile(np.array([[1.0, 1.0]], np.float32)[None], (S, 1, 1)),
        covs=np.tile((0.15 * np.eye(2, dtype=np.float32))[None, None], (S, 1, 1, 1)),
        weights=np.ones((S, 1), np.float32),
    )
    eng = Engine(cfg)
    sc = eng.init_scenarios(x0)
    phik = eng.phik_from_gmm(gmm, domain)
    world = eng.empty_world(domain, S)
    want, _ = _single_loop(eng, sc, np.asarray(phik), world, 1)
    ctrl = eng.controller
    bcost = [float(ctrl.step(_row(sc.state, i), x0[i], jnp.zeros(3), phik[i],
                             _row(world, i))[2].barrier_cost) for i in range(S)]
    _, u, diag = eng.replan(sc, phik, world)
    np.testing.assert_allclose(np.asarray(u), want["u"][0], atol=5e-5)
    np.testing.assert_allclose(np.asarray(diag.barrier_cost), bcost, rtol=1e-5, atol=1e-7)


def test_explore_matches_single_loop():
    """Engine.explore (on-device closed loop) == stepping each scenario
    through the single controller and the true kinematics, 3 ticks."""
    cfg, domain, x0, grids, gmm = _case("cart", S=8)
    eng = Engine(cfg)
    sc = eng.init_scenarios(x0)
    phik = eng.phik_from_gmm(gmm, domain)
    world = eng.prepare_world(grids)
    want, _ = _single_loop(eng, sc, np.asarray(phik), world, 3, plant=True)
    out = eng.explore(sc, phik, world, n_ticks=3)
    np.testing.assert_allclose(np.asarray(out.trajectory), want["x"], atol=5e-5)
    np.testing.assert_allclose(np.asarray(out.controls), want["u"], atol=5e-5)


def test_refresh_tick_matches_single():
    """replan_refresh (per-scenario masked refresh + batched solve) over a
    multi-tick closed batch == the single robot's masked target + step."""
    cfg, domain, x0, grids, gmm = _case("cart")
    eng = Engine(cfg.replace(shared_history_draw=True))
    sc = eng.init_scenarios(x0)
    world = eng.prepare_world(grids)
    phiks = [_single_phik(eng.config, gmm, domain, world, i) for i in range(len(x0))]
    want, _ = _single_loop(eng, sc, phiks, world, 3)
    got, _ = _batched_replan(eng, sc, None, world, 3, refresh=(gmm, domain))
    _assert_match(got, want)


def test_refresh_tick_sharded_matches_single():
    """The refresh tick on an 8-device scenario mesh == the single loop."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, domain, x0, grids, gmm = _case("cart", S=16)
    eng = Engine(cfg.replace(shared_maps=True, shared_history_draw=True),
                 mesh=make_scenario_mesh(8))
    sc = eng.init_scenarios(x0)
    world = eng.prepare_world(grids)
    phiks = [_single_phik(eng.config, gmm, domain, world, i) for i in range(len(x0))]
    want, _ = _single_loop(eng, sc, phiks, world, 2)
    got, _ = _batched_replan(eng, sc, None, world, 2, refresh=(gmm, domain))
    np.testing.assert_allclose(got["u"], want["u"], rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(got["c"], want["c"])


def test_refresh_tick_unmasked_empty_world():
    """Refresh tick on an obstacle-free world (free_mask None): the
    unmasked normalizer matches the single robot's unmasked target."""
    cfg, domain, x0, _, gmm = _case("cart")
    eng = Engine(cfg.replace(shared_history_draw=True, enable_safety=False,
                             shared_maps=True))
    S = x0.shape[0]
    sc = eng.init_scenarios(x0)
    world = eng.empty_world(domain, S)
    assert world.free_mask is None
    phiks = [_single_phik(eng.config, gmm, domain, world, i, masked=False)
             for i in range(S)]
    want, _ = _single_loop(eng, sc, phiks, world, 1)
    got, _ = _batched_replan(eng, sc, None, world, 1, refresh=(gmm, domain))
    np.testing.assert_allclose(got["u"], want["u"], atol=5e-5)
    np.testing.assert_allclose(got["m"], want["m"], rtol=1e-4)


@pytest.mark.parametrize("shared", [False, True])
def test_refresh_tick_degenerate_mask_fallback(shared):
    """A GMM with no mass on the free space (far outside the domain) falls
    back to uniform-over-mask on the batched refresh exactly like the
    single robot's normalize_phi — on the per-scenario-mask path and the
    shared-map fold."""
    cfg, domain, x0, grids, _ = _case("cart")
    S = x0.shape[0]
    far_gmm = target_ops.GaussianMixture.create(
        means=np.full((S, 2, 2), 80.0, np.float32),
        covs=np.tile((0.05 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32),
    )
    eng = Engine(cfg.replace(shared_history_draw=True, shared_maps=shared))
    sc = eng.init_scenarios(x0)
    world = eng.prepare_world(grids)
    phiks = [_single_phik(eng.config, far_gmm, domain, world, i) for i in range(S)]
    assert float(np.abs(np.asarray(phiks[0])[0, 0])) > 0.1  # real fallback
    want, _ = _single_loop(eng, sc, phiks, world, 1)
    got, _ = _batched_replan(eng, sc, None, world, 1, refresh=(far_gmm, domain))
    np.testing.assert_allclose(got["u"], want["u"], atol=5e-5)


def test_mixed_crash_and_free_scenarios_match_single():
    """Half the batch jammed against the wall (validation crash -> DWA),
    half far from it: codes, DWA decisions, feasibility and controls match
    the single step scenario by scenario."""
    S = 16
    cfg = default_config("cart").replace(num_basis=6, buffer_capacity=64)
    domain = Domain.create(0.0, 0.0, 3.0, 3.0)
    rng = np.random.default_rng(5)
    x0 = np.zeros((S, 3), np.float32)
    x0[:8, 0] = rng.uniform(0.4, 1.0, 8)  # far from the wall: no crashes
    x0[:8, 1] = rng.uniform(0.4, 1.0, 8)
    x0[8:, 0] = rng.uniform(1.0, 2.4, 8)  # jammed against the wall
    x0[8:, 1] = 1.45
    x0[:, 2] = rng.uniform(-np.pi, np.pi, S)
    data = np.zeros((60, 60), np.float32)
    data[28:32, 12:48] = 1.0
    grids = GridMap(
        data=jnp.broadcast_to(jnp.asarray(data), (S, 60, 60)),
        origin=jnp.zeros((S, 2), jnp.float32),
        resolution=jnp.full((S,), 0.05, jnp.float32),
    )
    gmm = target_ops.GaussianMixture.create(
        means=rng.uniform(0.5, 2.5, (S, 2, 2)).astype(np.float32),
        covs=np.tile((0.2 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32),
    )
    eng = Engine(cfg)
    sc = eng.init_scenarios(x0)
    phik = eng.phik_from_gmm(gmm, domain)
    world = eng.prepare_world(grids)
    want, _ = _single_loop(eng, sc, np.asarray(phik), world, 1)
    got, _ = _batched_replan(eng, sc, phik, world, 1)
    assert got["d"].any() and not got["d"].all(), "need mixed crash/no-crash scenarios"
    _assert_match(got, want, atol=1e-6)
    np.testing.assert_array_equal(got["f"], want["f"])


def test_orbit_guard_matches_single():
    """The orbit guard (warm-start reset on closed orbits) fires for the
    same scenarios, with the same controls, batched and alone. Scenario 0
    is doctored into a saturated orbit (full buffer at one spot, curled U);
    the others keep a straight history."""
    cfg, domain, x0, grids, gmm = _case("cart", S=8)
    cfg = cfg.replace(shared_history_draw=True)
    eng = Engine(cfg)
    sc = eng.init_scenarios(x0)
    cap = cfg.buffer_capacity
    states = np.zeros((8, 2, cap), np.float32)
    states[0] = x0[0, :2][:, None]
    for s in range(1, 8):
        states[s, 0] = x0[s, 0] + np.linspace(-1.0, 0.0, cap)
        states[s, 1] = x0[s, 1]
    buf = sc.state.buffer._replace(
        states=jnp.asarray(states),
        cursor=jnp.zeros((8,), jnp.int32),
        count=jnp.full((8,), cap, jnp.int32),
    )
    U = jnp.asarray(
        np.tile(np.array([[1.0, -1.0]], np.float32), (cfg.horizon, 1))
    )[None].repeat(8, 0)
    sc = sc._replace(state=sc.state._replace(buffer=buf, U=U))
    phik = eng.phik_from_gmm(gmm, domain)
    world = eng.prepare_world(grids)
    want, _ = _single_loop(eng, sc, np.asarray(phik), world, 1)
    got, _ = _batched_replan(eng, sc, phik, world, 1)
    assert got["o"][0][0] and not got["o"][0][1:].any()
    _assert_match(got, want)
