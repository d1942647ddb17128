"""The batched dense MI refresh (shared domain; what replan_refresh_mi runs)
== the per-scenario separable path, across sensor radii and with the
frontier mask on and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ergodic_exploration_tpu.config import default_config
from ergodic_exploration_tpu.engine import Engine
from ergodic_exploration_tpu.grid import Domain, GridMap

DOM = Domain.create(0.0, 0.0, 2.0, 2.0)


def _belief(S=8, h=40, w=40):
    rng = np.random.default_rng(7)
    data = np.full((S, h, w), -1.0, dtype=np.float32)
    data[:, :, : w // 2] = 0.0  # observed-free half
    data[:, 10:14, 5:15] = 1.0  # a wall in the known half
    for s in range(S):  # scenario-varying observations, a noisy band
        r0 = rng.integers(0, h - 6)
        data[s, r0:r0 + 6, w // 2:w // 2 + 8] = rng.uniform(
            0.0, 1.0, (6, 8)).astype(np.float32)
    data[S - 1] = 1.0  # fully occupied -> degenerate fallback
    return GridMap(jnp.asarray(data), jnp.zeros((S, 2), jnp.float32),
                   jnp.full((S,), 0.05, jnp.float32))


@pytest.mark.parametrize("frontier", [0, 3])
@pytest.mark.parametrize("radius", [0, 2, 3])
def test_dense_mi_refresh_matches_per_scenario(radius, frontier):
    grids = _belief()
    # 23x23 samples over 40 cells: no lattice point lands on an exact
    # half-cell boundary, where nearest-cell rounding is ulp-sensitive
    cfg = default_config("cart").replace(num_basis=6, grid_samples=(23, 23),
                                         mi_frontier_cells=frontier)
    eng = Engine(cfg)
    dense = jax.jit(lambda g: eng._phik_grid_batch_dense_fn(g, DOM, radius))(grids)
    one = jax.jit(jax.vmap(lambda g: eng._phik_grid_one(g, radius)))(grids)
    np.testing.assert_allclose(np.asarray(dense), np.asarray(one), rtol=2e-4, atol=2e-5)


def test_mi_tick_matches_per_scenario_refresh():
    """replan_refresh_mi on the shared domain (dense refresh) == replan with
    the per-scenario separable phi_k, through the full tick."""
    S = 8
    grids = _belief(S)
    cfg = default_config("cart").replace(num_basis=6, grid_samples=(23, 23),
                                         buffer_capacity=64)
    eng = Engine(cfg)
    rng = np.random.default_rng(3)
    x0 = np.concatenate(
        [rng.uniform(0.3, 1.7, (S, 2)), rng.uniform(-3, 3, (S, 1))], axis=1
    ).astype(np.float32)
    world = eng.prepare_world(grids)
    phik = jax.jit(jax.vmap(lambda g: eng._phik_grid_one(g, 3)))(grids)
    _, u_ref, d_ref = eng.replan(eng.init_scenarios(x0), phik, world)
    _, u, d = eng.replan_refresh_mi(eng.init_scenarios(x0), grids, world,
                                    sensor_radius_cells=3, domain=DOM)
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref), rtol=2e-4, atol=5e-5)
    np.testing.assert_array_equal(np.asarray(d.collision_code),
                                  np.asarray(d_ref.collision_code))
