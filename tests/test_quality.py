"""Closed-loop exploration QUALITY pins (round 5).

The throughput benches can't see a stationary or orbit-trapped controller;
these tests pin the behaviors that round 5's plateau diagnosis fixed
(VERDICT r4 items 1 and 4):

- the orbit guard detects closed-orbit traps and leaves healthy motion alone;
- the frontier mask concentrates the MI target on reachable frontier cells;
- at PURE DEFAULTS the config-4 closed loop explores at a reference-plausible
  rate (coverage slope + mean speed floors) on a multi-room map, so a
  regression to a stationary/orbiting controller can never pass CI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ergodic_exploration_tpu.config import default_config
from ergodic_exploration_tpu.controller import orbit_guard
from ergodic_exploration_tpu.engine import Engine
from ergodic_exploration_tpu.grid import GridMap
from ergodic_exploration_tpu.ops import target as target_ops
from ergodic_exploration_tpu.ops.buffer import RingBuffer


# ---------------------------------------------------------------------------
# orbit guard (controller.orbit_guard)
# ---------------------------------------------------------------------------


def _buffer_from_path(path_xy: np.ndarray, capacity: int = 1024) -> RingBuffer:
    n = path_xy.shape[0]
    states = np.zeros((2, capacity), np.float32)
    states[:, :n] = path_xy.T
    return RingBuffer(
        states=jnp.asarray(states),
        cursor=jnp.asarray(n % capacity, jnp.int32),
        count=jnp.asarray(n, jnp.int32),
    )


def test_orbit_guard_fires_on_closed_orbit():
    cfg = default_config("omni")
    ang = np.linspace(0.0, 24 * np.pi, 200)
    circle = np.stack([1 + 0.05 * np.cos(ang), 1 + 0.05 * np.sin(ang)], 1)
    buf = _buffer_from_path(circle.astype(np.float32))
    assert bool(orbit_guard(cfg, buf, jnp.asarray(circle[-1], jnp.float32)))


def test_orbit_guard_ignores_healthy_sweep():
    cfg = default_config("omni")
    line = np.stack([np.linspace(0, 2, 200), np.full(200, 1.0)], 1)
    buf = _buffer_from_path(line.astype(np.float32))
    assert not bool(orbit_guard(cfg, buf, jnp.asarray([2.0, 1.0])))


def test_orbit_guard_waits_for_window_and_can_disable():
    cfg = default_config("omni")
    ang = np.linspace(0.0, 6 * np.pi, 40)  # only 40 ticks of history
    circle = np.stack([1 + 0.05 * np.cos(ang), 1 + 0.05 * np.sin(ang)], 1)
    buf = _buffer_from_path(circle.astype(np.float32))
    assert not bool(orbit_guard(cfg, buf, jnp.asarray(circle[-1], jnp.float32)))
    big = _buffer_from_path(
        np.tile(circle, (6, 1)).astype(np.float32))  # 240 >= window
    assert bool(orbit_guard(cfg, big, jnp.asarray(circle[-1], jnp.float32)))
    off = cfg.replace(orbit_window=0)
    assert not bool(orbit_guard(off, big, jnp.asarray(circle[-1], jnp.float32)))


# ---------------------------------------------------------------------------
# frontier adjacency mask (target.frontier_adjacency; SURVEY.md A.3)
# ---------------------------------------------------------------------------


def test_frontier_mask_selects_known_free_adjacent_cells():
    data = np.full((20, 20), -1.0, np.float32)
    data[:, :8] = 0.0  # known free strip
    data[:, 8] = 1.0  # wall between known and unknown
    g = GridMap(jnp.asarray(data), jnp.zeros(2, jnp.float32),
                jnp.asarray(0.05, jnp.float32))
    adj = np.asarray(target_ops.frontier_adjacency(g, 2))
    assert adj[5, 5] == 1.0  # known free: trivially adjacent to itself
    assert adj[5, 9] == 1.0  # unknown within 2 cells of known free
    assert adj[5, 15] == 0.0  # deep unknown: not adjacent
    info = np.asarray(target_ops.mutual_information_map(g, frontier_cells=2))
    assert info[5, 8] == 0.0  # occupied stays zero even when adjacent
    assert info[5, 9] > 0.0  # frontier unknown keeps entropy mass
    assert info[5, 15] == 0.0  # deep unknown masked out
    # legacy behavior unchanged with frontier_cells=0
    info0 = np.asarray(target_ops.mutual_information_map(g))
    assert info0[5, 15] > 0.0


def test_frontier_phik_paths_agree():
    """separable == dense == gather oracle with the frontier mask on."""
    from ergodic_exploration_tpu.grid import Domain
    from ergodic_exploration_tpu.ops import basis

    S, h, w = 3, 40, 40
    rng = np.random.default_rng(3)
    data = np.full((S, h, w), -1.0, np.float32)
    data[:, :, :17] = 0.0
    data[:, 10:13, 5:15] = 1.0
    for s in range(S):
        r0 = int(rng.integers(0, h - 5))
        data[s, r0:r0 + 5, 17:24] = rng.uniform(0, 1, (5, 7)).astype(np.float32)
    grids = GridMap(jnp.asarray(data), jnp.zeros((S, 2), jnp.float32),
                    jnp.full((S,), 0.05, jnp.float32))
    dom = Domain.create(0.0, 0.0, 2.0, 2.0)
    cfg = default_config("cart").replace(num_basis=6, grid_samples=(23, 23),
                                         mi_frontier_cells=2)
    eng = Engine(cfg)
    p_sep = np.asarray(eng.phik_from_grid(grids))
    p_den = np.asarray(eng.phik_from_grid(grids, domain=dom))
    np.testing.assert_allclose(p_sep, p_den, atol=2e-5)
    pts = dom.sample_lattice((23, 23))
    tbl = basis.tables(pts, 6, dom)
    hk = basis.hk_norm(6, dom.lengths)
    for s in range(S):
        g = jax.tree.map(lambda a: a[s], grids)
        vals = target_ops.mi_target_values(g, pts, frontier_cells=2)
        ck = np.asarray(basis.coefficients(tbl, vals, hk))
        np.testing.assert_allclose(ck, p_sep[s], atol=2e-5)


# ---------------------------------------------------------------------------
# closed-loop exploration rate at PURE DEFAULTS (VERDICT r4 item 4)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_default_config_explores_multiroom_map():
    """The default omni config must actually explore: on the quality map
    (walls + doorways + pillar), S=4 robots for 400 ticks at DEFAULTS must
    (a) move at >= 0.04 m/s mean speed, (b) reveal >= 25% of the building,
    and (c) keep improving coverage late in the run (not plateau at the
    start-room ceiling). Round-4's shipped defaults fail all three."""
    from tools.quality import build_truth

    S, n_ticks, refresh_every = 4, 400, 10
    cfg = default_config("omni")
    engine = Engine(cfg)
    truth = build_truth(S)
    x0 = np.asarray([
        [1.7, 1.1, 0.0], [1.2, 3.0, 1.2], [4.2, 1.0, 2.5], [2.6, 2.9, -1.0],
    ], np.float32)
    sc = engine.init_scenarios(x0)

    from ergodic_exploration_tpu.ops import sensor

    belief = truth._replace(data=jnp.full_like(truth.data, -1.0))
    res = float(jnp.min(truth.resolution))
    win = sensor.raycast_window_cells(1.5, res)
    reveal = jax.jit(jax.vmap(lambda b, t, x: sensor.reveal_raycast(
        b, t, x, 1.5, win, occupied_threshold=cfg.occupied_threshold)))

    covs, trajs = [], []
    for _ in range(n_ticks // refresh_every):
        belief = reveal(belief, truth, sc.x)
        phik = engine.phik_from_grid(belief)
        world = engine.prepare_world(belief)
        out = engine.explore(sc, phik, world, refresh_every)
        sc = out.scenarios
        trajs.append(np.asarray(out.trajectory))
        covs.append(float(sensor.fraction_known(belief)))

    traj = np.concatenate(trajs)  # (n_ticks, S, 3)
    speed = np.linalg.norm(np.diff(traj[..., :2], axis=0), axis=-1) / cfg.dt
    assert speed.mean() > 0.04, f"stationary fleet: mean speed {speed.mean():.3f}"
    assert covs[-1] > 0.25, f"no exploration: coverage {covs[-1]:.3f}"
    # still discovering in the second half (regression = early plateau)
    assert covs[-1] - covs[len(covs) // 2] > 0.02, (
        f"coverage plateaued: {covs[len(covs) // 2]:.3f} -> {covs[-1]:.3f}")


def test_frontier_respects_occupied_threshold():
    """The MI/frontier target must use the CONFIG's occupied_threshold, not
    the 0.65 default (round-5 review finding): cells between the two
    thresholds are obstacles to the safety layer and must carry no target
    mass or frontier seeding."""
    data = np.full((20, 20), -1.0, np.float32)
    data[:, :6] = 0.0
    data[:, 6:9] = 0.55  # occupied at threshold 0.5, free at 0.65
    g = GridMap(jnp.asarray(data), jnp.zeros(2, jnp.float32),
                jnp.asarray(0.05, jnp.float32))
    info = np.asarray(target_ops.mutual_information_map(
        g, frontier_cells=2, occupied_threshold=0.5))
    assert (info[:, 6:9] == 0.0).all()  # no mass on 0.55 cells
    # unknown cells adjacent ONLY to the 0.55 band must not be seeded
    assert (info[:, 10:] == 0.0).all()
    # engine dense path honors the config value the same way
    from ergodic_exploration_tpu.grid import Domain

    grids = GridMap(jnp.asarray(data)[None], jnp.zeros((1, 2), jnp.float32),
                    jnp.full((1,), 0.05, jnp.float32))
    cfg = default_config("cart").replace(
        num_basis=5, grid_samples=(20, 20), occupied_threshold=0.5,
        mi_frontier_cells=2)
    eng = Engine(cfg)
    dom = Domain.create(0.0, 0.0, 1.0, 1.0)
    p_den = np.asarray(eng.phik_from_grid(grids, domain=dom))[0]
    p_sep = np.asarray(eng.phik_from_grid(grids))[0]
    np.testing.assert_allclose(p_den, p_sep, atol=2e-5)
    from ergodic_exploration_tpu.ops import basis

    pts = dom.sample_lattice((20, 20))
    vals = target_ops.mi_target_values(g, pts, frontier_cells=2,
                                       occupied_threshold=0.5)
    ck = np.asarray(basis.coefficients(
        basis.tables(pts, 5, dom), vals, basis.hk_norm(5, dom.lengths)))
    np.testing.assert_allclose(ck, p_sep, atol=2e-5)
