"""Host-node, native-runtime, checkpoint, metrics, divergence-guard tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ergodic_exploration_tpu import native
from ergodic_exploration_tpu.config import default_config
from ergodic_exploration_tpu.controller import ErgodicController, World
from ergodic_exploration_tpu.engine import Engine
from ergodic_exploration_tpu.grid import Domain, GridMap
from ergodic_exploration_tpu.node import ExplorationNode
from ergodic_exploration_tpu.ops import target
from ergodic_exploration_tpu.ops.distance import DistanceField
from ergodic_exploration_tpu.ops.integrator import constant_twist_poses
from ergodic_exploration_tpu.utils.metrics import MetricsLogger, summarize


def _cfg(**kw):
    return default_config("cart").replace(
        num_basis=6, horizon=8, buffer_capacity=32, grid_samples=(20, 20), **kw
    )


# ---------------------------------------------------------------- native


def test_native_edt_matches_jax():
    if not native.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(3)
    occ = (rng.random((40, 50)) < 0.03).astype(np.float32)
    g = GridMap.create(occ, 0, 0, 0.1)
    ref = DistanceField.from_grid(g, 0.65)
    d, gr = native.edt2d(occ, 0.65, 0.1)
    np.testing.assert_allclose(d, np.asarray(ref.dist), atol=1e-5)
    np.testing.assert_allclose(gr, np.asarray(ref.grad), atol=1e-5)


def test_native_batch_and_ingest():
    if not native.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(0)
    occ = (rng.random((5, 30, 30)) < 0.05).astype(np.float32)
    d, g = native.edt2d_batch(occ, 0.65, 0.05, n_threads=3)
    d0, g0 = native.edt2d(occ[2], 0.65, 0.05)
    np.testing.assert_array_equal(d[2], d0)
    raw = np.array([[-1, 0], [100, 37]], dtype=np.int8)
    np.testing.assert_allclose(native.ros_ingest(raw), [[-1.0, 0.0], [1.0, 0.37]])


# ---------------------------------------------------------------- node


def test_node_mi_exploration_loop():
    """ROS-shaped flow: map callback -> odom callback -> ticks -> twists."""
    cfg = _cfg()
    node = ExplorationNode(cfg, target="mi")
    raw = np.full((40, 40), -1, dtype=np.int8)  # all unknown
    raw[:10, :] = 0  # a known-free strip
    node.on_map(raw, 0.0, 0.0, 0.05)
    node.on_odom([1.0, 0.4, 0.3])

    def plant(tw):
        x = node._pose
        X = constant_twist_poses(x, jnp.asarray(tw), jnp.array([0.1]))
        return np.asarray(X[0]), tw

    node.run(rate_hz=1000.0, n_steps=15, plant=plant)
    assert node.ticks == 15
    path = node.predicted_path()
    assert path.shape == (cfg.horizon + 1, 3)
    assert np.all(np.isfinite(path))


def test_node_gmm_target_and_map_update_changes_phik():
    cfg = _cfg()
    gmm = target.GaussianMixture.create([[1.5, 1.5]], np.array([[[0.1, 0], [0, 0.1]]]))
    node = ExplorationNode(cfg, target=gmm, domain=Domain.create(0, 0, 2, 2))
    node.on_odom([0.5, 0.5, 0.0])
    tw, diag = node.step()
    assert tw.shape == (3,)
    phik_before = np.asarray(node._phik)
    # a map arrives: occupied block masks part of the free space
    raw = np.zeros((40, 40), dtype=np.int8)
    raw[20:30, 20:30] = 100
    node.on_map(raw, 0.0, 0.0, 0.05)
    node.step()
    assert not np.allclose(phik_before, np.asarray(node._phik))


# ---------------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip(tmp_path):
    cfg = _cfg()
    eng = Engine(cfg)
    S = 3
    x0 = np.array([[0.3, 0.3, 0.0], [1.0, 0.4, 1.0], [0.5, 1.5, -2.0]])
    sc = eng.init_scenarios(x0)
    gmm = target.GaussianMixture.create(
        means=np.tile(np.array([[1.4, 1.4]]), (S, 1, 1))[:, :, :],
        covs=np.tile(np.array([[[0.05, 0.0], [0.0, 0.05]]])[None], (S, 1, 1, 1)),
        weights=np.ones((S, 1)),
    )
    dom = Domain.create(0, 0, 2, 2)
    phik = eng.phik_from_gmm(gmm, dom)
    world = eng.empty_world(dom, S)
    out = eng.explore(sc, phik, world, 10)

    p = str(tmp_path / "ck.npz")
    eng.save_checkpoint(p, out.scenarios)
    sc2 = eng.load_checkpoint(p)
    for a, b in zip(jax.tree.leaves(out.scenarios), jax.tree.leaves(sc2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resumed state keeps exploring deterministically
    out_a = eng.explore(out.scenarios, phik, world, 5)
    out_b = eng.explore(sc2, phik, world, 5)
    np.testing.assert_allclose(
        np.asarray(out_a.trajectory), np.asarray(out_b.trajectory), atol=1e-6
    )


# ---------------------------------------------------------------- metrics


def test_metrics_summarize_and_logger(tmp_path):
    cfg = _cfg(enable_safety=False)
    eng = Engine(cfg)
    S = 2
    x0 = np.array([[0.3, 0.3, 0.0], [1.0, 0.4, 1.0]])
    gmm = target.GaussianMixture.create(
        means=np.tile(np.array([[1.4, 1.4]]), (S, 1, 1)),
        covs=np.tile(np.array([[[0.05, 0.0], [0.0, 0.05]]])[None], (S, 1, 1, 1)),
        weights=np.ones((S, 1)),
    )
    dom = Domain.create(0, 0, 2, 2)
    out = eng.explore(eng.init_scenarios(x0), eng.phik_from_gmm(gmm, dom),
                      eng.empty_world(dom, S), 6)
    rec = summarize(out.diag, elapsed_s=1.0)
    assert rec["solves"] == 12 and rec["solves_per_s"] == 12.0
    assert 0.0 <= rec["dwa_fallback_rate"] <= 1.0
    log = MetricsLogger(str(tmp_path / "m.jsonl"))
    log.log(out.diag, step=0)
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 1


# ---------------------------------------------------------------- guard


def test_divergence_guard_resets_scenario():
    cfg = _cfg(enable_safety=False, history="accumulate")
    ctrl = ErgodicController(cfg)
    world = World.empty(Domain.create(0, 0, 2, 2))
    K = cfg.num_basis
    phik_bad = jnp.full((K, K), jnp.nan, dtype=jnp.float32)  # poisoned target
    st = ctrl.init_state()
    st2, u, diag = jax.jit(ctrl.step)(
        st, jnp.array([0.5, 0.5, 0.0]), jnp.zeros(3), phik_bad, world
    )
    assert bool(diag.diverged)
    np.testing.assert_array_equal(np.asarray(u), 0.0)
    np.testing.assert_array_equal(np.asarray(st2.U), 0.0)


def test_node_pipelined_twists_are_unpipelined_shifted_by_one():
    """VERDICT r2 item 6: one-tick-latency pipelining — step() returns the
    PREVIOUS solve's twist (zeros first), with identical solve semantics;
    flush() drains the tail."""
    gmm = target.GaussianMixture.create(
        means=np.array([[1.5, 1.5]], np.float32), covs=0.1 * np.eye(2)[None])
    poses = [[0.5, 0.5, 0.3], [0.55, 0.52, 0.35], [0.6, 0.55, 0.4],
             [0.66, 0.6, 0.42], [0.7, 0.66, 0.45]]

    def run(pipeline):
        node = ExplorationNode(_cfg(), target=gmm,
                               domain=Domain.create(0, 0, 2, 2),
                               use_native=False, pipeline=pipeline)
        tws, diags = [], []
        for p in poses:  # identical odometry stream for both modes
            node.on_odom(p)
            tw, diag = node.step()
            tws.append(tw)
            diags.append(diag)
        if pipeline:
            tail = node.flush()
            assert tail is not None
            tws.append(tail[0])
            diags.append(tail[1])
        return np.stack(tws), diags

    tw_ref, d_ref = run(False)
    tw_pipe, d_pipe = run(True)
    np.testing.assert_array_equal(tw_pipe[0], 0.0)  # one-tick startup latency
    assert d_pipe[0] is None
    np.testing.assert_allclose(tw_pipe[1:], tw_ref, atol=1e-6)
    # diagnostics shift with the twists and arrive as host arrays
    np.testing.assert_allclose(
        [float(d.ergodic_metric) for d in d_pipe[1:]],
        [float(d.ergodic_metric) for d in d_ref], rtol=1e-6)
