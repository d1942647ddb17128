"""Smoke run of the engine's main paths on the GPU, at the flagship widths.

    python chip_smoke.py          # one card: phases (a)-(h) below
    python chip_smoke.py --four   # four cards: the scenario mesh and the
                                  # sample-sharded refresh, vs one card

One process drives the card. Every phase checks its outputs; a phase that
fails is reported and the run exits non-zero without the final line. With
no GPU it exits non-zero before any phase. The last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases (one card; S = 4096 scenarios, K = 10, H = 20, 100x100 lattice):
  (a) device: platform, kind, count, and the card's name and power limit;
  (b) compile cache on; first-call (compile) seconds per entry point;
  (d) Engine.replan_refresh on the bench's wall-and-pillar map; the first
      tick's controls for 8 scenarios vs the NumPy oracle (tests/oracle.py);
  (e) Engine.replan_refresh_mi on the bench's partly-unknown belief; the
      dense-path phi_k for 8 scenarios vs the per-scenario path;
  (f) Engine.explore, 20 ticks, cart and omni;
  (g) Engine.explore_mapping_fused at S = 256 on the multi-room map;
  (h) ExplorationNode (config/omni.yaml, MI target), 50 ticks.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

PARITY_RMS = 1e-3  # BASELINE parity budget on controls / phi_k
# Share of scenarios allowed past the budget between the mesh and one card:
# the same program partitioned differently may take other GEMM algorithms,
# and a last-bit difference can flip one scenario's DWA choice.
MESH_FLIP_SHARE = 1e-3


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


class Phases:
    """Runs named phases; records failures instead of stopping, so one run
    reports every broken phase. ``failed`` decides the exit code."""

    def __init__(self):
        self.failed = []
        self.setup_s = {}

    def run(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            log(f"   FAILED: {name}")
        log(f"   ({time.perf_counter() - t0:.1f} s)")

    def first_call(self, name, fn):
        """Call ``fn`` once (compiling it), record the seconds as set-up."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        self.setup_s[name] = time.perf_counter() - t0
        log(f"   setup {name}: {self.setup_s[name]:.2f} s (first call, compile included)")
        return out


def ms_stats(seconds):
    s = np.asarray(seconds) * 1e3
    return f"p50 {np.percentile(s, 50):.3f} ms, p99 {np.percentile(s, 99):.3f} ms (n={s.size})"


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def _oracle_controls(engine, x0, phik):
    """First-tick u0 from tests/oracle.py (U = 0 warm start, empty history,
    boundary barrier; valid where the obstacle barrier is inactive)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    cfg = engine.config
    r, b = cfg.cart.wheel_radius, cfg.cart.wheel_base

    def A_fn(x, u):
        v = 0.5 * r * (u[0] + u[1])
        A = np.zeros((3, 3))
        A[0, 2] = -v * np.sin(x[2])
        A[1, 2] = v * np.cos(x[2])
        return A

    def B_fn(x, u):
        c, s = np.cos(x[2]), np.sin(x[2])
        return np.array([[0.5 * r * c, 0.5 * r * c],
                         [0.5 * r * s, 0.5 * r * s], [-r / b, r / b]])

    U0 = np.zeros((cfg.horizon, cfg.nu))
    U_new, _, _ = oracle.ergodic_step(
        lambda x, u: oracle.cart_f(x, u, r, b), A_fn, B_fn, x0, U0, cfg.dt,
        phik, cfg.num_basis, [0.0, 0.0], [5.0, 5.0], [], cfg.ergodic_weight,
        cfg.barrier_weight, cfg.barrier_boundary_weight, cfg.barrier_eps,
        cfg.r_diag, cfg.u_min, cfg.u_max)
    return U_new[0]


def phase_replan_refresh(ph, S=4096, n=20):
    """(d) the flagship tick, with oracle parity on 8 scenarios."""
    import jax

    import bench

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    engine, sc, gmm, domain, world = bench.build_case(S)
    cfg = engine.config
    x0 = np.asarray(sc.x)
    sc1, u, diag = ph.first_call(
        "replan_refresh", lambda: engine.replan_refresh(sc, gmm, domain, world))
    u = np.asarray(u)
    check(u.shape == (S, cfg.nu) and np.isfinite(u).all(), "controls")

    # oracle parity where the obstacle barrier and DWA cannot act: a start
    # clearance of 0.8 m exceeds boundary_radius + d_safe plus the
    # validation horizon's reach
    clear = np.asarray(jax.vmap(lambda w, p: w.dist.query(p)[0])(world, sc1.x[:, :2]))
    idx = np.flatnonzero(clear > 0.8)[:8]
    check(idx.size == 8, "fewer than 8 clear starts")
    check(not np.asarray(diag.dwa_active)[idx].any(), "DWA acted on a clear start")
    # the controls use the tick's own phi_k; the refresh itself is checked
    # against the oracle on 2 of the 8 (its pure-Python loops take seconds
    # per scenario)
    phik_dev = np.asarray(engine.phik_from_gmm(gmm, domain, world))
    pts = np.asarray(domain.sample_lattice(cfg.grid_samples), np.float64)
    mask = np.asarray(world.free_mask)
    gm = jax.tree.map(np.asarray, gmm)
    phik_err = 0.0
    for i in idx[:2]:
        phi = oracle.gmm_phi(pts, gm.means[i], gm.covs[i], gm.weights[i]) * mask[i]
        phik = oracle.spatial_coefficients(phi, pts, cfg.num_basis, [0.0, 0.0], [5.0, 5.0])
        phik_err = max(phik_err, float(np.abs(phik_dev[i] - phik).max()))
    errs = [u[i] - _oracle_controls(engine, x0[i].astype(np.float64), phik_dev[i])
            for i in idx]
    rms = float(np.sqrt(np.mean(np.square(errs))))
    log(f"   oracle parity, scenarios {idx.tolist()}: controls RMS error {rms:.3e}; "
        f"phi_k max abs error {phik_err:.3e} (2 scenarios); budget {PARITY_RMS:g}")
    check(rms <= PARITY_RMS, f"oracle RMS {rms:.3e} > {PARITY_RMS:g}")
    check(phik_err <= PARITY_RMS, f"oracle phi_k error {phik_err:.3e}")

    state = {"sc": sc1}

    def tick():
        state["sc"], uu, _ = engine.replan_refresh(state["sc"], gmm, domain, world)
        return uu

    times = bench.time_calls(tick, n)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"   replan_refresh S={S}: {ms_stats(times)}; peak_bytes_in_use {peak}")


def phase_replan_refresh_mi(ph, S=4096, n=10, radius=3):
    """(e) the MI tick; dense-path phi_k vs the per-scenario path."""
    import jax

    import bench

    engine, sc, _, domain, _ = bench.build_case(S)
    grids = bench.batched_grids(bench.bench_belief(), S)
    world = engine.prepare_world(grids)
    sc1, u, diag = ph.first_call("replan_refresh_mi", lambda: engine.replan_refresh_mi(
        sc, grids, world, radius, domain=domain))
    u = np.asarray(u)
    check(u.shape == (S, engine.config.nu) and np.isfinite(u).all(), "MI controls")
    dense = np.asarray(engine.phik_from_grid(grids, radius, domain=domain))[:8]
    g8 = jax.tree.map(lambda a: a[:8], grids)
    one = np.asarray(jax.jit(jax.vmap(lambda g: engine._phik_grid_one(g, radius)))(g8))
    err = float(np.abs(dense - one).max())
    log(f"   MI phi_k, dense vs per-scenario path (8 scenarios): max abs {err:.3e} "
        f"(budget {PARITY_RMS:g})")
    check(err <= PARITY_RMS, f"MI phi_k error {err:.3e}")
    state = {"sc": sc1}

    def tick():
        state["sc"], uu, _ = engine.replan_refresh_mi(
            state["sc"], grids, world, radius, domain=domain)
        return uu

    log(f"   replan_refresh_mi S={S}: {ms_stats(bench.time_calls(tick, n))}")


def phase_explore(ph, S=4096, n_ticks=20):
    """(f) closed loop on the device, cart then omni."""
    import bench

    for model in ("cart", "omni"):
        engine, sc, gmm, domain, world = bench.build_case(S, model=model)
        phik = engine.phik_from_gmm(gmm, domain, world)
        out = ph.first_call(f"explore_{model}",
                            lambda: engine.explore(sc, phik, world, n_ticks))
        traj = np.asarray(out.trajectory)
        ctrl = np.asarray(out.controls)
        diverged = int(np.asarray(out.diag.diverged).sum())
        dwa = float(np.asarray(out.diag.dwa_active).mean())
        moved = float(np.linalg.norm(traj[-1, :, :2] - traj[0, :, :2], axis=-1).mean())
        log(f"   {model}: {n_ticks} ticks x {S}; mean displacement {moved:.3f} m, "
            f"DWA share {dwa:.3f}, diverged {diverged}")
        check(np.isfinite(traj).all() and np.isfinite(ctrl).all(), f"{model} non-finite")
        check(diverged == 0, f"{model}: {diverged} divergence flags")


def phase_mapping(ph, S=256, n_refreshes=6, refresh_every=10):
    """(g) sense -> map -> MI -> plan closed loop, one jitted scan."""
    from ergodic_exploration_tpu.config import default_config
    from ergodic_exploration_tpu.engine import Engine
    from tools.quality import build_truth, spawn_poses

    cfg = default_config("omni")
    engine = Engine(cfg)
    truth = build_truth(S)
    sc = engine.init_scenarios(spawn_poses(truth, cfg, S))
    out = ph.first_call("explore_mapping_fused", lambda: engine.explore_mapping_fused(
        sc, truth, n_refreshes=n_refreshes, refresh_every=refresh_every))
    cov = np.asarray(out[2]).reshape(n_refreshes, -1).mean(axis=1)
    log(f"   coverage per refresh: {np.round(cov, 4).tolist()}")
    check(np.isfinite(np.asarray(out[3])).all(), "mapping trajectory non-finite")
    check(cov[-1] > cov[0], "coverage did not rise")


def phase_node(ph, n_ticks=50):
    """(h) the single-robot node on the omni config, MI target."""
    import jax.numpy as jnp

    from ergodic_exploration_tpu.config import load_yaml_config
    from ergodic_exploration_tpu.node import ExplorationNode
    from ergodic_exploration_tpu.ops.integrator import constant_twist_poses

    node = ExplorationNode(load_yaml_config(os.path.join(ROOT, "config", "omni.yaml")),
                           target="mi")
    raw = np.full((100, 100), -1, np.int8)  # 5 m square, unknown
    raw[:, :40] = 0  # known free up to x = 2.0 m: the frontier
    node.on_map(raw, 0.0, 0.0, 0.05)
    pose = np.array([1.0, 2.5, 0.0], np.float32)
    node.on_odom(pose)
    times = []
    x_start = float(pose[0])
    for _ in range(n_ticks):
        t0 = time.perf_counter()
        tw, _ = node.step()
        times.append(time.perf_counter() - t0)
        pose = np.asarray(constant_twist_poses(jnp.asarray(pose), jnp.asarray(tw),
                                               jnp.array([0.1]))[0])
        node.on_odom(pose, tw)
    ph.setup_s["node_step"] = times[0]
    log(f"   node step: {ms_stats(times[1:])}; first step {times[0]:.2f} s")
    log(f"   pose {np.round(pose, 3).tolist()}: moved {pose[0] - x_start:+.3f} m toward "
        f"the frontier at x = 2.0 m")
    check(np.isfinite(pose).all(), "node pose non-finite")
    check(pose[0] - x_start > 0.02, "node did not move toward the frontier")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_four(ph, S_per=4096, n_ticks=5):
    """Scenario mesh (4 cards) vs one card; sample-sharded refresh on a
    (2, 2) mesh vs the unsharded refresh."""
    import bench
    from ergodic_exploration_tpu.engine import make_mesh, make_scenario_mesh

    S = 4 * S_per
    mesh = make_scenario_mesh(4)
    outs = {}
    for name, m in (("mesh", mesh), ("one", None)):
        engine, sc, gmm, domain, world = bench.build_case(S, mesh=m)
        sc1, u, _ = ph.first_call(f"replan_refresh_{name}",
                                  lambda: engine.replan_refresh(sc, gmm, domain, world))
        phik = engine.phik_from_gmm(gmm, domain, world)
        out = ph.first_call(f"explore_{name}",
                            lambda: engine.explore(sc1, phik, world, n_ticks))
        if m is not None:
            for what, arr in (("controls", u), ("explore state", out.scenarios.x)):
                n_dev = len(arr.sharding.device_set)
                check(n_dev == 4, f"{what} on {n_dev} devices, not 4")
        outs[name] = (np.asarray(u), np.asarray(out.trajectory))
    du = np.abs(outs["mesh"][0] - outs["one"][0]).max(axis=-1)  # (S,)
    dx = np.abs(outs["mesh"][1] - outs["one"][1]).max(axis=(0, 2))  # (S,)
    share = float(np.mean((du > PARITY_RMS) | (dx > PARITY_RMS)))
    log(f"   S={S} on 4 cards vs 1: replan_refresh controls max abs diff {du.max():.3e}; "
        f"explore({n_ticks}) trajectory max abs diff {dx.max():.3e}; share of scenarios "
        f"past {PARITY_RMS:g}: {share:.2e} (allowed {MESH_FLIP_SHARE:g})")
    check(share <= MESH_FLIP_SHARE, "mesh vs one card")

    engine_1, _, gmm, domain, world = bench.build_case(S_per)
    engine_m, *_ = bench.build_case(8, mesh=make_mesh(2, 2))
    for name, mask in (("unmasked", None), ("masked", world.free_mask)):
        ref = np.asarray(engine_1.phik_from_gmm(gmm, domain, mask))
        got = engine_m.phik_from_gmm(gmm, domain, mask)
        n_dev = len(got.sharding.device_set)
        err = float(np.abs(np.asarray(got) - ref).max())
        log(f"   phik_from_gmm {name} on a (2, 2) mesh vs unsharded: max abs {err:.3e} "
            f"on {n_dev} devices")
        check(n_dev == 4, f"sharded refresh on {n_dev} devices")
        # the sharded refresh contracts at HIGHEST, the unsharded at HIGH
        # (TF32 on the card; see PERF.md)
        check(err <= PARITY_RMS, f"sharded refresh error {err:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-card comparison")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    need = 4 if args.four else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke needs {need} GPU(s); JAX found {len(devices)} "
              f"{devices[0].platform!r} device(s)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bench
    from ergodic_exploration_tpu.utils.compile_cache import enable_persistent_cache

    ph = Phases()
    log("== (a) device")
    card = bench.card_info()
    log(f"   jax: {devices[0].platform} {devices[0].device_kind} x{len(devices)}")
    log(f"   nvidia-smi name, power.limit: {card}")
    log(f"== (b) compile cache: {enable_persistent_cache()}")
    if args.four:
        ph.run("four cards: scenario mesh + sample-sharded refresh", lambda: phase_four(ph))
        count = 4
    else:
        ph.run("(d) replan_refresh + oracle", lambda: phase_replan_refresh(ph))
        ph.run("(e) replan_refresh_mi", lambda: phase_replan_refresh_mi(ph))
        ph.run("(f) explore cart + omni", lambda: phase_explore(ph))
        ph.run("(g) explore_mapping_fused", lambda: phase_mapping(ph))
        ph.run("(h) exploration node", lambda: phase_node(ph))
        count = len(devices)
    log("setup seconds (first call, compile included): "
        + json.dumps({k: round(v, 2) for k, v in ph.setup_s.items()}))
    log(f"card: {card}")
    if ph.failed:
        print(f"failed phases: {ph.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
