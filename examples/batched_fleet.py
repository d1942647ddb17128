"""Batched-fleet demo — BASELINE config 5 at a demo-friendly scale.

Runs S scenarios (per-scenario maps, poses, GMM targets) closed-loop
entirely on-device, prints throughput + metrics, renders one scenario.

    python examples/batched_fleet.py [--scenarios 256] [--ticks 150] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mesh", action="store_true", help="shard over all local devices")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ergodic_exploration_tpu.config import default_config
    from ergodic_exploration_tpu.engine import Engine, make_scenario_mesh
    from ergodic_exploration_tpu.grid import Domain, GridMap
    from ergodic_exploration_tpu.ops.target import GaussianMixture
    from ergodic_exploration_tpu.utils.metrics import summarize
    from ergodic_exploration_tpu.viz import save_exploration_figure

    S = args.scenarios
    rng = np.random.default_rng(0)
    domain = Domain.create(0.0, 0.0, 5.0, 5.0)
    mesh = make_scenario_mesh() if args.mesh else None
    engine = Engine(default_config("cart").replace(ergodic_weight=50.0), mesh=mesh)

    # per-scenario worlds: random wall segments
    data = np.zeros((S, 100, 100), dtype=np.float32)
    for i in range(S):
        r = 20 + int(60 * rng.random())
        c = int(50 * rng.random())
        data[i, r : r + 4, c : c + 40] = 1.0
    grids = GridMap(
        data=jnp.asarray(data),
        origin=jnp.zeros((S, 2), jnp.float32),
        resolution=jnp.full((S,), 0.05, jnp.float32),
    )
    gmm = GaussianMixture.create(
        means=rng.uniform(1.0, 4.0, (S, 2, 2)).astype(np.float32),
        covs=np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32),
    )
    x0 = np.concatenate(
        [rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))], axis=1
    ).astype(np.float32)

    sc = engine.init_scenarios(x0)
    phik = engine.phik_from_gmm(gmm, domain)
    world = engine.prepare_world(grids)

    t0 = time.perf_counter()
    out = engine.explore(sc, phik, world, args.ticks)
    out.trajectory.block_until_ready()
    dt = time.perf_counter() - t0

    rec = summarize(out.diag, elapsed_s=dt)
    print(f"{S} scenarios x {args.ticks} ticks in {dt:.1f}s "
          f"(incl. compile) = {rec['solves_per_s']:.0f} solves/s")
    print({k: round(v, 4) for k, v in rec.items() if isinstance(v, float)})

    png = os.path.join(os.path.dirname(os.path.abspath(__file__)), "batched_fleet.png")
    save_exploration_figure(
        png, domain, out, scenario=0,
        grid=GridMap(grids.data[0], grids.origin[0], grids.resolution[0]),
        gmm=GaussianMixture(gmm.means[0], gmm.covs[0], gmm.weights[0]),
    )
    print(f"wrote {png}")


if __name__ == "__main__":
    main()
