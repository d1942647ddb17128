"""Scaling-efficiency harness (BASELINE.md: solves/s at 1 card / 1 host / N hosts).

Sweeps the scenario batch per device and, when more than one device is
visible (several cards, or a multi-process run launched with
``ergodic_exploration_tpu.parallel.initialize_multihost()``), shards the
batch over the full scenario mesh. Prints one JSON line per point:

    python examples/scaling.py --batches 512,1024,2048,4096 [--multihost]

Efficiency is solves/s divided by (devices x solves/s at the smallest batch
on one device) — the scenario axis has zero cross-device communication, so
anything below ~1.0 is launch/dispatch overhead, not collectives.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_point(S, mesh, iters=20):
    import jax
    import jax.numpy as jnp

    from ergodic_exploration_tpu.config import default_config
    from ergodic_exploration_tpu.engine import Engine
    from ergodic_exploration_tpu.grid import Domain, GridMap
    from ergodic_exploration_tpu.ops.target import GaussianMixture

    rng = np.random.default_rng(0)
    domain = Domain.create(0.0, 0.0, 5.0, 5.0)
    # the bench configuration: one shared map, one shared history draw
    engine = Engine(default_config("cart").replace(
        shared_history_draw=True, shared_maps=True), mesh=mesh)
    data = np.zeros((100, 100), dtype=np.float32)
    data[45:50, 20:80] = 1.0
    grids = GridMap(
        data=jnp.broadcast_to(jnp.asarray(data), (S, 100, 100)),
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
    world = engine.prepare_world(grids)
    gmm = engine.shard_scenarios(gmm)  # no-op single-process; per-host slice under jax.distributed

    def force(u):
        # multi-process-safe completion: jitted sum -> replicated scalar
        return float(jax.jit(jnp.sum)(u))

    sc, u, d = engine.replan_refresh(sc, gmm, domain, world)
    force(u)  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        sc, u, d = engine.replan_refresh(sc, gmm, domain, world)
    force(u)
    dt = (time.perf_counter() - t0) / iters
    return S / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="512,1024,2048,4096")
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    # explicit multi-process launch: run one copy of this script per
    # process with the same --coordinator/--nproc and its --pid; on a host
    # with one card per process, each process takes card --pid
    ap.add_argument("--coordinator", default=None, help="host:port")
    ap.add_argument("--nproc", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--local-device", type=int, default=None,
                    help="this process's card (default: --pid; -1: every card)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.multihost:
        from ergodic_exploration_tpu.parallel import initialize_multihost

        card = args.pid if args.local_device is None else args.local_device
        initialize_multihost(coordinator_address=args.coordinator,
                             num_processes=args.nproc, process_id=args.pid,
                             local_device_ids=None if args.cpu or card is None or card < 0
                             else [card])

    from ergodic_exploration_tpu.engine import make_scenario_mesh

    n_dev = len(jax.devices())
    mesh = make_scenario_mesh() if n_dev > 1 else None
    base = None
    for S in [int(s) for s in args.batches.split(",")]:
        sps = run_point(S, mesh, iters=args.iters)
        if base is None:
            base = sps
        if jax.process_index() == 0:
            print(json.dumps({
                "batch": S,
                "devices": n_dev,
                "hosts": jax.process_count(),
                "solves_per_s": round(sps, 1),
                "efficiency_vs_first_point": round(sps / base, 3),
            }), flush=True)


if __name__ == "__main__":
    main()
