"""Benchmark: batched ergodic-MPC solves/s and single-scenario replan latency.

Prints ONE JSON line with the BASELINE.json primary metric, "ergodic-MPC
solves/s/chip at H=20, 10k grid samples; p50 replan latency", and the
device every number was taken on (platform, kind, count, power limit).

Each benchmarked solve is the reference's FULL per-tick work (SURVEY.md
section 4.2): target refresh over the 10k-sample lattice (phi_k), RK4
rollout (H=20), history-augmented c_k, ergodic gradient, barrier gradients
against a real obstacle map's distance field, backward co-state RK4 sweep,
control update + saturation, validation, and the batched DWA fallback.

Every call is timed on the host clock up to ``jax.block_until_ready``;
times are reported as p50/p99 with their sample count. The benchmark runs
on a GPU only: with no GPU it exits non-zero and prints no number.

    python bench.py
"""

import json
import subprocess
import sys
import time

import numpy as np


def require_gpu():
    """The JAX devices, or SystemExit when the first one is not a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found {devices[0].platform!r} "
            f"({devices[0].device_kind})")
    return devices


def card_info() -> str:
    """``name, power.limit`` of the first card, from nvidia-smi in a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_record(devices, card: str) -> dict:
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": card,
    }


def time_calls(fn, n: int):
    """Seconds of each of ``n`` calls of ``fn()``, each up to
    ``block_until_ready`` of what it returns."""
    import jax

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def percentiles_ms(seconds) -> dict:
    s = np.asarray(seconds) * 1e3
    return {"p50_ms": float(np.percentile(s, 50)),
            "p99_ms": float(np.percentile(s, 99)),
            "n": int(s.size)}


def bench_map():
    """The bench's obstacle map: a wall and a pillar on a 100x100 grid of
    0.05 m cells (a 5 m square)."""
    data = np.zeros((100, 100), dtype=np.float32)
    data[45:50, 20:80] = 1.0
    data[70:78, 60:68] = 1.0
    return data


def bench_belief():
    """The MI case's partly-unknown belief: the left 55 columns observed
    (free, with the observed part of the wall), the rest unknown."""
    belief = np.full((100, 100), -1.0, dtype=np.float32)
    belief[:, :55] = 0.0
    belief[45:50, 20:55] = 1.0
    return belief


def batched_grids(data, S: int):
    import jax.numpy as jnp

    from ergodic_exploration_tpu.grid import GridMap

    return GridMap(
        data=jnp.broadcast_to(jnp.asarray(data), (S,) + data.shape),
        origin=jnp.zeros((S, 2), jnp.float32),
        resolution=jnp.full((S,), 0.05, jnp.float32),
    )


def build_case(S: int, seed: int = 0, model: str = "cart", mesh=None):
    """(engine, scenarios, gmm, domain, world) of the flagship case: K=10,
    H=20, dt=0.1, 100x100 sample lattice, obstacles + validation + DWA, one
    shared map, S scenarios with random poses and 2-component GMM targets."""
    from ergodic_exploration_tpu.config import default_config
    from ergodic_exploration_tpu.engine import Engine
    from ergodic_exploration_tpu.grid import Domain
    from ergodic_exploration_tpu.ops import target as target_ops

    cfg = default_config(model).replace(shared_maps=True,
                                        shared_history_draw=True)
    assert cfg.horizon == 20 and cfg.grid_samples == (100, 100)
    engine = Engine(cfg, mesh=mesh)
    domain = Domain.create(0.0, 0.0, 5.0, 5.0)

    rng = np.random.default_rng(seed)
    x0 = np.concatenate(
        [rng.uniform(0.5, 4.5, (S, 2)), rng.uniform(-np.pi, np.pi, (S, 1))], axis=1
    ).astype(np.float32)
    world = engine.prepare_world(batched_grids(bench_map(), S))
    gmm = engine.shard_scenarios(target_ops.GaussianMixture.create(
        means=rng.uniform(1.0, 4.0, (S, 2, 2)).astype(np.float32),
        covs=np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1)),
        weights=np.ones((S, 2), np.float32),
    ))
    sc = engine.init_scenarios(x0)
    return engine, sc, gmm, domain, world


def bench_tick(S=4096, n=50):
    """GMM tick (refresh + solve) at S scenarios: per-call times."""
    engine, sc, gmm, domain, world = build_case(S)
    state = {"sc": sc}

    def call():
        state["sc"], u, _ = engine.replan_refresh(state["sc"], gmm, domain, world)
        return u

    time_calls(call, 3)  # compile + warm
    return time_calls(call, n)


def bench_tick_mi(S=4096, n=50, sensor_radius_cells=3):
    """Config-4 tick: MI target recomputed from the occupancy grid every
    replan (frontier-masked), fused with the solve in one jitted program."""
    engine, sc, _, domain, _ = build_case(S)
    grids = batched_grids(bench_belief(), S)
    world = engine.prepare_world(grids)
    state = {"sc": sc}

    def call():
        state["sc"], u, _ = engine.replan_refresh_mi(
            state["sc"], grids, world, sensor_radius_cells, domain=domain)
        return u

    time_calls(call, 3)
    return time_calls(call, n), engine.config.mi_frontier_cells


def main():
    from ergodic_exploration_tpu.utils.compile_cache import enable_persistent_cache

    devices = require_gpu()
    enable_persistent_cache()
    card = card_info()
    print(f"device: {devices[0].device_kind} x{len(devices)}; card: {card}",
          flush=True)
    S = 4096
    gmm = percentiles_ms(bench_tick(S))
    mi_times, mi_fc = bench_tick_mi(S)
    mi = percentiles_ms(mi_times)
    lat = percentiles_ms(bench_tick(1, n=200))
    print(json.dumps({
        "metric": "ergodic_mpc_solves_per_s_per_chip",
        "value": S / (gmm["p50_ms"] * 1e-3),
        "unit": "solves/s/chip (H=20, 10k grid samples, obstacles+DWA), "
                "S / p50 tick time",
        "batch": S,
        "gmm_tick": gmm,
        "mi_solves_per_s_per_chip": S / (mi["p50_ms"] * 1e-3),
        "mi_tick": mi,
        "mi_frontier_cells": mi_fc,
        "p50_replan_latency_ms": lat["p50_ms"],
        "p99_replan_latency_ms": lat["p99_ms"],
        "latency_samples": lat["n"],
        "latency_budget_ms": 100.0,
        "device": device_record(devices, card),
    }))


if __name__ == "__main__":
    sys.exit(main())
