"""Config-4 closed-loop QUALITY artifact (VERDICT r3 next-round 8).

One ``explore_mapping_fused`` run — S scenarios, ``n_refreshes`` map
refreshes of ``refresh_every`` ticks each, occlusion-aware ray-cast sensor,
MI target + EDT world recomputed from the evolving beliefs every refresh
(BASELINE config 4; SURVEY.md section 4.3) — recording the two quality
curves the throughput numbers don't show:

- coverage (fraction of the hidden map revealed) vs tick
- ergodic metric (against each refresh's CURRENT MI target) vs tick

Writes docs/quality_config4.png + docs/quality_config4.json and prints the
headline numbers.

Run: python tools/quality.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_truth(S: int):
    """Hidden ground-truth world: outer walls + two rooms + a pillar on a
    5 m x 5 m, 100x100 @ 0.05 m grid (the bench geometry, enriched so the
    ray-cast sensor has real occlusion structure to defeat)."""
    import jax.numpy as jnp

    from ergodic_exploration_tpu.grid import GridMap

    # Doorways must exceed 2*(boundary_radius + a margin): the validator
    # refuses contact (d <= 0) gaps. At the round-5 defaults (d_safe=0.2)
    # the 1.3 m / 1.6 m doors are barrier-open; at the old d_safe=0.5 the
    # facing barrier bands overlapped and sealed them.
    data = np.zeros((100, 100), np.float32)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 1.0  # outer walls
    data[45:48, 0:64] = 1.0  # long wall, 1.3 m doorway on the right
    data[45:48, 90:100] = 1.0
    data[70:72, 32:100] = 1.0  # upper room divider, 1.6 m doorway on left
    data[20:28, 70:78] = 1.0  # pillar
    return GridMap(
        data=jnp.broadcast_to(jnp.asarray(data), (S, 100, 100)),
        origin=jnp.zeros((S, 2), jnp.float32),
        resolution=jnp.full((S,), 0.05, jnp.float32),
    )


def spawn_poses(truth, cfg, S: int, seed: int = 0):
    """(S, 3) start poses rejection-sampled over the map's free space with
    REAL clearance (EDT > boundary_radius + d_safe): a spawn inside the
    safety margin is a validation crash with an infeasible DWA -> the robot
    parks forever (correct reference semantics), so keep spawns legal."""
    import jax

    from ergodic_exploration_tpu.ops.distance import DistanceField

    rng = np.random.default_rng(seed)
    g0t = jax.tree.map(lambda a: a[0], truth)
    edt = np.asarray(DistanceField.from_grid(g0t).dist)
    need = cfg.boundary_radius + cfg.d_safe
    xs = []
    while len(xs) < S:
        p_ = rng.uniform(0.3, 4.7, 2)
        ij = (int(p_[1] / 0.05), int(p_[0] / 0.05))
        if edt[ij] > need:
            xs.append([p_[0], p_[1], rng.uniform(-np.pi, np.pi)])
    return np.asarray(xs, np.float32)


def main(S=256, n_refreshes=500, refresh_every=10, sensor_range=1.5,
         seed=0):
    import jax

    log(f"devices: {jax.devices()}")

    from ergodic_exploration_tpu.config import default_config
    from ergodic_exploration_tpu.engine import Engine
    from ergodic_exploration_tpu.grid import Domain

    # OMNI model (the reference's second platform): full planar mobility,
    # no cart v~0 stall singularity (docs/PARITY.md; .claude/skills/verify),
    # so reachability reflects the MAP, not the model. Round 5: pure
    # DEFAULTS — the retuned gains + frontier MI target + orbit guard took
    # the fleet median from 37% to 98% coverage on this map.
    cfg = default_config("omni")
    engine = Engine(cfg)
    truth = build_truth(S)

    x0 = spawn_poses(truth, cfg, S, seed)
    sc = engine.init_scenarios(x0)

    t0 = time.time()
    sc2, belief, cov, traj, em = engine.explore_mapping_fused(
        sc, truth, n_refreshes=n_refreshes, refresh_every=refresh_every,
        sensor_range=sensor_range)
    cov = np.asarray(cov)  # (R,) mean over S already? check: fraction_known
    traj = np.asarray(traj)  # (R, refresh_every, S, 3)
    em = np.asarray(em)  # (R, refresh_every, S)
    wall = time.time() - t0
    n_ticks = n_refreshes * refresh_every
    log(f"run: {n_ticks} ticks x {S} scenarios in {wall:.1f}s "
        f"(compile included) -> coverage {np.ravel(cov)[-1]:.3f}")

    cov_curve = cov.reshape(n_refreshes, -1).mean(axis=1)  # (R,) fleet mean
    # per-scenario final coverage (fraction_known is a fleet-global mean;
    # recover the distribution from the final beliefs)
    bdata = np.asarray(belief.data)
    cov_s = (bdata != -1.0).reshape(S, -1).mean(axis=1)  # (S,)
    em_mean = em.mean(axis=2)  # (R, refresh_every) mean over scenarios
    em_curve = em_mean.reshape(-1)  # per tick
    ticks = np.arange(1, n_refreshes + 1) * refresh_every

    out = {
        "S": S,
        "n_refreshes": n_refreshes,
        "refresh_every": refresh_every,
        "sensor_range_m": sensor_range,
        "final_coverage": float(cov_curve[-1]),
        "final_coverage_per_scenario": {
            "p10": float(np.percentile(cov_s, 10)),
            "median": float(np.median(cov_s)),
            "p90": float(np.percentile(cov_s, 90)),
            "best": float(cov_s.max()),
        },
        "coverage_at": {str(int(t)): float(c) for t, c in
                        zip(ticks[:: max(1, n_refreshes // 8)],
                            cov_curve[:: max(1, n_refreshes // 8)])},
        "ergodic_metric_first_tick": float(em_curve[0]),
        "ergodic_metric_last_tick": float(em_curve[-1]),
        "ergodic_metric_last_refresh_mean": float(em_mean[-1].mean()),
        "coverage_curve": [round(float(c), 4) for c in cov_curve],
        "em_curve_per_refresh": [round(float(m), 6) for m in em_mean.mean(axis=1)],
        "wall_s_incl_compile": round(wall, 1),
    }

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "docs", "quality_config4.json"), "w") as f:
        json.dump(out, f, indent=1)

    # ---- figure: belief+trajectory / coverage / ergodic metric ----
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ergodic_exploration_tpu.viz import render_scenario

    dom = Domain(origin=np.zeros(2, np.float32),
                 lengths=np.full(2, 5.0, np.float32))

    s_star = int(np.argmax(cov_s))  # show the best-coverage scenario
    g0 = jax.tree.map(lambda a: np.asarray(a[s_star]), belief)

    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    ax = axes[0]
    b = g0.data
    ax.imshow(np.where(b < 0.0, 0.5, b), origin="lower",
              extent=[0, 5, 0, 5], cmap="gray_r", vmin=0, vmax=1)
    T = traj[:, :, s_star, :].reshape(-1, 3)
    ax.plot(T[:, 0], T[:, 1], "-", color="tab:orange", lw=0.8)
    ax.plot(T[-1, 0], T[-1, 1], "o", color="tab:orange", ms=5)
    ax.set_title(f"best scenario ({cov_s[s_star]:.0%}) belief after "
                 f"{n_ticks} ticks\n(grey = still unknown; "
                 f"fleet median {np.median(cov_s):.0%})")
    ax.set_aspect("equal")

    tick_axis = np.arange(1, n_ticks + 1)
    axes[1].plot(ticks, cov_curve, "o-", ms=3)
    axes[1].set_xlabel("tick")
    axes[1].set_ylabel("fraction of map known")
    axes[1].set_ylim(0, 1)
    axes[1].grid(alpha=0.3)
    axes[1].set_title(f"coverage vs tick (mean over S={S})\n"
                      f"final {cov_curve[-1]:.1%}")

    axes[2].plot(tick_axis, em_curve, lw=1.0)
    axes[2].set_xlabel("tick")
    axes[2].set_ylabel("ergodic metric (vs current MI target)")
    axes[2].set_yscale("log")
    axes[2].grid(alpha=0.3)
    axes[2].set_title("ergodic metric vs tick\n(sawtooth = target refresh)")

    fig.tight_layout()
    png = os.path.join(here, "docs", "quality_config4.png")
    fig.savefig(png, dpi=110)
    log(f"wrote {png}")
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, list)}))


if __name__ == "__main__":
    main()
