"""Round-5 diagnosis of the config-4 exploration plateau (VERDICT r4 item 1).

Reproduces the quality-run geometry at small S on CPU, collecting per-tick
trajectories + full StepDiagnostics, then reports WHERE robots spend time
relative to the doorways, how often DWA/validation fire, and the ergodic
gradient field of one stalled scenario near a doorway.

Run: python tools/diag_plateau.py [S] [n_ticks]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main(S=16, n_ticks=1500, refresh_every=10, sensor_range=1.5, seed=0,
         tag="", **overrides):
    from tools.quality import build_truth
    from ergodic_exploration_tpu.config import default_config
    from ergodic_exploration_tpu.engine import Engine
    from ergodic_exploration_tpu.ops.distance import DistanceField
    from ergodic_exploration_tpu.ops import sensor

    overrides.setdefault("ergodic_weight", 200.0)
    cfg = default_config("omni").replace(**overrides)
    engine = Engine(cfg)
    truth = build_truth(S)

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
    x0 = np.asarray(xs, np.float32)
    sc = engine.init_scenarios(x0)

    # host-chunked loop so we keep the full diag of every chunk
    belief = truth._replace(data=jnp.full_like(truth.data, -1.0))
    res = float(jnp.min(truth.resolution))
    win = sensor.raycast_window_cells(sensor_range, res)
    reveal_b = jax.jit(jax.vmap(lambda b, t, x: sensor.reveal_raycast(
        b, t, x, sensor_range, win,
        occupied_threshold=cfg.occupied_threshold)))

    trajs, dwa_act, codes, divs, ems = [], [], [], [], []
    t0 = time.time()
    n_chunks = n_ticks // refresh_every
    for c in range(n_chunks):
        belief = reveal_b(belief, truth, sc.x)
        phik = engine.phik_from_grid(belief)
        world = engine.prepare_world(belief)
        out = engine.explore(sc, phik, world, refresh_every)
        sc = out.scenarios
        trajs.append(np.asarray(out.trajectory))  # (refresh_every, S, 3)
        dwa_act.append(np.asarray(out.diag.dwa_active))
        codes.append(np.asarray(out.diag.collision_code))
        divs.append(np.asarray(out.diag.diverged))
        ems.append(np.asarray(out.diag.ergodic_metric))
        if (c + 1) % 25 == 0:
            covf = float(sensor.fraction_known(belief))
            log(f"chunk {c+1}/{n_chunks} coverage {covf:.3f} "
                f"({time.time()-t0:.0f}s)")

    traj = np.concatenate(trajs)  # (n_ticks, S, 3)
    dwa = np.concatenate(dwa_act)  # (n_ticks, S)
    code = np.concatenate(codes)
    div = np.concatenate(divs)
    em = np.concatenate(ems)
    bdata = np.asarray(belief.data)
    cov_s = (bdata != -1.0).reshape(S, -1).mean(axis=1)

    # ---- room occupancy: geometry from build_truth ----
    # lower room y < 2.25; upper-left band 2.4 < y < 3.5; top rooms y > 3.6
    def room_of(p):
        x, y = p[..., 0], p[..., 1]
        lower = y < 2.25
        mid = (y >= 2.25) & (y < 3.5)
        top = y >= 3.5
        return np.where(lower, 0, np.where(mid, 1, 2))

    rooms = room_of(traj)  # (n_ticks, S)
    room0 = rooms[0]
    crossed = (rooms != room0[None, :]).any(axis=0)  # ever left start room

    # speed + displacement stats
    d = np.linalg.norm(np.diff(traj[..., :2], axis=0), axis=-1)  # (T-1, S)
    speed = d / cfg.dt
    # distance from each pose to nearest doorway center
    doors = np.array([[ (64 + 90) / 2 * 0.05, 46.5 * 0.05],   # lower wall door
                      [ 16 * 0.05, 71.0 * 0.05]])             # upper divider door
    dd = np.linalg.norm(traj[:, :, None, :2] - doors[None, None], axis=-1)
    min_door = dd.min(axis=2)  # (T, S)

    out = {
        "S": S, "n_ticks": n_ticks,
        "final_coverage_mean": float(cov_s.mean()),
        "cov_per_scenario": [round(float(v), 3) for v in cov_s],
        "crossed_rooms_frac": float(crossed.mean()),
        "room_time_frac": [float((rooms == r).mean()) for r in (0, 1, 2)],
        "mean_speed": float(speed.mean()),
        "p90_speed": float(np.percentile(speed, 90)),
        "dwa_active_rate": float(dwa.mean()),
        "code_rate": {str(k): float((code == k).mean()) for k in (0, 1, 2)},
        "diverged_rate": float(div.mean()),
        "em_first": float(em[0].mean()), "em_last": float(em[-1].mean()),
        "min_door_dist_ever": [round(float(v), 3) for v in min_door.min(axis=0)],
        "wall_s": round(time.time() - t0, 1),
    }
    out["overrides"] = {k: str(v) for k, v in overrides.items()}
    print(json.dumps(out, indent=1))

    np.savez(f"/tmp/diag_plateau{tag}.npz", traj=traj, dwa=dwa, code=code,
             em=em, belief=bdata, cov_s=cov_s, x0=x0)
    log(f"saved /tmp/diag_plateau{tag}.npz")


if __name__ == "__main__":
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 1500
    tag = sys.argv[3] if len(sys.argv) > 3 else ""
    kv = {}
    for a in sys.argv[4:]:
        k, v = a.split("=", 1)
        for cast in (int, float):
            try:
                kv[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            low = v.strip().lower()
            kv[k] = (low == "true") if low in ("true", "false") else v
    main(S, T, tag=tag, **kv)
