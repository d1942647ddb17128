"""Single-robot real-time host loop — the reference ROS node's replacement.

Reference capability: the exploration node (SURVEY.md sections 2 L5, 4.1,
4.3, 4.5): subscribe ``/map`` (nav_msgs/OccupancyGrid) and ``/odom``,
replan at ``frequency`` Hz, publish ``/cmd_vel`` twists plus predicted-path
and target visualizations. This class keeps the same callback/tick shape
minus the ROS transport: feed maps and odometry in as arrays, get body
twists out.

Division of labor:
- The solve (``ErgodicController.step``) is one jitted device computation.
- Map preprocessing (ROS int8 ingest, exact EDT + gradient, entropy target)
  runs on the HOST through the native C++ runtime (native/runtime.cc) when
  available — a map update never round-trips the accelerator — with a
  jitted JAX fallback.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ergodic_exploration_tpu import native
from ergodic_exploration_tpu.config import EngineConfig
from ergodic_exploration_tpu.controller import ErgodicController, World
from ergodic_exploration_tpu.grid import Domain, GridMap
from ergodic_exploration_tpu.ops import target as target_ops
from ergodic_exploration_tpu.ops.distance import DistanceField


class ExplorationNode:
    """Receding-horizon exploration for ONE robot at real-time rates.

    Args:
        config: EngineConfig.
        domain: exploration Domain. If None, taken from the first map.
        target: a ``GaussianMixture`` for a static GMM target, or the string
            ``"mi"`` for the mutual-information target recomputed from the
            evolving occupancy grid at every map update (BASELINE config 4).
        use_native: prefer the C++ host runtime for map preprocessing.
    """

    def __init__(self, config: EngineConfig, domain: Optional[Domain] = None,
                 target="mi", use_native: bool = True, pipeline: bool = False):
        self.config = config.validate()
        self.controller = ErgodicController(config)
        self.model = self.controller.model
        self.target = target
        self.domain = domain
        self.use_native = use_native and native.available()
        # One-tick-latency pipelining (standard in real-time MPC): step()
        # enqueues tick t's solve, starts its device->host copy, and returns
        # tick t-1's twist, so the solve and its readback overlap the tick
        # period instead of blocking it. The emitted control lags the pose it
        # was planned from by one tick (dt), which the horizon dwarfs.
        self.pipeline = pipeline
        self._pending = None

        self.state = self.controller.init_state()
        self._step = jax.jit(self.controller.step)
        self._grid: Optional[GridMap] = None
        self._world: Optional[World] = None
        self._phik = None
        self._stale = True
        self._pose = jnp.zeros(3, dtype=jnp.float32)
        self._twist = jnp.zeros(3, dtype=jnp.float32)
        self.ticks = 0

    # ------------------------------------------------------------------
    # callbacks (reference: mapCallback / odomCallback)
    # ------------------------------------------------------------------

    def on_map(self, data, x0: float = 0.0, y0: float = 0.0,
               resolution: float = 0.05) -> None:
        """Ingest an occupancy grid update.

        ``data`` is either int8 ROS convention (-1 unknown, 0..100) or float
        (-1 unknown, 0..1), shape (H, W) row-major like nav_msgs.
        """
        arr = np.asarray(data)
        if arr.dtype == np.int8:
            arr = (native.ros_ingest(arr) if self.use_native
                   else np.asarray(GridMap.from_ros(arr, x0, y0, resolution).data))
        self._grid = GridMap.create(arr, x0, y0, resolution)
        if self.domain is None:
            self.domain = self._grid.domain()
        self._stale = True  # EDT + target refreshed lazily at the next tick

    def on_odom(self, pose, twist=None) -> None:
        """Cache the latest pose (x, y, yaw) and body twist (vx, vy, w)."""
        self._pose = jnp.asarray(pose, dtype=jnp.float32)
        if twist is not None:
            self._twist = jnp.asarray(twist, dtype=jnp.float32)

    # ------------------------------------------------------------------
    # preprocessing (reference: work triggered by mapCallback, 4.3)
    # ------------------------------------------------------------------

    def _refresh(self) -> None:
        cfg = self.config
        if self.domain is None:
            raise RuntimeError("no domain: call on_map() or pass domain=")
        if self._grid is None:
            self._world = World.empty(self.domain)
        else:
            g = self._grid
            if self.use_native:
                dist, grad = native.edt2d(
                    np.asarray(g.data), cfg.occupied_threshold,
                    float(np.asarray(g.resolution)))
                df = DistanceField(dist=jnp.asarray(dist), grad=jnp.asarray(grad),
                                   origin=g.origin, resolution=g.resolution)
            else:
                df = DistanceField.from_grid(g, cfg.occupied_threshold)
            self._world = World(domain=self.domain, dist=df)

        pts = self.domain.sample_lattice(cfg.grid_samples)
        if isinstance(self.target, str) and self.target == "mi":
            if self._grid is None:
                phi = target_ops.normalize_phi(jnp.ones(pts.shape[0]))
            else:
                phi = target_ops.mi_target_values(
                    self._grid, pts,
                    frontier_cells=cfg.mi_frontier_cells,
                    occupied_threshold=cfg.occupied_threshold)
        else:
            free_mask = None
            if self._grid is not None:
                occ = self._grid.occupancy_at(pts)
                free_mask = occ < cfg.occupied_threshold
            phi = target_ops.gmm_target_values(pts, self.target, free_mask=free_mask)
        self._phik = self.controller.target_coefficients(phi, pts, self.domain)
        self._stale = False

    # ------------------------------------------------------------------
    # the tick (reference: the frequency-Hz control loop, 4.2)
    # ------------------------------------------------------------------

    def step(self):
        """One replan at the latest pose.

        Returns:
            (twist (3,) np.ndarray — the ``cmd_vel`` body twist,
             StepDiagnostics)

        With ``pipeline=True`` the returned (twist, diag) belong to the
        PREVIOUS tick's solve (zero twist on the very first tick): the
        current solve is enqueued and its readback drains in the background
        while the plant applies the previous command.
        """
        if self._stale:
            self._refresh()
        self.state, u, diag = self._step(
            self.state, self._pose, self._twist, self._phik, self._world
        )
        self.ticks += 1
        if not self.pipeline:
            return np.asarray(self.model.twist(u)), diag
        tw = self.model.twist(u)
        for leaf in jax.tree.leaves((tw, diag)):
            if hasattr(leaf, "copy_to_host_async"):
                leaf.copy_to_host_async()  # overlap D2H with this tick
        prev, self._pending = self._pending, (tw, diag)
        if prev is None:
            return np.zeros(3, dtype=np.float32), None
        return np.asarray(prev[0]), jax.tree.map(np.asarray, prev[1])

    def flush(self):
        """Drain the pipelined tail: the last enqueued solve's (twist,
        diag), or None if nothing is pending."""
        prev, self._pending = self._pending, None
        if prev is None:
            return None
        return np.asarray(prev[0]), jax.tree.map(np.asarray, prev[1])

    def predicted_path(self) -> np.ndarray:
        """(H+1, 3) forward-simulated path (nav_msgs/Path parity)."""
        return np.asarray(self.controller.predicted_path(self.state, self._pose))

    def run(self, rate_hz: float = 10.0, n_steps: int = 100, plant=None,
            on_tick=None):
        """Timer loop at ``rate_hz`` (reference: ros::Rate spin).

        ``plant(twist) -> (pose, body_twist)`` advances the robot (a
        simulator or hardware bridge) and feeds odometry back; ``on_tick``
        receives (node, twist, diag) for logging/viz.
        """
        period = 1.0 / rate_hz
        for _ in range(n_steps):
            t0 = time.perf_counter()
            tw, diag = self.step()
            if plant is not None:
                pose, vb = plant(tw)
                self.on_odom(pose, vb)
            if on_tick is not None:
                on_tick(self, tw, diag)
            sleep = period - (time.perf_counter() - t0)
            if sleep > 0 and plant is None:
                time.sleep(sleep)
        return self
