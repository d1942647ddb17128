"""L1 world model: occupancy grid + exploration domain as JAX pytrees.

Reference capability: ``GridMap`` (``grid.hpp``/``src/grid.cpp`` — world<->grid
transforms, row-major indexing, occupancy-probability accessors, updates from
``nav_msgs/OccupancyGrid``; SURVEY.md section 2 L1 and section 3).

Design: a map is a plain ``(H, W)`` float array plus a small
pytree of geometry, so thousands of maps batch on a leading axis and every
transform is a pure vectorized function. ROS int8 semantics (-1 unknown,
0..100 occupied-percent) are converted at the boundary by
:meth:`GridMap.from_ros`.

Grid convention: ``data[iy, ix]`` with world position
``x = x0 + (ix + 0.5) * resolution``, ``y = y0 + (iy + 0.5) * resolution``
(cell-center convention, matching occupancy-grid practice).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

UNKNOWN = -1.0  # sentinel in GridMap.data for unobserved cells


class Domain(NamedTuple):
    """Rectangular exploration domain [x0, x0+Lx] x [y0, y0+Ly].

    The cosine basis and the boundary barrier are defined on this rectangle.
    In the reference the domain is implicitly the map extent; here it is an
    explicit (traceable) pytree so per-scenario domains can differ.
    """

    origin: jnp.ndarray  # (2,) = (x0, y0)
    lengths: jnp.ndarray  # (2,) = (Lx, Ly)

    @staticmethod
    def create(x0: float, y0: float, lx: float, ly: float) -> "Domain":
        return Domain(
            origin=jnp.array([x0, y0], dtype=jnp.float32),
            lengths=jnp.array([lx, ly], dtype=jnp.float32),
        )

    def contains(self, p):
        """True where points (..., 2) lie inside the domain."""
        rel = p - self.origin
        return jnp.all((rel >= 0.0) & (rel <= self.lengths), axis=-1)

    def sample_lattice(self, shape: Tuple[int, int]):
        """Uniform (ns_x * ns_y, 2) lattice of cell-centered sample points.

        These are the "grid samples" of the ergodic reduction (the ~10k-point
        spatial quadrature of SURVEY.md section 4.2). Cell-centered so no
        sample sits exactly on the domain boundary.
        """
        nsx, nsy = shape
        fx = (jnp.arange(nsx, dtype=jnp.float32) + 0.5) / nsx
        fy = (jnp.arange(nsy, dtype=jnp.float32) + 0.5) / nsy
        gx = self.origin[0] + fx * self.lengths[0]
        gy = self.origin[1] + fy * self.lengths[1]
        xx, yy = jnp.meshgrid(gx, gy, indexing="ij")
        return jnp.stack([xx.ravel(), yy.ravel()], axis=-1)


class GridMap(NamedTuple):
    """Occupancy grid: ``data`` in {-1 (unknown)} U [0, 1] (occupancy prob).

    ``data`` has shape (H, W) indexed [iy, ix]; add leading axes to batch.
    """

    data: jnp.ndarray  # (H, W) float32
    origin: jnp.ndarray  # (2,) world coords of the (0, 0) cell corner
    resolution: jnp.ndarray  # () meters per cell

    @staticmethod
    def create(data, x0: float = 0.0, y0: float = 0.0, resolution: float = 0.05) -> "GridMap":
        return GridMap(
            data=jnp.asarray(data, dtype=jnp.float32),
            origin=jnp.array([x0, y0], dtype=jnp.float32),
            resolution=jnp.asarray(resolution, dtype=jnp.float32),
        )

    @staticmethod
    def from_ros(int8_data, x0: float, y0: float, resolution: float) -> "GridMap":
        """Convert ROS ``nav_msgs/OccupancyGrid``-convention int8 data.

        -1 stays UNKNOWN; 0..100 becomes probability 0..1. Reference:
        ``GridMap::update(OccupancyGrid)`` (SURVEY.md section 4.3).
        """
        raw = jnp.asarray(int8_data, dtype=jnp.float32)
        data = jnp.where(raw < 0.0, UNKNOWN, raw / 100.0)
        return GridMap.create(data, x0, y0, resolution)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data.shape[-2:]

    def domain(self) -> Domain:
        """The exploration domain spanned by this map."""
        h, w = self.shape
        return Domain(
            origin=self.origin,
            lengths=jnp.stack([w * self.resolution, h * self.resolution]).astype(jnp.float32),
        )

    # --- world <-> grid transforms (reference: grid2World / world2Grid) ---

    def world_to_grid(self, p):
        """World points (..., 2) -> fractional grid indices (..., 2) as (ix, iy).

        A point at a cell center maps to an integer index.
        """
        rel = (p - self.origin) / self.resolution - 0.5
        return rel

    def grid_to_world(self, idx):
        """Grid indices (..., 2) as (ix, iy) -> world coords of cell centers."""
        return self.origin + (jnp.asarray(idx, dtype=jnp.float32) + 0.5) * self.resolution

    def cell_index(self, p):
        """World points -> integer (ix, iy), clamped to the map."""
        h, w = self.shape
        ij = jnp.round(self.world_to_grid(p)).astype(jnp.int32)
        return jnp.clip(ij, jnp.zeros(2, jnp.int32), jnp.array([w - 1, h - 1], jnp.int32))

    def occupancy_at(self, p):
        """Raw occupancy value at world points (..., 2): -1 unknown, else prob."""
        ij = self.cell_index(p)
        return self.data[..., ij[..., 1], ij[..., 0]]

    # --- semantic masks ---

    def prob(self):
        """Occupancy probability with unknown cells at 0.5 (max entropy)."""
        return jnp.where(self.data < 0.0, 0.5, self.data)

    def known(self):
        return self.data >= 0.0

    def occupied(self, threshold: float = 0.65):
        """Obstacle mask; unknown cells are NOT obstacles (reference treats
        only occupied-probability cells as obstacles in collision checks)."""
        return self.data >= threshold

    def free(self, threshold: float = 0.2):
        return (self.data >= 0.0) & (self.data <= threshold)
