"""Euclidean distance transform + gradient field over occupancy grids.

Reference capability: ``Collision`` (``collision.hpp``): nearest-obstacle
distance ``minDistance`` and direction ``minDirection`` found by a
Bresenham-circle occupied-cell search around a pose (SURVEY.md sections 2 L1
and 3 "Collision detection").

Design (as planned in SURVEY.md section 3's collision row): the
per-pose ray-march is replaced by an EXACT Euclidean distance transform
computed once per map per replan, after which every distance/direction query
is an O(1) bilinear gather — the same semantics, regular-grid parallel.

The EDT itself uses the separable squared-distance decomposition:

    g[i, j]  = min_{i': occ[i', j]} (i - i')^2          (columns pass)
    d2[i, j] = min_{j'} g[i, j'] + (j - j')^2           (rows pass)

Each pass is a dense min-plus reduction against a (n, n) squared-offset
matrix — a broadcasted min-reduction that XLA tiles well, exact (not a
chamfer approximation), and O(H W (H + W)) flops which is trivially small
next to HBM time for robot-scale maps.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

FAR = 1.0e6  # "no obstacle anywhere" distance (meters)


def _minplus_pass(g, axis: int):
    """out[.., j] = min_k g[.., k] + (j - k)^2 along ``axis``."""
    n = g.shape[axis]
    k = jnp.arange(n, dtype=g.dtype)
    sq = (k[:, None] - k[None, :]) ** 2  # (n, n): sq[k, j] = (j-k)^2
    gm = jnp.moveaxis(g, axis, -1)  # (..., n)
    out = jnp.min(gm[..., :, None] + sq, axis=-2)  # (..., n)
    return jnp.moveaxis(out, -1, axis)


def edt(occ, resolution):
    """Exact Euclidean distance (meters) from each cell center to the nearest
    occupied cell center. ``occ``: (H, W) bool. Empty maps -> FAR."""
    occ = jnp.asarray(occ)
    h, w = occ.shape[-2:]
    big = jnp.asarray(float(max(h, w) ** 2 * 4), dtype=jnp.float32)
    g = jnp.where(occ, 0.0, big)
    d2 = _minplus_pass(_minplus_pass(g, -2), -1)
    d = jnp.sqrt(d2) * resolution
    return jnp.where(d2 >= big, FAR, d)


class DistanceField(NamedTuple):
    """Per-map clearance field + gradient, ready for O(1) pose queries."""

    dist: jnp.ndarray  # (H, W) meters to nearest obstacle
    grad: jnp.ndarray  # (H, W, 2) d(dist)/d(x, y)  [world units]
    origin: jnp.ndarray  # (2,)
    resolution: jnp.ndarray  # ()

    @staticmethod
    def empty(shape, origin=None, resolution: float = 0.05) -> "DistanceField":
        """Obstacle-free world: FAR distances, zero gradients (uniform code
        path for the no-obstacle configs)."""
        h, w = shape
        if origin is None:
            origin = jnp.zeros(2, dtype=jnp.float32)
        return DistanceField(
            dist=jnp.full((h, w), FAR, dtype=jnp.float32),
            grad=jnp.zeros((h, w, 2), dtype=jnp.float32),
            origin=jnp.asarray(origin, dtype=jnp.float32),
            resolution=jnp.asarray(resolution, dtype=jnp.float32),
        )

    @staticmethod
    def from_grid(grid, occupied_threshold: float = 0.65) -> "DistanceField":
        """Build from a GridMap: EDT over the occupied mask + central-diff
        gradient. Jitted per map; batch maps with vmap."""
        d = edt(grid.occupied(occupied_threshold), grid.resolution)
        # central differences (one-sided at borders), d/dx along W, d/dy along H
        gx = (jnp.roll(d, -1, axis=1) - jnp.roll(d, 1, axis=1)) / (2.0 * grid.resolution)
        gx = gx.at[:, 0].set((d[:, 1] - d[:, 0]) / grid.resolution)
        gx = gx.at[:, -1].set((d[:, -1] - d[:, -2]) / grid.resolution)
        gy = (jnp.roll(d, -1, axis=0) - jnp.roll(d, 1, axis=0)) / (2.0 * grid.resolution)
        gy = gy.at[0, :].set((d[1, :] - d[0, :]) / grid.resolution)
        gy = gy.at[-1, :].set((d[-1, :] - d[-2, :]) / grid.resolution)
        # kill the bogus FAR-plateau gradients (empty regions)
        far = d >= FAR
        gx = jnp.where(far, 0.0, gx)
        gy = jnp.where(far, 0.0, gy)
        return DistanceField(
            dist=d, grad=jnp.stack([gx, gy], axis=-1), origin=grid.origin, resolution=grid.resolution
        )

    def query_dist(self, p):
        """Nearest-cell clearance at world points (..., 2): ONE gather.

        The collision/DWA hot path needs only the distance (no gradient, no
        sub-cell interpolation — the reference's Bresenham cell search is
        cell-quantized too). The bilinear 4-corner + gradient
        :meth:`query` costs ~12 gathers/point; this costs 1.
        """
        h, w = self.dist.shape
        rel = (p - self.origin) / self.resolution - 0.5
        ix = jnp.clip(jnp.round(rel[..., 0]).astype(jnp.int32), 0, w - 1)
        iy = jnp.clip(jnp.round(rel[..., 1]).astype(jnp.int32), 0, h - 1)
        return self.dist[iy, ix]

    def query(self, p):
        """Bilinear clearance + gradient at world points (..., 2).

        Returns (dist (...,), grad (..., 2)) — the build-side equivalent of
        the reference's ``minDistance`` / ``minDirection`` pair (direction to
        the nearest obstacle = -grad).
        """
        h, w = self.dist.shape
        rel = (p - self.origin) / self.resolution - 0.5  # fractional (ix, iy)
        fx = jnp.clip(rel[..., 0], 0.0, w - 1.001)
        fy = jnp.clip(rel[..., 1], 0.0, h - 1.001)
        x0 = jnp.floor(fx).astype(jnp.int32)
        y0 = jnp.floor(fy).astype(jnp.int32)
        tx = fx - x0
        ty = fy - y0

        def gather(a, yy, xx):
            return a[yy, xx]

        d00 = gather(self.dist, y0, x0)
        d01 = gather(self.dist, y0, x0 + 1)
        d10 = gather(self.dist, y0 + 1, x0)
        d11 = gather(self.dist, y0 + 1, x0 + 1)
        dist = (
            d00 * (1 - tx) * (1 - ty)
            + d01 * tx * (1 - ty)
            + d10 * (1 - tx) * ty
            + d11 * tx * ty
        )
        g00 = gather(self.grad, y0, x0)
        g01 = gather(self.grad, y0, x0 + 1)
        g10 = gather(self.grad, y0 + 1, x0)
        g11 = gather(self.grad, y0 + 1, x0 + 1)
        wts = jnp.stack([(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], axis=-1)
        grad = (
            g00 * wts[..., 0:1] + g01 * wts[..., 1:2] + g10 * wts[..., 2:3] + g11 * wts[..., 3:4]
        )
        return dist, grad
