"""Gather-free local map access: one-hot / hat-weight matmul patches.

Reference capability: every per-pose map query in the reference —
``Collision::minDistance`` / ``minDirection`` cell searches and the
grid lookups inside validation and the DWA loop (SURVEY.md sections 2 L1,
3, 4.2) — i.e. random access into the occupancy-derived fields.

Design: every query a replan tick makes (rollout knots, validation path,
DWA candidates) lies within ~1.2 m of the robot, so instead of gathers and
vmapped ``dynamic_slice`` with traced starts (2.3 M safety-stage queries per
tick at S=4096), map access is restructured as:

1. **Patch extraction as one-hot matmuls**: a (P, P) window of the distance
   field around the pose is R @ F @ C^T with one-hot row/column selector
   matrices — two tiny matmuls per scenario (batched under vmap).
2. **Queries as hat-weight contractions**: bilinear interpolation at query
   points is w_y @ patch * w_x summed, where w are hat (tent) weights over
   the patch cells; nearest-cell reads use one-hot weights. XLA fuses the
   weight construction into the matmul producer, so nothing (S, Q, P) ever
   round-trips through HBM.

Both are exact (fp32 HIGHEST precision): the hat contraction IS bilinear
interpolation, the one-hot contraction IS the gather.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_EXACT = jax.lax.Precision.HIGHEST
FAR = 1.0e6  # keep in sync with ops/distance.py


class PatchField(NamedTuple):
    """A local window of a DistanceField, centered near a pose.

    ``start`` is the (ix, iy) global cell index of patch cell (0, 0)
    (unclipped arithmetic start; rows/cols outside the map were clamped to
    the map edge during extraction, giving edge-padding semantics that match
    ``DistanceField.query``'s index clipping).
    """

    dist: jnp.ndarray  # (P, P) clearance, indexed [iy_local, ix_local]
    grad: jnp.ndarray  # (P, P, 2) clearance gradient
    start: jnp.ndarray  # (2,) int32 (ix, iy) of local cell (0, 0)
    origin: jnp.ndarray  # (2,) world origin of the PARENT field
    resolution: jnp.ndarray  # ()

    @property
    def size(self) -> int:
        return self.dist.shape[0]

    def _local_frac(self, p):
        """World points (..., 2) -> fractional local cell coords, clamped."""
        P = self.size
        rel = (p - self.origin) / self.resolution - 0.5  # global fractional
        loc = rel - self.start.astype(rel.dtype)
        return jnp.clip(loc, 0.0, P - 1.001)

    def query(self, p):
        """Bilinear clearance + gradient at world points (..., 2) — the
        PatchField counterpart of ``DistanceField.query`` (identical values
        whenever the true bilinear support lies inside the patch)."""
        P = self.size
        f = self._local_frac(p)
        cells = jnp.arange(P, dtype=f.dtype)
        wx = jnp.maximum(0.0, 1.0 - jnp.abs(f[..., 0:1] - cells))  # (..., P)
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(f[..., 1:2] - cells))  # (..., P)
        rows_d = jnp.matmul(wy, self.dist, precision=_EXACT)  # (..., P) over ix
        dist = jnp.sum(rows_d * wx, axis=-1)
        g = self.grad.reshape(P, 2 * P)  # [iy, (ix, comp)]
        rows_g = jnp.matmul(wy, g, precision=_EXACT).reshape(*wy.shape[:-1], P, 2)
        grad = jnp.sum(rows_g * wx[..., None], axis=-2)
        return dist, grad

    def center_crop(self, size: int) -> "PatchField":
        """Static central (size, size) sub-window — exact-identical queries
        for points whose support lies inside it.

        The safety stage's queries (validation path + DWA candidates) reach
        at most vel_lim * dwa_horizon * dt from the pose (~0.3 m ~ 6 cells
        at defaults), so they never touch the outer rings of the barrier's
        big patch; contracting them against a cropped window cuts the
        one-hot/hat matmul work ~(P/size)^2 with bit-identical results."""
        P = self.size
        if size >= P:
            return self
        o = (P - size) // 2
        return PatchField(
            dist=self.dist[o:o + size, o:o + size],
            grad=self.grad[o:o + size, o:o + size],
            start=self.start + o,
            origin=self.origin,
            resolution=self.resolution,
        )

    def query_dist(self, p):
        """Nearest-cell clearance at world points (..., 2) — the PatchField
        counterpart of ``DistanceField.query_dist`` (one-hot contraction,
        bit-exact vs the gather)."""
        P = self.size
        f = self._local_frac(p)
        n = jnp.round(f)
        cells = jnp.arange(P, dtype=f.dtype)
        ox = (n[..., 0:1] == cells).astype(f.dtype)
        oy = (n[..., 1:2] == cells).astype(f.dtype)
        rows = jnp.matmul(oy, self.dist, precision=_EXACT)
        return jnp.sum(rows * ox, axis=-1)


def extract_patch(dist_field, center, size: int) -> PatchField:
    """Extract a (size, size) PatchField around world point ``center`` (2,).

    One-hot matmul extraction (no dynamic_slice, no gather); batch scenarios
    with vmap. ``size`` is static; it is clamped to the map extent.
    """
    d = dist_field.dist
    h, w = d.shape
    P = min(size, h, w)

    cf = (center - dist_field.origin) / dist_field.resolution - 0.5  # (2,) frac (ix, iy)
    start = jnp.round(cf).astype(jnp.int32) - P // 2  # (2,) (ix, iy)

    ii = jnp.arange(P, dtype=jnp.int32)
    rows = jnp.clip(start[1] + ii, 0, h - 1)  # (P,) global iy of local iy
    cols = jnp.clip(start[0] + ii, 0, w - 1)  # (P,) global ix of local ix
    R = (rows[:, None] == jnp.arange(h, dtype=jnp.int32)).astype(d.dtype)  # (P, h)
    C = (cols[:, None] == jnp.arange(w, dtype=jnp.int32)).astype(d.dtype)  # (P, w)

    pd = jnp.matmul(jnp.matmul(R, d, precision=_EXACT), C.T, precision=_EXACT)

    # Gradient from the PATCH itself (central differences, FAR plateau
    # zeroed) — the (H, W, 2) global gradient field is never read, saving
    # 2/3 of the extraction traffic. Matches DistanceField.from_grid in the
    # patch interior; only cells on the patch border (which the query
    # clamp keeps outside the bilinear support of reachable points) see
    # one-sided instead of global-central differences.
    res = dist_field.resolution
    gx = (jnp.roll(pd, -1, axis=1) - jnp.roll(pd, 1, axis=1)) / (2.0 * res)
    gx = gx.at[:, 0].set((pd[:, 1] - pd[:, 0]) / res)
    gx = gx.at[:, -1].set((pd[:, -1] - pd[:, -2]) / res)
    gy = (jnp.roll(pd, -1, axis=0) - jnp.roll(pd, 1, axis=0)) / (2.0 * res)
    gy = gy.at[0, :].set((pd[1, :] - pd[0, :]) / res)
    gy = gy.at[-1, :].set((pd[-1, :] - pd[-2, :]) / res)
    far = pd >= FAR
    pg = jnp.where(far[..., None], 0.0, jnp.stack([gx, gy], axis=-1))

    return PatchField(
        dist=pd,
        grad=pg,
        start=start,
        origin=dist_field.origin,
        resolution=dist_field.resolution,
    )
