"""Target spatial distributions phi(x): Gaussian mixtures and
mutual-information / entropy maps from an evolving occupancy grid.

Reference capability: ``Gaussian`` / ``Target`` (``target.hpp`` — GMM
evaluated on grid points, normalized over free space) and the
information-driven target recomputed from the occupancy grid each replan
(SURVEY.md sections 2 L3, 3 "Target distribution" / "Information-map target",
and BASELINE config 4).

Design: everything is a dense vectorized evaluation over the (static
shape) sample lattice; the MI map is a fused elementwise entropy + separable
blur, recomputed per replan per scenario under vmap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class GaussianMixture(NamedTuple):
    """GMM target as a pytree: batchable over a leading scenario axis."""

    means: jnp.ndarray  # (J, 2)
    covs: jnp.ndarray  # (J, 2, 2)
    weights: jnp.ndarray  # (J,)

    @staticmethod
    def create(means, covs, weights=None) -> "GaussianMixture":
        means = jnp.asarray(means, dtype=jnp.float32)
        covs = jnp.asarray(covs, dtype=jnp.float32)
        if covs.ndim == 2:  # diagonal covariances given as (J, 2)
            covs = jax.vmap(jnp.diag)(covs)
        if weights is None:
            weights = jnp.ones(means.shape[0], dtype=jnp.float32)
        return GaussianMixture(means, covs, jnp.asarray(weights, dtype=jnp.float32))


def gmm_eval(points, gmm: GaussianMixture):
    """Unnormalized GMM density at points (N, 2) -> (N,).

    2x2 covariance inverses in closed form (no linalg solve on the hot path).
    """
    d = points[:, None, :] - gmm.means[None, :, :]  # (N, J, 2)
    a = gmm.covs[:, 0, 0]
    b = gmm.covs[:, 0, 1]
    c = gmm.covs[:, 1, 1]
    det = a * c - b * b
    inv_det = 1.0 / det
    # quadratic form d^T Sigma^-1 d with Sigma^-1 = [[c,-b],[-b,a]]/det
    q = (c * d[..., 0] ** 2 - 2.0 * b * d[..., 0] * d[..., 1] + a * d[..., 1] ** 2) * inv_det
    norm = gmm.weights / (2.0 * jnp.pi * jnp.sqrt(det))
    return jnp.sum(norm[None, :] * jnp.exp(-0.5 * q), axis=-1)


def normalize_phi(phi_vals, mask=None, eps: float = 1e-12):
    """Normalize sampled phi to a discrete distribution (sum = 1).

    ``mask`` zeroes excluded samples (e.g. occupied cells — the reference
    normalizes over free space). Degenerate all-zero inputs fall back to
    uniform over the mask.
    """
    phi = jnp.maximum(phi_vals, 0.0)
    if mask is not None:
        m = mask.astype(phi.dtype)
        phi = phi * m
        fallback = m / jnp.maximum(jnp.sum(m), 1.0)
    else:
        fallback = jnp.full_like(phi, 1.0 / phi.shape[0])
    s = jnp.sum(phi)
    return jnp.where(s > eps, phi / jnp.maximum(s, eps), fallback)


def entropy(p, eps: float = 1e-6):
    """Bernoulli cell entropy H(p) = -p log p - (1-p) log(1-p)."""
    p = jnp.clip(p, eps, 1.0 - eps)
    return -(p * jnp.log(p) + (1.0 - p) * jnp.log1p(-p))


def _box_blur_1d(img, radius: int, axis: int):
    """Separable box blur via cumulative sums; O(HW) independent of radius."""
    if radius <= 0:
        return img
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (radius + 1, radius)
    c = jnp.cumsum(jnp.pad(img, pad, mode="edge"), axis=axis)
    hi = jax.lax.slice_in_dim(c, 2 * radius + 1, 2 * radius + 1 + n, axis=axis)
    lo = jax.lax.slice_in_dim(c, 0, n, axis=axis)
    return (hi - lo) / (2 * radius + 1)


def frontier_adjacency(grid, cells: int, occupied_threshold: float = 0.65):
    """0/1 mask of cells within ``cells`` (Chebyshev distance, edge-clamped
    windows) of a KNOWN-FREE cell; (..., H, W) float.

    This is SURVEY.md A.3's "masked to known-free-adjacent cells": restricting
    the MI target to the REACHABLE frontier of explored space. Without it the
    entropy map puts most of its mass on deep-unknown space behind walls, so
    the ergodic gradient pulls robots INTO walls instead of along reachable
    routes through doorways (measured round 5: the config-4 closed loop
    plateaued at ~35% coverage with robots pressed against walls; frontier
    masking roughly doubled sustained coverage — docs/PERFORMANCE.md).

    The dilation is the same edge-clamped box count as :func:`_box_blur_1d`
    (times (2c+1)^2), so the dense batched path can fold it into exact
    small-integer :func:`blur_count_matrix` matmuls (counts <= (2c+1)^2 = 49
    at the default radius — bf16-exact).
    """
    kf = ((grid.data >= 0.0)
          & (~grid.occupied(occupied_threshold))).astype(jnp.float32)
    cnt = _box_blur_1d(_box_blur_1d(kf, cells, -1), cells, -2)
    return (cnt * float((2 * cells + 1) ** 2) > 0.5).astype(jnp.float32)


def mutual_information_map(grid, sensor_radius_cells: int = 0,
                           frontier_cells: int = 0,
                           occupied_threshold: float = 0.65):
    """Per-cell information value of the map: entropy of the occupancy
    probability, optionally blurred by a box sensor-footprint kernel so a
    pose is credited with the information visible around it; (H, W).

    This is the expected-entropy-reduction (mutual information) surrogate of
    SURVEY.md section 3 "Information-map target": unknown cells (p=0.5) carry
    maximal information, known free/occupied cells near zero. Occupied cells
    are zeroed after the blur so the target never asks the robot to stand in
    a wall.

    ``frontier_cells > 0`` additionally masks the map to cells within that
    many cells of known-free space (:func:`frontier_adjacency` — SURVEY.md
    A.3 "known-free-adjacent"), concentrating phi on the reachable frontier;
    0 keeps the legacy all-unknown-weighted map.
    """
    h = entropy(grid.prob())
    h = _box_blur_1d(_box_blur_1d(h, sensor_radius_cells, -1), sensor_radius_cells, -2)
    if frontier_cells > 0:
        h = h * frontier_adjacency(grid, frontier_cells, occupied_threshold)
    return jnp.where(grid.occupied(occupied_threshold), 0.0, h)


def sample_map_at(values, grid, points):
    """Nearest-cell gather of a per-cell map (H, W) at world points (N, 2)."""
    ij = grid.cell_index(points)  # (N, 2) as (ix, iy)
    return values[ij[:, 1], ij[:, 0]]


def mi_target_values(grid, points, sensor_radius_cells: int = 0,
                     frontier_cells: int = 0,
                     occupied_threshold: float = 0.65):
    """phi values at sample points from the current occupancy grid,
    normalized to sum 1 — recomputed each replan as the grid evolves
    (BASELINE config 4).

    NOTE: ``sample_map_at`` is a gather — this function is the oracle twin
    for arbitrary point sets. The hot path
    (Engine.phik_from_grid, replan_refresh_mi) uses
    :func:`phik_from_grid_separable`, which never gathers.
    """
    info = mutual_information_map(grid, sensor_radius_cells, frontier_cells,
                                  occupied_threshold)
    vals = sample_map_at(info, grid, points)
    return normalize_phi(vals)


def phik_from_grid_separable(grid, K: int, grid_samples, domain=None,
                             sensor_radius_cells: int = 0, eps: float = 1e-12,
                             frontier_cells: int = 0,
                             occupied_threshold: float = 0.65):
    """Gather-free MI target coefficients phi_k from one occupancy grid —
    the batched config-4 per-tick refresh (reference capability:
    the information-map target recomputed each replan, SURVEY.md sections 3
    "Information-map target" and 4.3).

    Exactly equal (up to fp32 reassociation) to

        normalize_phi(sample_map_at(info, grid, lattice)) -> basis.coefficients

    but with the nearest-cell lattice sampling folded into the separable
    cosine contraction: sampling a separable lattice from a (H, W) map is a
    one-hot aggregation per axis, so

        ck_raw[k1, k2] = sum_{r, c} info[r, c] * Gx[c, k1] * Gy[r, k2]
        Gx = Ax^T @ cosx   (W, K),  Ax[i, c] = [nearest col of lattice x_i == c]
        Gy = Ay^T @ cosy   (H, K)

    — two (K, n)@(n, n)-scale matmuls per scenario, ~9x fewer flops than
    the dense (N, K^2) table and zero gathers/scatters.
    The k = (0, 0) entry of the raw contraction IS the normalizer
    (cos(0) = 1), so free-space normalization costs nothing extra; the
    degenerate all-zero-info fallback (uniform over the lattice) has the
    closed form sum_i cosx[i, k1] * sum_j cosy[j, k2] / N, matching
    :func:`normalize_phi`'s fallback. Batch scenarios with vmap.
    """
    from ergodic_exploration_tpu.ops import basis

    _EXACT = jax.lax.Precision.HIGHEST
    info = mutual_information_map(grid, sensor_radius_cells, frontier_cells,
                                  occupied_threshold)  # (H, W)
    dom = grid.domain() if domain is None else domain
    nsx, nsy = grid_samples
    h, w = grid.shape

    # per-axis lattice coordinates (Domain.sample_lattice separability)
    fx = (jnp.arange(nsx, dtype=jnp.float32) + 0.5) / nsx
    fy = (jnp.arange(nsy, dtype=jnp.float32) + 0.5) / nsy
    gx = dom.origin[0] + fx * dom.lengths[0]  # (nsx,)
    gy = dom.origin[1] + fy * dom.lengths[1]  # (nsy,)

    # nearest map cell per lattice coordinate (grid.cell_index semantics)
    cx = jnp.clip(jnp.round((gx - grid.origin[0]) / grid.resolution - 0.5), 0.0, w - 1.0)
    cy = jnp.clip(jnp.round((gy - grid.origin[1]) / grid.resolution - 0.5), 0.0, h - 1.0)

    # per-axis cosine tables at the lattice (basis.tables separated)
    k = jnp.arange(K, dtype=jnp.float32)
    cosx = jnp.cos((gx - dom.origin[0])[:, None] * (k * jnp.pi / dom.lengths[0])[None, :])
    cosy = jnp.cos((gy - dom.origin[1])[:, None] * (k * jnp.pi / dom.lengths[1])[None, :])

    # one-hot aggregation of the lattice cosines onto map columns/rows
    Ax = (cx[:, None] == jnp.arange(w, dtype=jnp.float32)[None, :]).astype(jnp.float32)
    Ay = (cy[:, None] == jnp.arange(h, dtype=jnp.float32)[None, :]).astype(jnp.float32)
    Gx = jnp.matmul(Ax.T, cosx, precision=_EXACT, preferred_element_type=jnp.float32)  # (W, K)
    Gy = jnp.matmul(Ay.T, cosy, precision=_EXACT, preferred_element_type=jnp.float32)  # (H, K)

    # raw[k1, k2] = sum_{r,c} info[r,c] Gx[c,k1] Gy[r,k2]; raw[0,0] = total phi
    t1 = jnp.matmul(info, Gx, precision=_EXACT, preferred_element_type=jnp.float32)  # (H, K1)
    raw = jnp.matmul(t1.T, Gy, precision=_EXACT, preferred_element_type=jnp.float32)  # (K1, K2)

    hk = basis.hk_norm(K, dom.lengths)
    total = raw[0, 0]
    ck = raw / (jnp.maximum(total, eps) * hk)
    # normalize_phi fallback parity: uniform over the lattice when info ~ 0
    n = float(nsx * nsy)
    ck_u = (jnp.sum(cosx, axis=0)[:, None] * jnp.sum(cosy, axis=0)[None, :]) / (n * hk)
    return jnp.where(total > eps, ck, ck_u)


def blur_count_matrix(n: int, radius: int, dtype=jnp.float32):
    """(n, n) small-integer counts C with (C @ v)[i] = sum_{k=i-r}^{i+r}
    v[clip(k, 0, n-1)] — the edge-padded box blur of :func:`_box_blur_1d`
    times (2r+1). Integer-valued (<= r+2), so EXACT even at bf16 matmul
    precision; fold it into one-hot sampling matrices to get blurring for
    free (the 1/(2r+1)^2 scale cancels in phi normalization)."""
    if radius <= 0:
        return jnp.eye(n, dtype=dtype)
    i = jnp.arange(n)
    j = jnp.arange(n)
    B = (jnp.abs(i[:, None] - j[None, :]) <= radius).astype(dtype)
    B = B.at[:, 0].set(jnp.maximum(0, radius - i + 1).astype(dtype))
    B = B.at[:, -1].set(jnp.maximum(0, i + radius - (n - 1) + 1).astype(dtype))
    return B


def sampling_one_hots(grid, grid_samples, domain):
    """One-hot nearest-cell sampling matrices (Ax (nsx, W), Ay (nsy, H))
    from the separable lattice of ``domain`` into ``grid``'s cells.

    Boundary caveat: a lattice point that lands EXACTLY on a half-cell
    boundary makes the nearest-cell round ulp-sensitive to XLA fusion (the
    same program can pick adjacent cells eager vs jitted, or across
    kernels). Geometries whose lattice divides the cell size evenly (e.g.
    100 samples over 100 cells) are safe; parity tests should avoid exact
    boundaries (see tests/test_mi_refresh.py)."""
    h, w = grid.shape
    nsx, nsy = grid_samples
    fx = (jnp.arange(nsx, dtype=jnp.float32) + 0.5) / nsx
    fy = (jnp.arange(nsy, dtype=jnp.float32) + 0.5) / nsy
    gx = domain.origin[0] + fx * domain.lengths[0]
    gy = domain.origin[1] + fy * domain.lengths[1]
    cx = jnp.clip(jnp.round((gx - grid.origin[0]) / grid.resolution - 0.5), 0.0, w - 1.0)
    cy = jnp.clip(jnp.round((gy - grid.origin[1]) / grid.resolution - 0.5), 0.0, h - 1.0)
    Ax = (cx[:, None] == jnp.arange(w, dtype=jnp.float32)[None, :]).astype(jnp.float32)
    Ay = (cy[:, None] == jnp.arange(h, dtype=jnp.float32)[None, :]).astype(jnp.float32)
    return Ax, Ay


def lattice_resample(info, grid, grid_samples, domain):
    """Gather-free nearest-cell resampling of a per-cell map (H, W) onto the
    SEPARABLE sample lattice of ``domain`` -> (N,) in lattice (x-major)
    order. The resampling matrices are one-hot per axis, so this is two
    (ns, n)-scale matmuls with wide (~ns) outputs."""
    nsx, nsy = grid_samples
    Ax, Ay = sampling_one_hots(grid, grid_samples, domain)
    _E = jax.lax.Precision.HIGHEST
    sampled = jnp.matmul(
        jnp.matmul(Ax, info.T, precision=_E), Ay.T, precision=_E
    )  # (nsx, nsy): sampled[ix, iy] = info[r(iy), c(ix)]
    return sampled.reshape(nsx * nsy)


def gmm_target_values(points, gmm: GaussianMixture, free_mask=None):
    """phi values at sample points for a GMM target, normalized over the
    (optionally masked) free space."""
    return normalize_phi(gmm_eval(points, gmm), mask=free_mask)
