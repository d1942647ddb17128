"""Cosine Fourier basis on the rectangular domain — the matmul-shaped core.

Reference capability: ``Basis`` (``basis.hpp``/``src/basis.cpp``): multi-index
set k in {0..K-1}^2, ``fourierBasis``/``gradFourierBasis``, trajectory
coefficients c_k, spatial coefficients phi_k, Sobolev weights Lambda_k
(SURVEY.md sections 2 L3, 3, and A.1/A.3).

Design (SURVEY.md section 8 "hard parts"): the reference loops over all K^2
indices per point. Here the separable cosine structure is exploited so
every reduction is a small matmul:

    F_k(p)   = cos(k1 a1 x) cos(k2 a2 y) / h_k,   a_i = pi / L_i
    c_k      = (Cx * w)^T @ Cy / h            -- one (K,N)@(N,K) matmul
    e_x[m]   = -(2/M) sum_k1 f1_k1 Sx[m,k1] * (Cy @ Wh^T)[m,k1]
    e_y[m]   = -(2/M) sum_k2 f2_k2 Sy[m,k2] * (Cx @ Wh)[m,k2]

so the O(K^2 N) work (K~10, N~10^4 grid samples -> ~10^6 cos-products per
solve) is two (N,K)@(K,K) matmuls plus elementwise ops — never a
materialized (N, K, K) intermediate.

Math contract shared with tests/oracle.py:
    h_k = sqrt(Lx Ly c(k1) c(k2)), c(0)=1, c(k>0)=1/2  (||F_k||_L2 = 1)
    Lambda_k = (1 + k1^2 + k2^2)^(-3/2)                 (n=2 Sobolev)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# The K^2-coefficient reductions need true fp32 operands: DEFAULT precision
# rounds float32 matmul inputs (to TF32 on the GPU, ~3e-4 relative
# measured), eating into the 1e-3 RMS parity budget (SURVEY.md section 8).
# These matmuls are (N, K)@(K, K) with K ~ 10 — IEEE float32 is cheap next
# to the memory traffic.
_EXACT = jax.lax.Precision.HIGHEST


def lambda_weights(K: int):
    """Sobolev weights Lambda_k = (1 + ||k||^2)^(-3/2); (K, K)."""
    k = jnp.arange(K, dtype=jnp.float32)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    return (1.0 + k2) ** -1.5


def hk_norm(K: int, lengths):
    """L2 normalization h_k; (K, K). ``lengths`` = (Lx, Ly) may be traced."""
    c = jnp.where(jnp.arange(K) == 0, 1.0, 0.5).astype(jnp.float32)
    return jnp.sqrt(lengths[0] * lengths[1] * c[:, None] * c[None, :])


class BasisTables(NamedTuple):
    """Per-point separable cos/sin tables (the only point-dependent state).

    Cx[n,k] = cos(k a1 x_n), Sx[n,k] = sin(k a1 x_n) and likewise y; plus the
    per-dim angular frequencies f1[k] = k a1, f2[k] = k a2.
    """

    Cx: jnp.ndarray  # (N, K)
    Sx: jnp.ndarray  # (N, K)
    Cy: jnp.ndarray  # (N, K)
    Sy: jnp.ndarray  # (N, K)
    f1: jnp.ndarray  # (K,)
    f2: jnp.ndarray  # (K,)


def tables(points, K: int, domain) -> BasisTables:
    """Build cos/sin tables for points (N, 2) on ``domain``."""
    rel = points - domain.origin
    a = jnp.pi / domain.lengths  # (2,)
    k = jnp.arange(K, dtype=points.dtype)
    f1 = k * a[0]
    f2 = k * a[1]
    ax = rel[:, 0:1] * f1[None, :]  # (N, K)
    ay = rel[:, 1:2] * f2[None, :]
    return BasisTables(jnp.cos(ax), jnp.sin(ax), jnp.cos(ay), jnp.sin(ay), f1, f2)


def cos_tables(points, K: int, domain):
    """(Cx, Cy) only — for coefficient reductions, which never touch the sin
    tables; halves the table traffic of the big history reductions."""
    rel = points - domain.origin
    a = jnp.pi / domain.lengths
    k = jnp.arange(K, dtype=points.dtype)
    return jnp.cos(rel[:, 0:1] * (k * a[0])[None, :]), jnp.cos(rel[:, 1:2] * (k * a[1])[None, :])


def coefficients_cos(Cx, Cy, weights, hk):
    """Weighted basis expectation from cos tables alone; (K, K)."""
    wc = Cx * weights[:, None]
    ck = jnp.matmul(wc.T, Cy, precision=_EXACT, preferred_element_type=jnp.float32)
    return ck / hk


def coefficients(tbl: BasisTables, weights, hk):
    """Weighted basis expectation: sum_n w_n F_k(p_n); (K, K).

    With ``weights`` summing to 1 this is c_k (trajectory) or phi_k (target).
    fp32 accumulation regardless of table dtype (1e-3 RMS parity,
    SURVEY.md section 8).
    """
    wc = tbl.Cx * weights[:, None]
    ck = jnp.matmul(wc.T, tbl.Cy, precision=_EXACT, preferred_element_type=jnp.float32)
    return ck / hk


def fourier_basis_at(tbl: BasisTables, hk):
    """Dense F_k per point: (N, K, K). For tests/viz only — the hot path
    never materializes this."""
    return (tbl.Cx[:, :, None] * tbl.Cy[:, None, :]) / hk[None, :, :]


def dense_table(tbl: BasisTables, hk):
    """Flattened dense basis table D[n, k1*K + k2] = F_k(p_n): (N, K^2).

    For a sample lattice SHARED across scenarios (the common batched-target
    case) this is the batched phi_k layout: computed once (~K^2 * N * 4
    bytes), after which a batch of targets reduces in ONE (S, N) @ (N, K^2)
    matmul — no per-scenario (N, K) tables and no (S, N, K)
    intermediates. See Engine.phik_from_gmm.
    """
    N, K = tbl.Cx.shape
    return fourier_basis_at(tbl, hk).reshape(N, K * K)


def axis_cos_tables(K: int, grid_samples, domain):
    """Per-axis lattice cosine tables (cosx (nsx, K), cosy (nsy, K)) for the
    SEPARABLE lattice of ``Domain.sample_lattice`` — the inputs of
    :func:`coefficients_separable`."""
    nsx, nsy = grid_samples
    k = jnp.arange(K, dtype=jnp.float32)
    fx = (jnp.arange(nsx, dtype=jnp.float32) + 0.5) / nsx * domain.lengths[0]
    fy = (jnp.arange(nsy, dtype=jnp.float32) + 0.5) / nsy * domain.lengths[1]
    cosx = jnp.cos(fx[:, None] * (k * jnp.pi / domain.lengths[0])[None, :])
    cosy = jnp.cos(fy[:, None] * (k * jnp.pi / domain.lengths[1])[None, :])
    return cosx, cosy


def coefficients_separable(phi_grid, cosx, cosy, hk):
    """Batched RAW basis contraction on a separable sample lattice:
    ck_raw[s, k1, k2] = sum_{ix, iy} phi[s, ix, iy] cosx[ix, k1] cosy[iy, k2] / hk.

    The lattice of ``Domain.sample_lattice`` is an outer product of per-axis
    points, so the dense (N, K^2) table contraction factorizes into TWO
    small matmuls — (S*nsx, nsy)@(nsy, K) then (S*K, nsx)@(nsx, K) — ~9x
    fewer flops at K=10, N=10^4 than the dense path, full fp32.
    ``ck_raw[s, 0, 0] * hk[0, 0]`` is sum(phi) (cos 0 = 1), so the caller
    normalizes for free. phi_grid: (S, nsx, nsy) — x-major, the reshape of
    the (S, N) lattice values."""
    A = jnp.einsum("sxy,yl->sxl", phi_grid, cosy,
                   precision=_EXACT, preferred_element_type=jnp.float32)
    ck = jnp.einsum("sxl,xk->skl", A, cosx,
                    precision=_EXACT, preferred_element_type=jnp.float32)
    return ck / hk[None, :, :]


def coefficients_dense(phi_batch, D, K: int):
    """Batched coefficients via the dense table: (S, N) @ (N, K^2) -> (S, K, K).

    HIGH precision with fp32 accumulation. On the H100 HIGH runs as one
    TF32 pass: 3.1e-4 of the largest coefficient on the (4096, 10k)
    refresh shapes, and the tick's controls stay at 1.1e-6 RMS from the
    NumPy oracle (H100 measurements in PERF.md) — inside the 1e-3 parity
    budget."""
    S = phi_batch.shape[0]
    out = jnp.matmul(
        phi_batch, D, precision=jax.lax.Precision.HIGH, preferred_element_type=jnp.float32
    )
    return out.reshape(S, K, K)


def ergodic_metric(ck, phik, lam):
    """E = sum_k Lambda_k (c_k - phi_k)^2."""
    d = ck - phik
    return jnp.sum(lam * d * d)


def ergodic_gradient(tbl: BasisTables, ck, phik, lam, hk, M):
    """dE/dp_m = (2/M) sum_k Lambda_k (c_k - phi_k) grad F_k(p_m); (N, 2).

    ``M`` is the total state count behind c_k (history + rollout); gradients
    are evaluated only at the N rollout points in ``tbl``.
    """
    Wh = (lam * (ck - phik)) / hk  # (K, K)
    # e_x: contract k2 first, then weighted row-sum over k1
    Px = jnp.matmul(tbl.Cy, Wh.T, precision=_EXACT, preferred_element_type=jnp.float32)  # (N, K1)
    ex = -(2.0 / M) * jnp.sum(tbl.Sx * tbl.f1[None, :] * Px, axis=-1)
    # e_y: contract k1 first, then weighted row-sum over k2
    Py = jnp.matmul(tbl.Cx, Wh, precision=_EXACT, preferred_element_type=jnp.float32)  # (N, K2)
    ey = -(2.0 / M) * jnp.sum(tbl.Sy * tbl.f2[None, :] * Py, axis=-1)
    return jnp.stack([ex, ey], axis=-1)
