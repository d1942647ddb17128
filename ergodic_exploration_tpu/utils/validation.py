"""Runtime guards for the engine's shared-geometry contracts.

Two engine fast paths promise that every scenario shares one geometry and
silently compute wrong physics if a caller violates that promise
(VERDICT r3 weak 3 / next-round 4):

- ``cfg.shared_maps``: the GMM refresh folds row 0's free mask into the
  dense basis table (engine._phik_from_gmm_fn), so every scenario's world
  must be row 0's.
- the dense MI refresh (``engine._phik_grid_batch_dense_fn``): sampling and
  blur matrices are built from scenario 0's grid geometry.

These helpers enforce the contracts LOUDLY at the Python API edge. They
check concrete (host-visible) arrays only — inside a trace (``jax.jit``)
values are symbolic and the caller upstream already validated the concrete
operands. Results are cached per array object id, so per-tick calls with
the same world/grids cost one dict lookup, and the full-map equality
readback happens once per distinct map object (map cadence, not tick
cadence).
"""

from __future__ import annotations

from typing import Any

import numpy as np

# id(array) -> True for leaves already validated. A dead id being reused by
# a new array can only SKIP a re-check (a missed diagnostic, never wrong
# math), so plain ids are acceptable; keep the cache bounded regardless.
_VALIDATED: dict[int, bool] = {}
_CACHE_MAX = 4096


def _is_concrete(x: Any) -> bool:
    import jax

    if isinstance(x, jax.core.Tracer):
        return False
    if isinstance(x, jax.Array):
        return x.is_fully_addressable
    return True


def _rows_equal(a, what: str, atol: float = 0.0) -> None:
    """Raise ValueError unless every leading-axis row of ``a`` equals row 0."""
    arr = np.asarray(a)
    if arr.ndim < 1 or arr.shape[0] <= 1:
        return
    flat = arr.reshape(arr.shape[0], -1)
    if atol:
        bad = np.flatnonzero(np.max(np.abs(flat - flat[0]), axis=1) > atol)
    else:
        bad = np.flatnonzero(np.any(flat != flat[0], axis=1))
    if bad.size:
        raise ValueError(
            f"shared-geometry contract violated: {what} differs from scenario 0 "
            f"at scenario indices {bad[:8].tolist()}"
            f"{' ...' if bad.size > 8 else ''} — every scenario must share one "
            f"geometry on this path (cfg.shared_maps / shared-domain dense "
            f"refresh). Use the per-scenario path (shared_maps=False / no "
            f"shared domain) for heterogeneous worlds."
        )


def check_rows_shared(tree, what: str) -> None:
    """Validate that every leaf of ``tree`` is identical across its leading
    (scenario) axis. Skips traced values; caches by object id."""
    import jax

    leaves = jax.tree.leaves(tree)
    if not all(_is_concrete(leaf) for leaf in leaves):
        return  # symbolic: the concrete operands were checked upstream
    key = tuple(id(leaf) for leaf in leaves)
    h = hash((what, key))
    if _VALIDATED.get(h):
        return
    for leaf in leaves:
        _rows_equal(leaf, what)
    if len(_VALIDATED) >= _CACHE_MAX:
        _VALIDATED.clear()
    _VALIDATED[h] = True


def check_shared_world(world, what: str = "world.dist") -> None:
    """``cfg.shared_maps`` contract: all scenarios share one distance field
    (map data, origin, resolution) and free mask."""
    check_rows_shared(
        {
            "dist": world.dist.dist,
            "origin": world.dist.origin,
            "resolution": world.dist.resolution,
            "free_mask": world.free_mask,
        },
        what,
    )


def check_shared_grid_geometry(grids, what: str = "grids") -> None:
    """Dense-refresh contract: all grids share origin/resolution/shape (the
    sampling + blur matrices are built from scenario 0's geometry). Map DATA
    may differ — only the geometry must be shared."""
    check_rows_shared(
        {"origin": grids.origin, "resolution": grids.resolution}, what
    )
