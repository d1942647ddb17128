"""Trajectory-history replay buffer (jit-safe ring buffer).

Reference capability: ``ReplayBuffer`` (``buffer.hpp``): bounded store of
visited states, appended each tick, sampled and concatenated with the
predicted trajectory before computing c_k — so the time-average includes
history and the robot does not re-cover visited space (SURVEY.md sections 2
L3 and 3).

Accelerator-first (SURVEY.md section 8 "replay buffer under jit"): fixed capacity +
write cursor + validity mask — no dynamic shapes anywhere. Two history modes
are exposed via the controller config:

- ``ring``: reference-parity bounded window (forgets once full).
- ``accumulate``: running sum of basis values over ALL visited states — an
  O(K^2)-per-append exact c_k with unbounded effective history; the fast
  path (no per-solve O(capacity K^2) reduction).

Layout notes:
- States are stored TRANSPOSED, (2, capacity), so the capacity axis is the
  long, contiguous one for the append blend and the compaction matmul.
- With-replacement draws use a stateless integer hash (lowbias32) instead
  of vmapped threefry: sampling replay indices needs speed and
  determinism, not cryptographic quality.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


def _raw_key(key):
    """(2,) uint32 words from a raw or typed PRNG key."""
    if hasattr(key, "dtype") and jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return key.astype(jnp.uint32)


def _mix32(h):
    """lowbias32 finalizer — a well-mixed 32-bit integer hash."""
    h = (h ^ (h >> 16)) * jnp.uint32(0x7FEB352D)
    h = (h ^ (h >> 15)) * jnp.uint32(0x846CA68B)
    return h ^ (h >> 16)


def uniform01(key, n: int):
    """n deterministic uniforms in [0, 1) from a PRNG key — stateless hash,
    ~10 elementwise ops/draw (vs a threefry block per 2 draws).

    Uses the top 24 bits so every value is exactly representable in fp32 and
    strictly < 1 (floor(u * count) can never index past the buffer)."""
    k = _raw_key(key)
    i = jnp.arange(n, dtype=jnp.uint32)
    h = _mix32(i * jnp.uint32(2654435761) ^ k[0])
    h = _mix32(h + k[1])
    return (h >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


class RingBuffer(NamedTuple):
    states: jnp.ndarray  # (2, capacity) visited positions, coordinate-major
    cursor: jnp.ndarray  # () int32: next write slot
    count: jnp.ndarray  # () int32: number of valid entries (<= capacity)

    @staticmethod
    def create(capacity: int) -> "RingBuffer":
        return RingBuffer(
            states=jnp.zeros((2, capacity), dtype=jnp.float32),
            cursor=jnp.zeros((), dtype=jnp.int32),
            count=jnp.zeros((), dtype=jnp.int32),
        )

    @property
    def capacity(self) -> int:
        return self.states.shape[1]

    @property
    def positions(self):
        """(capacity, 2) view for point-major consumers (viz, tests)."""
        return self.states.T

    def append(self, p) -> "RingBuffer":
        """Append one visited position (2,); overwrites oldest when full.

        One-hot blend instead of dynamic_update_slice: batched dynamic
        updates with traced offsets lower to a scatter, while the blend is
        pure elementwise work that fuses."""
        cap = self.capacity
        hot = (jnp.arange(cap) == self.cursor)[None, :]  # (1, cap)
        states = jnp.where(hot, p[:2, None], self.states)
        return RingBuffer(
            states=states,
            cursor=(self.cursor + 1) % cap,
            count=jnp.minimum(self.count + 1, cap),
        )

    def valid_mask(self):
        """(capacity,) float mask of live entries."""
        idx = jnp.arange(self.capacity)
        return (idx < self.count).astype(jnp.float32)

    def _draw_indices(self, batch: int, rng):
        """With-replacement batch of valid-entry indices — the ONE draw
        shared by :meth:`sample_mask` and :meth:`sample_states`."""
        u = uniform01(rng, batch)
        return jnp.floor(u * jnp.maximum(self.count, 1).astype(u.dtype)).astype(jnp.int32)

    def sample_mask(self, batch: Optional[int], rng) -> jnp.ndarray:
        """Weights (capacity,) for the c_k history term.

        ``batch=None``: every valid entry, weight 1 (full concat). Otherwise
        a with-replacement batch of ``batch`` valid entries is drawn
        (reference open question Q4 — both behaviors supported) and weights
        are multiplicities so downstream stays fixed-shape.
        """
        mask = self.valid_mask()
        if batch is None:
            return mask
        cap = self.capacity
        idx = self._draw_indices(batch, rng)
        # multiplicity counts via comparison-reduce, NOT scatter-add:
        # .at[idx].add lowers to a scatter under vmap, the (batch, cap)
        # comparison fuses into one elementwise+reduce loop.
        counts = jnp.sum(
            (idx[:, None] == jnp.arange(cap)[None, :]).astype(jnp.float32), axis=0
        )
        return jnp.where(self.count > 0, counts, jnp.zeros(cap))

    def sample_states(self, batch: int, rng):
        """With-replacement batch of states, COMPACTED to (batch, 2).

        Same draw as :meth:`sample_mask` (identical indices for identical
        rng), but returns the sampled states themselves via a one-hot
        matmul — downstream per-state work (basis tables) then runs on
        ``batch`` rows instead of ``capacity`` rows, the hot-path win when
        batch << capacity. Returns (states (batch, 2), n_valid ()).
        """
        cap = self.capacity
        idx = self._draw_indices(batch, rng)
        onehot = (idx[None, :] == jnp.arange(cap)[:, None]).astype(jnp.float32)
        # (2, cap) @ (cap, batch): one small matmul per scenario
        states = jnp.matmul(self.states, onehot, precision=jax.lax.Precision.HIGHEST)
        n = jnp.where(self.count > 0, jnp.float32(batch), 0.0)
        return states.T, n
