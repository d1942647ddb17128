"""Compilation startup-cost management (SURVEY.md sections 4.1 and 8 P4).

The reference pays its startup cost in rosparam loading; this framework pays
it in XLA compilation. Two tools:

- :func:`enable_persistent_cache` — on-disk XLA compile cache so a process
  restart with the same config skips compilation.
- :meth:`Engine.warmup` (engine.py) — deliberately compiles the hot
  entry points at startup with dummy data, so the first real tick never
  stalls (the build-side analog of the node's construct-everything init).
"""

from __future__ import annotations

import os

import jax

# Fixed in-checkout default: the cache directory is part of what makes a
# later process find an entry, so it must not move between runs.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache(path: str | None = None) -> str:
    """Turn on XLA's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here: the cache lives there and nowhere else.
    Otherwise the cache goes to ``path`` or, by default, to ``.jax_cache``
    at the root of the checkout (a fixed path; listed in .gitignore).
    Idempotent. Compiled executables are keyed by HLO + compiler version,
    so hits are exact.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = path or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache small programs too: the single-robot step is tiny but its
    # compile latency is exactly what the 10 Hz loop cares about
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
