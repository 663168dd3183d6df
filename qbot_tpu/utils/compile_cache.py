"""Persistent XLA compilation cache.

Compiling a 26-qubit program's executables takes seconds to minutes per
process; JAX's persistent compilation cache turns a repeat compile into
a load, so every device entry point enables it.

Where the cache lives, first match wins:

1. ``QBOT_TPU_COMPILE_CACHE=off`` disables it;
2. ``JAX_COMPILATION_CACHE_DIR``, when set, is the only directory used:
   JAX reads it itself and this module sets no directory in code;
3. ``QBOT_TPU_COMPILE_CACHE=<dir>``;
4. ``.jax_cache/`` at the repo root (a fixed path, since the path is
   part of the cache key).
"""
from __future__ import annotations

import os
from pathlib import Path

_DEFAULT = Path(__file__).resolve().parents[2] / ".jax_cache"
_enabled = False


def cache_dir(path: str | None = None) -> str | None:
    """The cache directory by the precedence above, or None when off."""
    env = os.environ.get("QBOT_TPU_COMPILE_CACHE")
    if env == "off":
        return None
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR") or path or env
            or str(_DEFAULT))


def enable_compile_cache(path: str | None = None) -> str | None:
    """Enable JAX's persistent compilation cache (idempotent).

    Returns the cache directory, or None when disabled via the
    ``QBOT_TPU_COMPILE_CACHE=off`` environment variable.
    """
    global _enabled
    target = cache_dir(path)
    if target is None or _enabled:
        return target
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", target)
    # keep tiny helper jits (under half a second to compile) out of it
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _enabled = True
    return target


def cache_is_warm(path: str | None = None) -> bool:
    """True when the cache directory already holds compiled executables.

    NOTE: this says nothing about whether a *given program* will hit the
    cache (the directory may hold only other programs' entries) — use
    :class:`CacheHitProbe` for per-workload evidence.
    """
    target = cache_dir(path)
    if target is None:
        return False
    target = Path(target)
    return target.is_dir() and any(target.iterdir())


_counters = {"hits": 0, "misses": 0}
_listener_installed = False


def _cache_event_listener(event: str, **kwargs) -> None:
    if event == "/jax/compilation_cache/cache_hits":
        _counters["hits"] += 1
    elif event == "/jax/compilation_cache/cache_misses":
        _counters["misses"] += 1


def install_cache_hit_listener() -> None:
    """Count JAX's persistent-cache hit/miss monitoring events (idempotent)."""
    global _listener_installed
    if _listener_installed:
        return
    from jax._src import monitoring

    monitoring.register_event_listener(_cache_event_listener)
    _listener_installed = True


class CacheHitProbe:
    """Context manager recording whether compiles inside it hit the cache.

    Evidence comes from JAX's own monitoring events
    (``/jax/compilation_cache/cache_hits`` / ``cache_misses``), not from
    directory heuristics.  ``hits``/``misses`` are the deltas observed
    inside the block; ``verdict()`` renders them for bench JSON.
    """

    def __enter__(self):
        install_cache_hit_listener()
        self._h0 = _counters["hits"]
        self._m0 = _counters["misses"]
        return self

    def __exit__(self, *exc):
        self.hits = _counters["hits"] - self._h0
        self.misses = _counters["misses"] - self._m0
        return False

    def verdict(self) -> str:
        if self.misses == 0 and self.hits > 0:
            return "hit"
        if self.hits == 0 and self.misses > 0:
            return "miss"
        if self.hits or self.misses:
            return f"partial ({self.hits} hits, {self.misses} misses)"
        return "no-compiles"
