"""Per-line wall-time profiling and jax trace contexts.

The reference has no tracing/profiling at all (SURVEY.md §5); this module
supplies the device-side plan: a cheap per-line wall/op report owned by the
interpreter (which already owns line numbers), plus helpers to wrap program
execution in ``jax.profiler`` traces and annotate engine calls with
``jax.named_scope``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_enabled = False
_line_stats: dict[tuple[int, str], list[float]] = defaultdict(list)


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def profiling_enabled():
    """Enable per-line timing for the duration of the context."""
    global _enabled
    _enabled = True
    _line_stats.clear()
    try:
        yield
    finally:
        _enabled = False


def record_line(line_num: int, opcode: str, seconds: float) -> None:
    if _enabled:
        _line_stats[(line_num, opcode)].append(seconds)


def line_profile_report() -> str:
    """Human-readable per-line execution report (hits, total, mean)."""
    rows = ["line  op    hits   total(s)    mean(s)"]
    for (line_num, opcode), times in sorted(_line_stats.items()):
        total = sum(times)
        rows.append(f"{line_num:>4}  {opcode:<4} {len(times):>6} "
                    f"{total:>10.6f} {total / len(times):>10.6f}")
    return "\n".join(rows)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Wrap a region in a jax.profiler trace (TensorBoard-compatible)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def named_scope(name: str):
    """jax.named_scope that degrades to a no-op outside jax."""
    try:
        import jax
        return jax.named_scope(name)
    except Exception:  # pragma: no cover - jax always present in this env
        return contextlib.nullcontext()


_timer = time.perf_counter
