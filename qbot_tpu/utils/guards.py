"""Numeric sanitizers (the race-detection/sanitizer slot, SURVEY.md §5).

The reference is single-threaded with nothing to race; the device-side
equivalents are numeric-health guards: NaN/Inf checks on engine outputs
(checkify-style, usable inside jit) and norm-drift audits on unitary
evolution.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["assert_finite", "check_norm", "checked", "NumericError"]


class NumericError(RuntimeError):
    """A state tensor failed a numeric-health check."""


def assert_finite(x, name: str = "array"):
    """Host-side NaN/Inf check (outside jit)."""
    arr = np.asarray(x)
    if not np.all(np.isfinite(arr)):
        bad = int(np.size(arr) - np.sum(np.isfinite(arr)))
        raise NumericError(f"{name}: {bad} non-finite elements")
    return x


def check_norm(state, atol: float = 1e-3, name: str = "state"):
    """Norm-drift audit for pure states (planar or complex, host-side)."""
    arr = np.asarray(state)
    if arr.ndim == 2 and arr.shape[0] == 2:          # planar
        norm = float(np.sum(arr[0] ** 2 + arr[1] ** 2))
    else:
        norm = float(np.sum(np.abs(arr) ** 2))
    if abs(norm - 1.0) > atol:
        raise NumericError(f"{name}: norm drifted to {norm:.6f}")
    return state


def checked(fn):
    """Wrap a jitted state transformation with an in-graph finiteness check.

    Uses jax.experimental.checkify so the check lives inside the compiled
    program; call the returned function to get (error, value) and raise via
    ``error.throw()``.
    """
    from jax.experimental import checkify

    def body(*args, **kwargs):
        out = fn(*args, **kwargs)
        leaves = jax.tree.leaves(out)
        for leaf in leaves:
            if jnp.issubdtype(leaf.dtype, jnp.floating) or \
               jnp.issubdtype(leaf.dtype, jnp.complexfloating):
                checkify.check(jnp.all(jnp.isfinite(jnp.real(leaf))),
                               "non-finite value in engine output")
        return out

    return checkify.checkify(body)
