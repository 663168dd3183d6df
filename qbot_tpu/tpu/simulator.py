"""Jitted statevector / density-matrix executors for compiled plans.

The complex-dtype compute path (replaces the reference hot loop of
``genGateForFullHilbertSpace`` + ``applyGate``, qgates.py:161-182,278-279):

* state = rank-n ``(2,)*n`` complex64 tensor (density = rank-2n), static
  shapes only;
* each :class:`WindowStep` is one ``(2^a, 2^w, 2^b) × (2^w, 2^w)`` batched
  matmul on the MXU — one HBM pass applies every gate fused into the
  window;
* :class:`DiagStep` is one elementwise broadcast multiply;
* repeated structures (e.g. Grover iterations) run under ``lax.scan`` so
  the program compiles once per distinct iteration body.

Everything here traces cleanly under ``jit``/``vmap``/``shard_map``; qubit
indices and window layouts are static Python ints baked into the trace.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

from qbot_tpu.ops.gates import controlled as _controlled_np
from qbot_tpu.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    Plan,
    ReflectStep,
    Term,
    WindowStep,
    compile_circuit,
    expand_phases,
    expand_reflections,
)

__all__ = ["zero_state", "fold_window", "apply_plan", "apply_plan_density",
            "make_statevector_runner", "make_density_runner",
            "make_scanned_runner", "computation_probs", "expectation_z"]

DTYPE = jnp.complex64


def zero_state(n: int, dtype=DTYPE) -> jnp.ndarray:
    psi = jnp.zeros(2**n, dtype=dtype)
    return psi.at[0].set(1.0)


def _controlled_jnp(mat, num_controls: int):
    size = mat.shape[0]
    dim = (2**num_controls) * size
    out = jnp.eye(dim, dtype=mat.dtype)
    return out.at[dim - size:, dim - size:].set(mat)


def _combine_planar(stacked, dtype):
    """Makers return planar (2, d, d) stacks; recombine to complex."""
    return (stacked[0] + 1j * stacked[1]).astype(dtype)


def _term_matrix(term: Term, params, dtype) -> jnp.ndarray:
    if term.matrix is not None:
        return jnp.asarray(term.matrix, dtype=dtype)
    mat = term.maker(params[term.param_idx])
    mat = _combine_planar(mat, dtype) if mat.ndim == 3 else mat.astype(dtype)
    if term.num_controls:
        mat = _controlled_jnp(mat, term.num_controls)
    return mat


def fold_window(step: WindowStep, params, dtype=DTYPE) -> jnp.ndarray:
    """Fold all of a window's terms into one 2^w × 2^w unitary.

    The fold itself is tiny (≤128×128 contractions) and happens inside the
    trace, so parameterised gates differentiate/vmap for free.
    """
    w = step.width
    dim = 2**w
    # W viewed as (2,)*w row axes ⊗ flattened column axis; each term is
    # contracted over its window-relative row axes.
    W = jnp.eye(dim, dtype=dtype).reshape((2,) * w + (dim,))
    for term in step.terms:
        m = _term_matrix(term, params, dtype)
        k = len(term.positions)
        g = m.reshape((2,) * (2 * k))
        W = jnp.tensordot(g, W, axes=(list(range(k, 2 * k)),
                                      list(term.positions)))
        W = jnp.moveaxis(W, list(range(k)), list(term.positions))
    return W.reshape(dim, dim)


def _apply_window(psi: jnp.ndarray, n: int, step: WindowStep, params):
    if step.pre_flips:
        flat = psi.reshape(-1)
        for m in step.pre_flips:
            flat = flat.at[m].multiply(-1)
        psi = flat.reshape(psi.shape)
    W = fold_window(step, params, psi.dtype)
    dim = 2**step.width
    a = 2**step.start
    psi3 = psi.reshape(a, dim, -1)
    out = jnp.einsum("ij,ajb->aib", W, psi3, precision=_PREC)
    return out.reshape(psi.shape)


def _diag_tensor(step: DiagStep, n: int, dtype=DTYPE) -> jnp.ndarray:
    """Reshape the diag phase vector for broadcast over non-target axes."""
    k = len(step.targets)
    d = jnp.asarray(step.diag, dtype=dtype)
    return jnp.moveaxis(d.reshape((2,) * k + (1,) * (n - k)),
                        list(range(k)), list(step.targets))


def _apply_diag(psi: jnp.ndarray, n: int, step: DiagStep):
    d = _diag_tensor(step, n, psi.dtype)
    t = psi.reshape((2,) * n)
    return (t * d).reshape(psi.shape)


def _apply_contract(psi: jnp.ndarray, n: int, step: ContractStep, params):
    if step.matrix is not None:
        m = jnp.asarray(step.matrix, dtype=psi.dtype)
    else:
        m = step.maker(params[step.param_idx])
        m = (_combine_planar(m, psi.dtype) if m.ndim == 3
             else m.astype(psi.dtype))
        if step.num_controls:
            m = _controlled_jnp(m, step.num_controls)
    k = len(step.targets)
    g = m.reshape((2,) * (2 * k))
    t = psi.reshape((2,) * n)
    t = jnp.tensordot(g, t, axes=(list(range(k, 2 * k)), list(step.targets)))
    t = jnp.moveaxis(t, list(range(k)), list(step.targets))
    return t.reshape(psi.shape)


def _apply_reflect(psi: jnp.ndarray, step: ReflectStep):
    """ψ → Fψ − 2⟨v|Fψ⟩v for product |v⟩ = ⊗ factors (complex dtype);
    F = fused pre-flip sign flips, applied as O(1) scalar corrections."""
    from qbot_tpu.tpu.planar import reflect_component

    dims = tuple(f.shape[0] for f in step.factors)
    flat = psi.reshape(-1)
    t = psi.reshape(dims)
    c = t
    for f in step.factors:
        c = jnp.tensordot(jnp.conj(jnp.asarray(f, psi.dtype)), c,
                          axes=(0, 0))
    flip_vals = []
    for m in step.pre_flips:
        vm = reflect_component(step.factors, m)
        pm = flat[m]
        c = c - 2.0 * np.conj(vm) * pm
        flip_vals.append((m, pm))
    v = jnp.asarray(1.0, psi.dtype)
    for ax, f in enumerate(step.factors):
        shape = [1] * len(dims)
        shape[ax] = dims[ax]
        v = v * jnp.asarray(f, psi.dtype).reshape(shape)
    out = (t - 2.0 * c * v).reshape(-1)
    for m, pm in flip_vals:
        out = out.at[m].add(-2.0 * pm)
    return out.reshape(psi.shape)


def apply_plan(psi: jnp.ndarray, plan: Plan, params=None) -> jnp.ndarray:
    """Run a compiled plan over a statevector (traceable)."""
    n = plan.n
    for step in expand_phases(plan.steps):
        if isinstance(step, WindowStep):
            psi = _apply_window(psi, n, step, params)
        elif isinstance(step, ReflectStep):
            psi = _apply_reflect(psi, step)
        elif isinstance(step, DiagStep):
            psi = _apply_diag(psi, n, step)
        elif isinstance(step, FlipStep):
            flat = psi.reshape(-1)
            psi = flat.at[step.index].multiply(-1).reshape(psi.shape)
        else:
            psi = _apply_contract(psi, n, step, params)
    return psi


def apply_plan_density(rho: jnp.ndarray, plan: Plan, params=None) -> jnp.ndarray:
    """Run a compiled plan over a density matrix: ρ → U ρ U† step by step."""
    n = plan.n
    flat = rho.reshape(-1)          # rank-2n tensor flattened
    for step in expand_phases(expand_reflections(plan.steps)):
        if isinstance(step, WindowStep):
            if step.pre_flips:
                d = 2**n
                m2 = flat.reshape(d, d)
                for m in step.pre_flips:
                    m2 = m2.at[m, :].multiply(-1)
                    m2 = m2.at[:, m].multiply(-1)
                flat = m2.reshape(-1)
            W = fold_window(step, params, rho.dtype)
            dim = 2**step.width
            # rows: axes [step.start, ...) of the first n
            a = 2**step.start
            t = flat.reshape(a, dim, -1)
            t = jnp.einsum("ij,ajb->aib", W, t, precision=_PREC)
            # cols: same axes offset by n; conjugate (not transposed) factor
            a2 = 2 ** (n + step.start)
            t = t.reshape(a2, dim, -1)
            t = jnp.einsum("ij,ajb->aib", jnp.conj(W), t, precision=_PREC)
            flat = t.reshape(-1)
        elif isinstance(step, FlipStep):
            d = 2**n
            m = flat.reshape(d, d)
            m = m.at[step.index, :].multiply(-1)
            m = m.at[:, step.index].multiply(-1)
            flat = m.reshape(-1)
        elif isinstance(step, DiagStep):
            d_row = _diag_tensor(step, n, rho.dtype)
            t = flat.reshape((2,) * (2 * n))
            col_targets = tuple(n + q for q in step.targets)
            d_col = _diag_tensor(DiagStep(col_targets, np.conj(step.diag)),
                                 2 * n, rho.dtype)
            t = t * d_row.reshape(d_row.shape + (1,) * n) * d_col
            flat = t.reshape(-1)
        else:
            m = (jnp.asarray(step.matrix, dtype=rho.dtype)
                 if step.matrix is not None else None)
            if m is None:
                m = step.maker(params[step.param_idx])
                m = (_combine_planar(m, rho.dtype) if m.ndim == 3
                     else m.astype(rho.dtype))
                if step.num_controls:
                    m = _controlled_jnp(m, step.num_controls)
            k = len(step.targets)
            g = m.reshape((2,) * (2 * k))
            t = flat.reshape((2,) * (2 * n))
            t = jnp.tensordot(g, t, axes=(list(range(k, 2 * k)),
                                          list(step.targets)))
            t = jnp.moveaxis(t, list(range(k)), list(step.targets))
            gc = jnp.conj(g)
            col_axes = [n + q for q in step.targets]
            t = jnp.tensordot(gc, t, axes=(list(range(k, 2 * k)), col_axes))
            t = jnp.moveaxis(t, list(range(k)), col_axes)
            flat = t.reshape(-1)
    d = 2**n
    return flat.reshape(d, d)


# ---------------------------------------------------------------------------
# runner factories
# ---------------------------------------------------------------------------

def make_statevector_runner(plan: Plan):
    """jitted ``(psi, params?) -> psi`` for one plan."""
    @jax.jit
    def run(psi, params=None):
        return apply_plan(psi, plan, params)
    return run


def make_density_runner(plan: Plan):
    @jax.jit
    def run(rho, params=None):
        return apply_plan_density(rho, plan, params)
    return run


def make_scanned_runner(body_plan: Plan, repeats: int,
                        init_plan: Optional[Plan] = None):
    """jitted runner applying ``init_plan`` once then ``body_plan`` × repeats.

    The body compiles once and runs under ``lax.scan`` — this is how
    fixed-point iterations (Grover, trotter steps) scale to thousands of
    repetitions without giant XLA programs.
    """
    @jax.jit
    def run(psi, params=None):
        if init_plan is not None:
            psi = apply_plan(psi, init_plan, params)

        def step(carry, _):
            return apply_plan(carry, body_plan, params), None

        psi, _ = jax.lax.scan(step, psi, None, length=repeats)
        return psi
    return run


# ---------------------------------------------------------------------------
# readout
# ---------------------------------------------------------------------------

def computation_probs(psi: jnp.ndarray, targets=None, n: Optional[int] = None):
    """Marginal computation-basis outcome probabilities for ``targets``."""
    if n is None:
        n = int(np.log2(psi.shape[-1])) if psi.ndim == 1 else psi.ndim
    p = jnp.abs(psi.reshape((2,) * n)) ** 2
    if targets is None:
        return p.reshape(-1)
    targets = sorted(targets)
    other = tuple(q for q in range(n) if q not in targets)
    marg = jnp.sum(p, axis=other) if other else p
    return marg.reshape(-1)


def expectation_z(psi: jnp.ndarray, qubit: int, n: Optional[int] = None):
    """⟨Z_q⟩ of a statevector."""
    if n is None:
        n = int(np.log2(psi.shape[-1]))
    p = jnp.abs(psi.reshape((2,) * n)) ** 2
    marg = jnp.sum(p, axis=tuple(q for q in range(n) if q != qubit))
    return marg[0] - marg[1]
