"""Planar-complex executors: the device compute path.

On-device state is stored **planar**: a float32 array of shape
``(2, 2^n)`` holding (real, imag) on the leading axis (density:
``(2, 2^n, 2^n)``).  Every complex operation decomposes into real
arithmetic:

* window matmul: (Wr + iWi)(xr + ixi) → 4 real batched matmuls;
* diagonal step: planar elementwise multiply (one fused pass);
* probabilities: xr² + xi².

Fully-static window steps are fused to a single complex matrix on the host
at compile time (no in-trace folding at all); parameterised terms fold
in-trace with planar products, so HMC gradients flow through float32 only.

Semantically identical to :mod:`qbot_tpu.tpu.simulator` (the complex
executor used on CPU for conformance); tests cross-check the two.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

# XLA's default matmul precision may run f32 operands through reduced-
# precision units; the folding contractions need full f32 — request it
# explicitly.
_PREC = jax.lax.Precision.HIGHEST

from qbot_tpu.ops.gates import controlled as controlled_np
from qbot_tpu.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PhaseStep,
    Plan,
    ReflectStep,
    Term,
    WindowStep,
    phase_as_diag,
)
from qbot_tpu.tpu.dotplan import dot_precision

__all__ = ["zero_state_planar", "to_planar", "from_planar",
           "product_state_planar",
           "apply_plan_planar", "make_planar_runner",
           "planar_window_apply",
           "make_scanned_planar_runner", "planar_probs", "planar_norm",
           "zero_density_planar", "apply_plan_density_planar",
           "make_planar_density_runner", "planar_density_probs"]

REAL_DTYPE = jnp.float32

# Below this flat dimension the host kron + one tiny transfer is cheaper
# than compiling a device build (and keeps small-n conformance tests on
# the exact complex128 host arithmetic).  Above it, building the state on
# the device avoids moving a state-sized array (512 MB at 26 qubits)
# across the host link.
_DEVICE_BUILD_MIN_DIM = 2 ** 16
_PRODUCT_CACHE: dict = {}


def product_state_planar(kets, dtype=np.float32) -> jnp.ndarray:
    """Planar (2, 2^n) normalised product state ⊗kets, built ON DEVICE.

    The reference preps registers by host-side ``np.kron`` chains
    (reference density.py:7-23 via operators.qset); at device scale the
    resulting array need not cross the host↔device boundary — the kron
    chain itself is microseconds of device compute.  Each ket is a
    small host array baked into the jitted build as a literal; one jit
    call materialises the full state directly in HBM.

    Small registers (< ``_DEVICE_BUILD_MIN_DIM`` amplitudes) keep the
    host complex128 kron (bit-identical to the reference's arithmetic,
    no compile churn in tests).
    """
    kets = [np.asarray(k, np.complex128).ravel() for k in kets]
    dim = 1
    for k in kets:
        dim *= k.shape[0]
    if dim < _DEVICE_BUILD_MIN_DIM:
        flat = np.array([1.0 + 0j])
        for k in kets:
            flat = np.kron(flat, k)
        flat = flat / np.linalg.norm(flat)
        return jnp.asarray(to_planar(flat, dtype))

    key = (tuple(k.tobytes() for k in kets), np.dtype(dtype).str)
    fn = _PRODUCT_CACHE.get(key)
    if fn is None:
        planar_kets = [np.stack([k.real, k.imag]).astype(dtype)
                       for k in kets]

        def build():
            r = jnp.ones((1,), dtype)
            i = jnp.zeros((1,), dtype)
            for pk in planar_kets:
                br = jnp.asarray(pk[0])
                bi = jnp.asarray(pk[1])
                nr = (r[:, None] * br[None, :]
                      - i[:, None] * bi[None, :]).reshape(-1)
                ni = (r[:, None] * bi[None, :]
                      + i[:, None] * br[None, :]).reshape(-1)
                r, i = nr, ni
            nrm = jnp.sqrt(jnp.sum(r * r + i * i))
            return jnp.stack([r, i]) / nrm

        fn = jax.jit(build)
        _PRODUCT_CACHE[key] = fn
    return fn()


def zero_state_planar(n: int, dtype=REAL_DTYPE) -> jnp.ndarray:
    psi = jnp.zeros((2, 2**n), dtype=dtype)
    return psi.at[0, 0].set(1.0)


def to_planar(psi_complex: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.stack([np.real(psi_complex), np.imag(psi_complex)]).astype(dtype)


def from_planar(psi: np.ndarray) -> np.ndarray:
    psi = np.asarray(psi)
    return psi[0] + 1j * psi[1]


# ---------------------------------------------------------------------------
# host-side static folding
# ---------------------------------------------------------------------------

def _static_term_matrix(term: Term) -> np.ndarray:
    return np.asarray(term.matrix, dtype=np.complex128)


def fold_window_static(step: WindowStep) -> Optional[np.ndarray]:
    """Fuse a window's terms into one complex matrix on the host.

    Returns None if any term is parameterised.
    """
    if any(t.matrix is None for t in step.terms):
        return None
    w, dim = step.width, 2**step.width
    W = np.eye(dim, dtype=np.complex128).reshape((2,) * w + (dim,))
    for term in step.terms:
        m = _static_term_matrix(term)
        k = len(term.positions)
        g = m.reshape((2,) * (2 * k))
        W = np.tensordot(g, W, axes=(list(range(k, 2 * k)),
                                     list(term.positions)))
        W = np.moveaxis(W, list(range(k)), list(term.positions))
    return W.reshape(dim, dim)


def _planar_pair(mat: np.ndarray, dtype=np.float32):
    return (np.ascontiguousarray(mat.real, dtype=dtype),
            np.ascontiguousarray(mat.imag, dtype=dtype))


# ---------------------------------------------------------------------------
# in-trace planar algebra (for parameterised terms)
# ---------------------------------------------------------------------------

def _planar_controlled(mr, mi, num_controls: int):
    size = mr.shape[0]
    dim = (2**num_controls) * size
    outr = jnp.eye(dim, dtype=mr.dtype)
    outr = outr.at[dim - size:, dim - size:].set(mr)
    outi = jnp.zeros((dim, dim), dtype=mi.dtype)
    outi = outi.at[dim - size:, dim - size:].set(mi)
    return outr, outi


def _term_planar(term: Term, params, dtype):
    if term.matrix is not None:
        m = np.asarray(term.matrix, dtype=np.complex128)
        return (jnp.asarray(m.real, dtype=dtype),
                jnp.asarray(m.imag, dtype=dtype))
    stacked = term.maker(params[term.param_idx])  # (2, 2^k, 2^k) planar
    mr, mi = stacked[0].astype(dtype), stacked[1].astype(dtype)
    if term.num_controls:
        mr, mi = _planar_controlled(mr, mi, term.num_controls)
    return mr, mi


def _fold_contract(gr, gi, Wr, Wi, positions):
    """One planar tensor contraction step of the window fold."""
    k = len(positions)
    ax = (list(range(k, 2 * k)), list(positions))

    def con(g, W):
        out = jnp.tensordot(g.reshape((2,) * (2 * k)), W, axes=ax,
                            precision=_PREC)
        return jnp.moveaxis(out, list(range(k)), list(positions))

    new_r = con(gr, Wr) - con(gi, Wi)
    new_i = con(gr, Wi) + con(gi, Wr)
    return new_r, new_i


def fold_window_planar(step: WindowStep, params, dtype=REAL_DTYPE):
    """(Wr, Wi) for a window with parameterised terms, folded in-trace."""
    w, dim = step.width, 2**step.width
    shape = (2,) * w + (dim,)
    Wr = jnp.eye(dim, dtype=dtype).reshape(shape)
    Wi = jnp.zeros(shape, dtype=dtype)
    for term in step.terms:
        mr, mi = _term_planar(term, params, dtype)
        k = int(np.log2(mr.shape[0]))
        Wr, Wi = _fold_contract(mr, mi, Wr, Wi, term.positions)
    return Wr.reshape(dim, dim), Wi.reshape(dim, dim)


# ---------------------------------------------------------------------------
# step application (the "step" engine: one XLA pass per plan step)
# ---------------------------------------------------------------------------

def _apply_phases_xla(psi, n: int, pre_phases):
    """Apply controlled-phase factors (qubits, z, pattern) as diagonal passes."""
    for qubits, z, pat in pre_phases:
        psi = _apply_diag_planar(psi, n,
                                 phase_as_diag(PhaseStep(qubits, z, pat)))
    return psi


def planar_window_apply(psi, n: int, start: int, width: int, Wr, Wi,
                        pre_flips=(), pre_phases=()):
    """Apply a planar window unitary to a (2, 2^n) planar state.

    ``pre_flips``: basis-state indices whose sign is flipped *before* the
    unitary (Grover-style oracles); ``pre_phases``: controlled-phase
    factors (qubits, z, pattern) applied before it.  The window product
    is four real batched matmuls over the (2^start, 2^width, rest) view,
    at the precision of the current dot mode.
    """
    if pre_phases:
        psi = _apply_phases_xla(psi, n, pre_phases)
    for m in pre_flips:
        psi = psi.at[:, m].multiply(-1)
    prec = dot_precision()
    p3 = psi.reshape(2, 2**start, 2**width, -1)
    pr, pi = p3[0], p3[1]

    def mm(W, x):
        return jnp.einsum("ij,ajb->aib", W, x, precision=prec)

    out_r = mm(Wr, pr) - mm(Wi, pi)
    out_i = mm(Wr, pi) + mm(Wi, pr)
    return jnp.stack([out_r, out_i]).reshape(psi.shape)


def _apply_window_planar(psi, n: int, step: WindowStep, params):
    Wr, Wi = _fold_planar_pair(step, params, psi.dtype)
    return planar_window_apply(psi, n, step.start, step.width, Wr, Wi,
                               step.pre_flips, step.pre_phases)


def _fold_planar_pair(step: WindowStep, params, dtype):
    static = fold_window_static(step)
    if static is not None:
        wr, wi = _planar_pair(static)
        return jnp.asarray(wr), jnp.asarray(wi)
    return fold_window_planar(step, params, dtype)


def reflect_component(factors, index: int) -> complex:
    """Static component ``v[index]`` of the product state |v⟩ = ⊗ factors."""
    v = 1.0 + 0.0j
    shift = sum(int(f.shape[0]).bit_length() - 1 for f in factors)
    for f in factors:
        d = int(f.shape[0])
        shift -= d.bit_length() - 1
        v *= complex(np.asarray(f, np.complex128)[(index >> shift) & (d - 1)])
    return v


def _broadcast_product(factors, dims, dtype):
    """(vr, vi) of |v⟩ = ⊗ factors as broadcastable planar arrays.

    Built axis-by-axis so XLA keeps the product in-register inside whatever
    consumer it fuses into — |v⟩ is never materialised in device memory.
    """
    vr = jnp.asarray(1.0, dtype)
    vi = jnp.asarray(0.0, dtype)
    for ax, f in enumerate(factors):
        fr, fi = _planar_pair(np.asarray(f, np.complex128))
        shape = [1] * len(dims)
        shape[ax] = dims[ax]
        br = jnp.asarray(fr).reshape(shape)
        bi = jnp.asarray(fi).reshape(shape)
        vr, vi = vr * br - vi * bi, vr * bi + vi * br
    return vr, vi


def _apply_reflect_planar(psi, n: int, step: ReflectStep):
    """ψ → Fψ − 2⟨v|Fψ⟩v for product |v⟩ = ⊗ factors, F = fused sign flips.

    Two passes over the state: the ⟨v|ψ⟩ contraction as ONE fused
    elementwise multiply-reduce over the flat state, then one fused
    elementwise rank-1 update.  The fused pre-flips (oracle) are exact
    O(1) scalar corrections: a flipped basis state shifts ⟨v|Fψ⟩ by
    −2·conj(v_m)·ψ_m and the output at index m by −2·ψ_m.  Plain JAX
    ops throughout, so gradients need no custom rule.
    """
    dims = tuple(f.shape[0] for f in step.factors)
    pr = psi[0].reshape(dims)
    pi = psi[1].reshape(dims)
    vr, vi = _broadcast_product(step.factors, dims, psi.dtype)

    # c = ⟨v|ψ⟩ = Σ conj(v)·ψ — one fused read pass
    cr = jnp.sum(vr * pr + vi * pi)
    ci = jnp.sum(vr * pi - vi * pr)

    # fused-flip scalar corrections: c ← c − 2·conj(v_m)·ψ_m
    flip_vals = []
    for m in step.pre_flips:
        vm = reflect_component(step.factors, m)
        pmr, pmi = psi[0, m], psi[1, m]
        cr = cr - 2.0 * (vm.real * pmr + vm.imag * pmi)
        ci = ci - 2.0 * (vm.real * pmi - vm.imag * pmr)
        flip_vals.append((m, pmr, pmi))

    sr = 2.0 * (cr * vr - ci * vi)
    si = 2.0 * (cr * vi + ci * vr)
    out = jnp.stack([(pr - sr).reshape(-1), (pi - si).reshape(-1)])
    # output corrections at flipped indices: (Fψ)_m = −ψ_m
    for m, pmr, pmi in flip_vals:
        out = out.at[0, m].add(-2.0 * pmr)
        out = out.at[1, m].add(-2.0 * pmi)
    return out


def _diag_grouped_views(n: int, targets, diag):
    """(state view shape, broadcast dr, broadcast di) for a diagonal step.

    Groups the n qubit axes into runs of consecutive targets separated by
    gap blocks, so the state reshapes to a FEW large dims instead of
    (2,)*n (a rank-n view forces XLA to materialise high-rank transposed
    intermediates).
    """
    k = len(targets)
    order = sorted(range(k), key=lambda j: targets[j])
    srt = [targets[j] for j in order]
    d = np.asarray(diag, dtype=np.complex128).reshape((2,) * k)
    d = np.transpose(d, order)            # axis i ↔ srt[i]

    runs: list[tuple[int, int]] = []      # (first qubit, length)
    for q in srt:
        if runs and q == runs[-1][0] + runs[-1][1]:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((q, 1))

    view: list[int] = [2]                 # leading planar axis
    bshape: list[int] = [1]
    pos = 0
    for start, length in runs:
        if start > pos:                   # gap block
            view.append(2 ** (start - pos))
            bshape.append(1)
        view.append(2 ** length)
        bshape.append(2 ** length)
        pos = start + length
    if pos < n:                           # tail block
        view.append(2 ** (n - pos))
        bshape.append(1)
    d = d.reshape(bshape[1:])
    dr, di = _planar_pair(d)
    return tuple(view), dr, di


def _apply_diag_planar(psi, n: int, step: DiagStep):
    view, dr, di = _diag_grouped_views(n, step.targets, step.diag)
    t = psi.reshape(view)
    pr, pi = t[0], t[1]
    out_r = dr * pr - di * pi
    out_i = dr * pi + di * pr
    return jnp.stack([out_r, out_i]).reshape(psi.shape)


def _apply_contract_planar(psi, n: int, step: ContractStep, params):
    if step.matrix is not None:
        m = np.asarray(step.matrix, dtype=np.complex128)
        gr, gi = (jnp.asarray(x) for x in _planar_pair(m))
    else:
        stacked = step.maker(params[step.param_idx])
        gr, gi = stacked[0].astype(psi.dtype), stacked[1].astype(psi.dtype)
        if step.num_controls:
            gr, gi = _planar_controlled(gr, gi, step.num_controls)
    k = len(step.targets)
    ax = (list(range(k, 2 * k)), list(step.targets))

    def con(g, x):
        out = jnp.tensordot(g.reshape((2,) * (2 * k)), x, axes=ax,
                            precision=_PREC)
        return jnp.moveaxis(out, list(range(k)), list(step.targets))

    t = psi.reshape((2,) + (2,) * n)
    pr, pi = t[0], t[1]
    out_r = con(gr, pr) - con(gi, pi)
    out_i = con(gr, pi) + con(gi, pr)
    return jnp.stack([out_r, out_i]).reshape(psi.shape)


def apply_plan_planar(psi: jnp.ndarray, plan: Plan, params=None) -> jnp.ndarray:
    """Run a compiled plan over a planar (2, 2^n) statevector (traceable).

    Honours ``plan.engine == "dot"`` (set by the auto-compiler) by
    routing through the axis-scheduled dot executor; its cycle restore
    leaves the output in canonical layout, so semantics are identical.
    """
    if plan.engine == "dot":
        from qbot_tpu.tpu.dotplan import apply_plan_dot, lower_dot_plan

        lowered = lower_dot_plan(plan)
        if lowered is not None:
            return apply_plan_dot(psi, lowered, params)
    n = plan.n
    for step in plan.steps:
        if isinstance(step, WindowStep):
            psi = _apply_window_planar(psi, n, step, params)
        elif isinstance(step, ReflectStep):
            psi = _apply_reflect_planar(psi, n, step)
        elif isinstance(step, DiagStep):
            psi = _apply_diag_planar(psi, n, step)
        elif isinstance(step, PhaseStep):
            psi = _apply_diag_planar(psi, n, phase_as_diag(step))
        elif isinstance(step, FlipStep):
            psi = psi.at[:, step.index].multiply(-1)
        else:
            psi = _apply_contract_planar(psi, n, step, params)
    return psi


# ---------------------------------------------------------------------------
# planar density-matrix executor
#
# ρ is a planar (2, 2^n, 2^n) float32 stack, and every plan step applies
# to the ROW qubit axes then (conjugated) to the COLUMN axes.  Viewing ρ
# flat as a planar (2, 4^n) "state", a window on rows is a window at
# position s of a 2n-qubit register and a window on columns one at
# position n+s — the SAME window formulation serves both sides, so
# density mode costs exactly 2× the statevector passes.
# ---------------------------------------------------------------------------

def zero_density_planar(n: int, dtype=REAL_DTYPE) -> jnp.ndarray:
    rho = jnp.zeros((2, 2**n, 2**n), dtype=dtype)
    return rho.at[0, 0, 0].set(1.0)


def _density_flips(rho, flips):
    """Sign-flip rows and columns of basis states (ρ → F ρ F with F=diag±1)."""
    for m in flips:
        rho = rho.at[:, m, :].multiply(-1)
        rho = rho.at[:, :, m].multiply(-1)
    return rho


def _window_both_sides(flat, n, start, width, Wr, Wi):
    flat = planar_window_apply(flat, 2 * n, start, width, Wr, Wi)
    return planar_window_apply(flat, 2 * n, n + start, width, Wr, -Wi)


def apply_plan_density_planar(rho: jnp.ndarray, plan: Plan,
                              params=None) -> jnp.ndarray:
    """Run a compiled plan over a planar (2, 2^n, 2^n) density matrix.

    Honours ``plan.engine == "dot"``: ρ flat is a 2n-qubit planar
    "state" and the step stream rewrites to a 2n-qubit plan (rows +
    conjugated columns, :func:`qbot_tpu.tpu.dotplan.density_plan_2n`)
    that the in-place dot engine executes.
    """
    n = plan.n
    d = 2**n
    shape = rho.shape
    flat = rho.reshape(2, -1)
    if plan.engine == "dot":
        from qbot_tpu.tpu.dotplan import (
            apply_plan_dot,
            density_plan_2n,
            lower_dot_plan,
        )

        big = density_plan_2n(plan)
        lowered = None if big is None else lower_dot_plan(big)
        if lowered is not None:
            return apply_plan_dot(flat, lowered, params).reshape(shape)
    from qbot_tpu.tpu.compiler import expand_phases, expand_reflections

    for step in expand_phases(expand_reflections(plan.steps)):
        if isinstance(step, WindowStep):
            if step.pre_flips:
                flat = _density_flips(flat.reshape(2, d, d),
                                      step.pre_flips).reshape(2, -1)
            Wr, Wi = _fold_planar_pair(step, params, flat.dtype)
            flat = _window_both_sides(flat, n, step.start, step.width, Wr, Wi)
        elif isinstance(step, DiagStep):
            flat = _apply_diag_planar(flat, 2 * n, step)
            col = DiagStep(tuple(n + q for q in step.targets),
                           np.conj(np.asarray(step.diag)))
            flat = _apply_diag_planar(flat, 2 * n, col)
        elif isinstance(step, FlipStep):
            flat = _density_flips(flat.reshape(2, d, d),
                                  (step.index,)).reshape(2, -1)
        else:
            flat = _apply_contract_planar(flat, 2 * n, step, params)
            col = ContractStep(tuple(n + q for q in step.targets),
                               None if step.matrix is None
                               else np.conj(np.asarray(step.matrix)),
                               step.param_idx,
                               (None if step.maker is None else
                                _conj_maker(step.maker)),
                               step.num_controls)
            flat = _apply_contract_planar(flat, 2 * n, col, params)
    return flat.reshape(shape)


def _conj_maker(maker):
    """Wrap a planar (2, d, d) gate maker to produce the conjugate gate."""
    def conj(theta):
        stacked = maker(theta)
        return jnp.stack([stacked[0], -stacked[1]])
    return conj


def make_planar_density_runner(plan: Plan):
    @jax.jit
    def run(rho, params=None):
        return apply_plan_density_planar(rho, plan, params)
    return run


def planar_density_probs(rho: jnp.ndarray, targets=None,
                         n: Optional[int] = None):
    """Computation-basis outcome probabilities: the diagonal of ρ."""
    if n is None:
        n = int(np.log2(rho.shape[-1]))
    diag = jnp.diagonal(rho[0], axis1=-2, axis2=-1).reshape((2,) * n)
    if targets is None:
        return diag.reshape(-1)
    targets = sorted(targets)
    other = tuple(q for q in range(n) if q not in targets)
    marg = jnp.sum(diag, axis=other) if other else diag
    return marg.reshape(-1)


# ---------------------------------------------------------------------------
# runners and readout
# ---------------------------------------------------------------------------

def make_planar_runner(plan: Plan):
    @jax.jit
    def run(psi, params=None):
        return apply_plan_planar(psi, plan, params)
    return run


def _make_scanned_reflect_runner(step: ReflectStep, repeats: int,
                                 init_plan: Optional[Plan]):
    """Scan a pure-reflection body at ONE fused pass per iteration.

    * Restacking the two planar components into one (2, ·) carry would
      cost a full extra state copy per iteration — so the carry keeps
      (re, im) as SEPARATE arrays and only restacks on exit.
    * XLA fuses reductions into the elementwise pass that produces their
      operand — so ⟨v|ψ_{k+1}⟩ is computed as four partial sums inside the
      update passes and carried as two scalars; the separate read pass
      runs only once, as the prologue.
    Fused oracle flips are exact: a sign pattern from broadcast iota
    comparisons (in-register) plus O(1) scalar corrections to the carry.
    """
    factors = [np.asarray(f, np.complex128) for f in step.factors]
    head = np.ones(1, np.complex128)
    for f in factors[:-1]:
        head = np.kron(head, f)
    tail = factors[-1]
    H, T = head.shape[0], tail.shape[0]
    if H < 2 or T < 2:
        return None
    Ar = jnp.asarray(head.real.astype(np.float32).reshape(H, 1))
    Ai = jnp.asarray(head.imag.astype(np.float32).reshape(H, 1))
    Br = jnp.asarray(tail.real.astype(np.float32).reshape(1, T))
    Bi = jnp.asarray(tail.imag.astype(np.float32).reshape(1, T))
    flip_info = [(m, m // T, m % T, reflect_component(step.factors, m))
                 for m in step.pre_flips]

    def sign_pattern(dtype):
        """(H,1)·(1,T) mask products — fused, never materialised.

        The barrier keeps XLA from constant-folding the iota comparisons
        into an (H, T) literal (state-sized; dominates compile time)."""
        row = jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0)
        col = jax.lax.broadcasted_iota(jnp.int32, (1, T), 1)
        row, col = jax.lax.optimization_barrier((row, col))
        sign = jnp.asarray(1.0, dtype)
        for _, r0, t0, _ in flip_info:
            hit = ((row == r0).astype(dtype) * (col == t0).astype(dtype))
            sign = sign * (1.0 - 2.0 * hit)
        return sign

    def correct_c(cr, ci, pr, pi):
        """c ← c − 2·conj(v_m)·ψ_m for each fused flip (O(1) gathers)."""
        for _, r0, t0, vm in flip_info:
            pmr, pmi = pr[r0, t0], pi[r0, t0]
            cr = cr - 2.0 * (vm.real * pmr + vm.imag * pmi)
            ci = ci - 2.0 * (vm.real * pmi - vm.imag * pmr)
        return cr, ci

    @jax.jit
    def run(psi, params=None):
        if init_plan is not None:
            psi = apply_plan_planar(psi, init_plan, params)
        shape = psi.shape
        pr = psi[0].reshape(H, T)
        pi = psi[1].reshape(H, T)
        # The factor tables are trace constants; without a barrier XLA
        # constant-folds every (H, T)-shaped product below into full
        # state-sized literals at COMPILE time.  Barriered, the broadcasts
        # fuse into the elementwise passes in-register instead.
        ar, ai, br, bi = jax.lax.optimization_barrier((Ar, Ai, Br, Bi))
        # prologue: c₀ = ⟨v|Fψ₀⟩ (the only standalone read pass)
        vr = ar * br - ai * bi
        vi = ar * bi + ai * br
        cr = jnp.sum(vr * pr + vi * pi)
        ci = jnp.sum(vr * pi - vi * pr)
        cr, ci = correct_c(cr, ci, pr, pi)
        sign = sign_pattern(psi.dtype)

        def body(carry, _):
            pr, pi, cr, ci = carry
            qr = cr * br - ci * bi
            qi = cr * bi + ci * br
            # out = Fψ − 2c·(A⊗B): one fused pass per planar component,
            # each also emitting its two partial sums for the next c
            outr = sign * pr - 2.0 * (ar * qr - ai * qi)
            outi = sign * pi - 2.0 * (ar * qi + ai * qr)
            s_rr = jnp.sum((ar * br - ai * bi) * outr)
            s_ir = jnp.sum((ar * bi + ai * br) * outr)
            s_ri = jnp.sum((ar * br - ai * bi) * outi)
            s_ii = jnp.sum((ar * bi + ai * br) * outi)
            ncr, nci = correct_c(s_rr + s_ii, s_ri - s_ir, outr, outi)
            return (outr, outi, ncr, nci), None

        (pr, pi, _, _), _ = jax.lax.scan(body, (pr, pi, cr, ci), None,
                                         length=repeats)
        return jnp.stack([pr.reshape(-1), pi.reshape(-1)]).reshape(shape)
    return run


def make_scanned_planar_runner(body_plan: Plan, repeats: int,
                               init_plan: Optional[Plan] = None,
                               renorm_every: int = 0):
    if (len(body_plan.steps) == 1
            and isinstance(body_plan.steps[0], ReflectStep)
            and not renorm_every):
        fast = _make_scanned_reflect_runner(body_plan.steps[0], repeats,
                                            init_plan)
        if fast is not None:
            return fast

    if body_plan.engine == "dot":
        from qbot_tpu.tpu.dotplan import make_scanned_dot_runner

        dot = make_scanned_dot_runner(body_plan, repeats, init_plan,
                                      renorm_every=renorm_every)
        if dot is not None:
            return dot

    @jax.jit
    def run(psi, params=None):
        if init_plan is not None:
            psi = apply_plan_planar(psi, init_plan, params)

        def step(carry, i):
            psi = apply_plan_planar(carry, body_plan, params)
            if renorm_every:
                tick = (i + 1) % renorm_every == 0
                scale = jnp.where(tick,
                                  jax.lax.rsqrt(jnp.sum(psi * psi)),
                                  jnp.ones((), psi.dtype))
                psi = psi * scale
            return psi, None

        psi, _ = jax.lax.scan(step, psi, jnp.arange(repeats))
        return psi
    return run


def planar_probs(psi: jnp.ndarray, targets=None, n: Optional[int] = None):
    if n is None:
        n = int(np.log2(psi.shape[-1]))
    p = (psi[0] ** 2 + psi[1] ** 2).reshape((2,) * n)
    if targets is None:
        return p.reshape(-1)
    targets = sorted(targets)
    other = tuple(q for q in range(n) if q not in targets)
    marg = jnp.sum(p, axis=other) if other else p
    return marg.reshape(-1)


def planar_norm(psi: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(psi[0] ** 2 + psi[1] ** 2)
