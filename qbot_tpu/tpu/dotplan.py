"""In-place XLA dot executor for planar statevectors.

* A window contraction whose output stays IN PLACE — the contracted
  axis's position is reused for the output axis, every other axis
  untouched — needs no axis permutation: flips, phases, diagonals,
  reflections and the scan carry all see the canonical layout, and
  lowering never fails on a torn window or un-restorable permutation.
* Every intermediate VIEW keeps the same trailing (2^sub, 2^lane)
  dims (the "pinned tail"; lane = 7 qubits), with sub >= 3 qubits.  In-place
  windows satisfy this whenever the trailing gap between the window
  end b and the lane block is 0 or >= 3 qubits: b <= n-10, b == n-7, or
  b == n.  ``compile_circuit(partition="dot")`` emits aligned windows;
  the step partition (…, n-7, n) is also legal, so the engine runs
  either.
* Cross-window controlled phases cost a masked elementwise pass built
  from host-precomputed per-axis 0/1 vectors.  A real phase (CZ: −1) is
  a single fused multiply; complex phases pay the full complex rotation.

Reference analogue: none (the reference pays O(8^n) per gate,
qgates.py:278-279); this is the general-circuit engine of SURVEY.md §7
decision 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from qbot_tpu.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PhaseStep,
    Plan,
    ReflectStep,
    WindowStep,
    phase_as_diag,
)

__all__ = ["lower_dot_plan", "apply_plan_dot", "DotPlan", "dot_precision",
           "set_dot_mode", "dot_mode", "make_scanned_dot_runner"]

_LANE_LOG2 = 7                # phase/flip carrier minor axis (lanes)
_SUB_LOG2 = 3                 # phase/flip carrier second-minor axis


# Window matmul precision mode: "f32" | "f32_mix" | "bf16_3x" | "bf16".
# "f32_mix" is a dot-engine policy: reduced precision ONLY on windows of
# width >= _MIX_WIDTH_MIN, full f32 everywhere else.
_DOT_MODE = "f32"


def set_dot_mode(mode: str) -> None:
    global _DOT_MODE
    if mode not in ("f32", "f32_mix", "bf16_3x", "bf16"):
        raise ValueError(f"unknown dot mode {mode!r}")
    _DOT_MODE = mode


def dot_mode() -> str:
    return _DOT_MODE


def dot_precision():
    """Map the dot mode to an XLA dot precision.

    f32 -> HIGHEST, bf16_3x -> HIGH, bf16 -> DEFAULT.  For float32
    operands on a GPU, XLA runs HIGH and DEFAULT through reduced-
    precision (TF32-class) tensor-core algorithms; the mode names are
    kept for the CLI, not as a statement of the algorithm.  f32_mix
    resolves per window at lower time (:func:`lower_dot_plan`); the
    global fallback used by non-window paths is full f32.
    """
    return {"f32": jax.lax.Precision.HIGHEST,
            "f32_mix": jax.lax.Precision.HIGHEST,
            "bf16_3x": jax.lax.Precision.HIGH,
            "bf16": jax.lax.Precision.DEFAULT}[_DOT_MODE]


# f32_mix window-width threshold: the narrowest width at which a HIGHEST
# window pass took over 1.1x the HIGH pass (benchmarks/calibrate_cost.py
# on an NVIDIA H100 80GB HBM3 at 400 W: width 5, 0.988 ms vs 0.774 ms;
# width 4 is bandwidth-bound at either precision).
_MIX_WIDTH_MIN = 5


def _tail_split(n: int) -> tuple[int, int, int]:
    """(front, sub, lane) qubit counts of the fixed phase-mask carrier."""
    lane = min(n, _LANE_LOG2)
    sub = min(_SUB_LOG2, n - lane)
    return n - sub - lane, sub, lane


@dataclass(frozen=True)
class _Win:
    """One in-place window contraction pass."""
    step: WindowStep                  # terms to fold (matrices/params)
    view: tuple[int, ...]             # rhs reshape dims
    spec: str                         # einsum spec (in-place output)
    flips: tuple[int, ...]            # flat indices, applied pre
    phases: tuple                     # mask-vector phases, applied pre
    prec: Optional[object] = None     # per-window precision override


@dataclass(frozen=True)
class _Diag:
    view: tuple[int, ...]
    dr: np.ndarray
    di: np.ndarray


@dataclass(frozen=True)
class _DiagCarrier:
    """Diagonal step in the pinned-carrier broadcast formulation: the
    per-target small diag broadcasts over the (2,)*n axes and reshapes
    to the (F, S, L) carrier at the materialisation point — it keeps the
    pinned tail for ANY target set (the grouped view of, e.g., a CZ diag
    on qubits (5, 6) at n=26 has a width-4 second-minor dim).  Same
    formulation as sharded_ensemble._batched_sharded_diag's large-n
    path."""
    targets: tuple[int, ...]
    dr: np.ndarray                    # (2,)*t real part
    di: np.ndarray


@dataclass(frozen=True)
class _Flip:
    index: int


@dataclass(frozen=True)
class _Contract:
    step: ContractStep


@dataclass(frozen=True)
class _Reflect:
    step: ReflectStep


@dataclass
class DotPlan:
    n: int
    num_params: int
    steps: list
    tail: tuple = ()                  # pinned (front, sub, lane) split
    # the in-place engine never permutes the layout; both fields stay
    # identity (kept for executor/runner API compatibility)
    entry_perm: tuple[int, ...] = ()
    final_perm: tuple[int, ...] = ()


def plan_tail_split(plan: Plan):
    """(front, sub, lane) qubit counts for the plan's pinned tail.

    Every view in a lowered plan keeps the SAME literal trailing
    (2^sub, 2^lane) dims, so reshapes between passes are bitcasts, not
    relayouts.  The sub width is read off the window that ends at
    ``n - lane`` (the partition's sub window); a plan with no tail
    windows uses sub = 3.  Returns None when the plan's windows cannot
    share one tail split.
    """
    n = plan.n
    if n <= 13:                       # small states use flat views; the
        return _tail_split(n)         # split only carries the phase masks
    lane = _LANE_LOG2
    subs = set()
    for s in plan.steps:
        if isinstance(s, WindowStep):
            b = s.start + s.width
            if b == n - lane:
                subs.add(s.width)
            elif b == n and s.width != lane:
                return None           # lane window must be exactly 7q
    if len(subs) > 1:
        return None
    sub = subs.pop() if subs else min(_SUB_LOG2, n - lane)
    return n - sub - lane, sub, lane


def window_spec(n: int, p: int, w: int, tail):
    """(view, spec) for an in-place contraction of window [p, p+w) under
    the plan's pinned (front, sub, lane) tail split.

    Front windows carry the (2^sub, 2^lane) tail as passthrough axes;
    the sub window contracts the sub axis in place; the lane window the
    lane axis.  Size-1 leading axes are dropped from the spec (no
    degenerate batch dims reach the dot).  Returns
    None when the window straddles a tail boundary.
    """
    b = p + w
    A, D = 2 ** p, 2 ** w
    if n <= 13:                       # small states: plain flat views
        return ((2, A, D, 2 ** (n - b)), "xicj,cajb->xaib")
    front, sub, lane = tail
    S, L = 2 ** sub, 2 ** lane
    if b <= front:                    # front window
        B1 = 2 ** (front - b)
        rhs, out, view = "c", "x", [2]
        if A > 1:
            rhs += "a"
            out += "a"
            view.append(A)
        rhs += "j"
        out += "i"
        view.append(D)
        if B1 > 1:
            rhs += "b"
            out += "b"
            view.append(B1)
        rhs += "sl"
        out += "sl"
        view += [S, L]
        return (tuple(view), f"xicj,{rhs}->{out}")
    if p == front and w == sub:       # sub window
        return ((2, 2 ** front, S, L), "xicj,cfjl->xfil")
    if p == front + sub and w == lane:  # lane window
        return ((2, 2 ** front, S, L), "xicj,cfsj->xfsi")
    return None                       # straddles a tail boundary


def _phase_vectors(phase, n: int, tail):
    """Phase factor as host-precomputed per-axis 0/1 mask vectors over the
    plan's pinned (front, sub, lane) carrier.

    The mask (1 where every listed bit matches its wanted value)
    factorises per qubit, so it splits across the three carrier axes as
    an outer product of CONSTANT vectors — tiny HLO constants (the
    largest is 2^(n-10) floats), assembled by broadcast in-trace.
    """
    qubits, z = phase[0], complex(phase[1])
    if abs(z.imag) < 1e-9:
        # numerically-real phases (CZ via the controlled-eigendecomposition
        # rewrite carries ~1e-16 of imaginary residue) must take the
        # single-multiply fast path, not the full complex rotation
        z = complex(z.real, 0.0)
    pattern = phase[2] if len(phase) > 2 else -1
    k = len(qubits)
    front, sub, lane = tail
    sizes = (2 ** front, 2 ** sub, 2 ** lane)
    vecs = [np.ones(sz, dtype=np.float32) for sz in sizes]
    spans = ((0, front), (front, front + sub), (front + sub, n))
    for idx, q in enumerate(qubits):
        want = 1 if pattern < 0 else (pattern >> (k - 1 - idx)) & 1
        for ax, (lo, hi) in enumerate(spans):
            if lo <= q < hi:
                ar = np.arange(sizes[ax])
                bit = (ar >> (hi - 1 - q)) & 1
                vecs[ax] *= (bit == want).astype(np.float32)
                break
    return (vecs[0], vecs[1], vecs[2], complex(z))


def _grouped_view_ok(view, n: int) -> bool:
    """Accept only views that keep the pinned (>= 8, >= 128) minor dims."""
    if n <= 13:
        return True
    return view[-1] >= 128 and (len(view) < 3 or view[-2] >= 8)


def lower_dot_plan(plan: Plan, cycle: bool = True) -> Optional[DotPlan]:
    """Lower a window plan to in-place dot-engine steps, or None when a
    step cannot keep a pinned-tail view (caller falls back to the planar
    executor).  Every pass preserves the canonical axis layout, so the
    lowered body composes under ``lax.scan`` with no restore step
    (``cycle`` is accepted for API compatibility; the property now holds
    unconditionally).
    """
    n = plan.n
    if n < 1:
        return None
    tail = plan_tail_split(plan)
    if tail is None:
        return None
    mix = _DOT_MODE == "f32_mix"
    lowered: list = []
    saw_window = False
    for s in plan.steps:
        if isinstance(s, WindowStep):
            sv = window_spec(n, s.start, s.width, tail)
            if sv is None:
                return None
            view, spec = sv
            flips = tuple(int(m) for m in s.pre_flips)
            phases = tuple(_phase_vectors(ph, n, tail)
                           for ph in s.pre_phases)
            prec = (jax.lax.Precision.HIGH
                    if mix and s.width >= _MIX_WIDTH_MIN else None)
            lowered.append(_Win(s, view, spec, flips, phases, prec))
            saw_window = True
        elif isinstance(s, FlipStep):
            lowered.append(_Flip(s.index))
        elif isinstance(s, (PhaseStep, DiagStep)):
            d = phase_as_diag(s) if isinstance(s, PhaseStep) else s
            from qbot_tpu.tpu.planar import _diag_grouped_views
            view, dr, di = _diag_grouped_views(n, tuple(d.targets), d.diag)
            if _grouped_view_ok(view, n):
                lowered.append(_Diag(view, dr, di))
            else:
                t = len(d.targets)
                dd = np.asarray(d.diag)
                lowered.append(_DiagCarrier(
                    tuple(d.targets),
                    dd.real.astype(np.float32).reshape((2,) * t),
                    dd.imag.astype(np.float32).reshape((2,) * t)))
        elif isinstance(s, ReflectStep):
            lowered.append(_Reflect(s))
        elif isinstance(s, ContractStep):
            if n > 13:
                # _apply_contract_planar views the state as (2,)*n,
                # which breaks the pinned tail.  A qubit-contiguous contraction lowers as an in-place
                # window instead; truly scattered targets bail to the
                # planar executor.
                t = sorted(s.targets)
                if (list(s.targets) == t
                        and t == list(range(t[0], t[0] + len(t)))):
                    sv = window_spec(n, t[0], len(t), tail)
                    if sv is None:
                        return None
                    view, spec = sv
                    from qbot_tpu.tpu.compiler import Term
                    wstep = WindowStep(
                        t[0], len(t),
                        (Term(tuple(range(len(t))), s.matrix, s.param_idx,
                              s.maker, s.num_controls),))
                    lowered.append(_Win(wstep, view, spec, (), ()))
                    saw_window = True
                    continue
                return None
            lowered.append(_Contract(s))
        else:
            return None
    if not saw_window and not lowered:
        return None
    return DotPlan(n=n, num_params=plan.num_params, steps=lowered,
                   tail=tail, entry_perm=tuple(range(n)),
                   final_perm=tuple(range(n)))


def _realify(Wr, Wi):
    """(2, D, 2, D) realified matrix M[x,i,c,j] from planar (Wr, Wi)."""
    return jnp.stack([jnp.stack([Wr, -Wi], axis=1),
                      jnp.stack([Wi, Wr], axis=1)], axis=0)


def _apply_phases_masked(psi, n, phases, tail):
    """Controlled-phase factors as broadcast constant mask vectors.

    The state views as the plan's pinned (2, F, S, L) carrier — the
    same literal trailing dims as every window pass, so no relayout —
    and each factor's mask is an outer product of three host-precomputed
    0/1 vectors.  A REAL phase (CZ and friends) reduces to one fused
    multiply of the whole state; complex phases pay the full planar
    rotation.
    """
    front, sub, lane = tail
    F, S, L = 2 ** front, 2 ** sub, 2 ** lane
    t = psi.reshape(2, F, S, L)
    for mf, ms, ml, z in phases:
        maskf = (jnp.asarray(mf).reshape(F, 1, 1)
                 * jnp.asarray(ms).reshape(1, S, 1)
                 * jnp.asarray(ml).reshape(1, 1, L)).astype(t.dtype)
        if z.imag == 0.0:
            t = t * (1.0 + (np.float32(z.real) - 1.0) * maskf)
        else:
            pr, pi = t[0], t[1]
            fr = 1.0 + (np.float32(z.real) - 1.0) * maskf
            fim = np.float32(z.imag) * maskf
            t = jnp.stack([pr * fr - pi * fim, pr * fim + pi * fr])
    return t.reshape(2, -1)


def carrier_shape(lowered: DotPlan) -> tuple[int, ...]:
    """The pinned (2, F, S, L) shape a lowered plan computes in.

    Carrying the pinned 4-D shape through ``lax.scan`` keeps every
    window view a bitcast of the carry.
    """
    n = lowered.n
    if n <= 13:
        return (2, 2 ** n)
    front, sub, lane = lowered.tail
    return (2, 2 ** front, 2 ** sub, 2 ** lane)


def _flip_coords(index: int, tail):
    front, sub, lane = tail
    return (index >> (sub + lane), (index >> lane) & (2 ** sub - 1),
            index & (2 ** lane - 1))


def apply_plan_dot(psi: jnp.ndarray, lowered: DotPlan, params=None,
                   carrier: bool = False,
                   prescale=None) -> jnp.ndarray:
    """Run a lowered dot plan over a planar (2, 2^n) state (traceable).

    ``carrier=True``: ``psi`` is (and stays) in :func:`carrier_shape`
    form — used by the scanned runner so the loop carry keeps the
    pinned carrier layout.

    ``prescale``: optional traced scalar folded into the FIRST window's
    matrix (or multiplied into the state when no window leads) — the
    free half of the scanned runner's drift renormalisation: scaling a
    2^w matrix costs nothing against a full-state pass.
    """
    from qbot_tpu.tpu.planar import (
        _apply_contract_planar,
        _apply_reflect_planar,
        _fold_planar_pair,
    )

    n = lowered.n
    prec = dot_precision()
    shape = psi.shape
    cshape = carrier_shape(lowered)
    small = n <= 13

    def flip(psi, m):
        if small:
            return psi.at[:, m].multiply(-1)
        f, sb, ln = _flip_coords(m, lowered.tail)
        return psi.reshape(cshape).at[:, f, sb, ln].multiply(-1)

    psi = psi.reshape(cshape)
    for s in lowered.steps:
        if isinstance(s, _Win):
            for m in s.flips:
                psi = flip(psi, m)
            if s.phases:
                psi = _apply_phases_masked(psi, n, s.phases, lowered.tail)
            Wr, Wi = _fold_planar_pair(s.step, params, psi.dtype)
            M = _realify(Wr, Wi)
            if prescale is not None:
                M = M * prescale
                prescale = None
            out = jnp.einsum(s.spec, M, psi.reshape(s.view),
                             precision=s.prec or prec)
            psi = out.reshape(cshape)
        elif isinstance(s, _Diag):
            t = psi.reshape(s.view)
            pr, pi = t[0], t[1]
            out_r = s.dr * pr - s.di * pi
            out_i = s.dr * pi + s.di * pr
            psi = jnp.stack([out_r, out_i]).reshape(cshape)
        elif isinstance(s, _DiagCarrier):
            bshape = [1] * n
            for q in s.targets:
                bshape[q] = 2
            F, S, L = cshape[1:] if len(cshape) == 4 else (1, 1, cshape[1])
            drb = jnp.broadcast_to(
                jnp.asarray(s.dr).reshape(bshape), (2,) * n
            ).reshape(F, S, L)
            dib = jnp.broadcast_to(
                jnp.asarray(s.di).reshape(bshape), (2,) * n
            ).reshape(F, S, L)
            t = psi.reshape((2,) + tuple((F, S, L)))
            pr, pi = t[0], t[1]
            out_r = drb * pr - dib * pi
            out_i = drb * pi + dib * pr
            psi = jnp.stack([out_r, out_i]).reshape(cshape)
        elif isinstance(s, _Flip):
            psi = flip(psi, s.index)
        elif isinstance(s, _Reflect):
            psi = _apply_reflect_planar(psi.reshape(2, -1), n,
                                        s.step).reshape(cshape)
        else:                          # _Contract
            psi = _apply_contract_planar(psi.reshape(2, -1), n, s.step,
                                         params).reshape(cshape)
    if prescale is not None:           # no window consumed it
        psi = psi * prescale
    return psi if carrier else psi.reshape(shape)


def density_plan_2n(plan: Plan) -> Plan:
    """The 2n-qubit statevector plan computing ``G ρ G†``.

    Viewing planar ρ flat as a 2n-qubit planar "state" (the density
    executor's convention), each step applies to the ROW axes [0, n)
    as-is and to the COLUMN axes [n, 2n) conjugated.  Basis-state sign
    flips become row/column PhaseSteps (pattern-matched −1 factors),
    which fuse into the following window as mask multiplies.  The
    resulting plan lowers through the ordinary in-place dot engine, so
    mixed states run on the statevector engine.
    """
    from qbot_tpu.tpu.compiler import (
        Plan as CPlan,
        Term,
        _fuse_phases,
        expand_phases,
        expand_reflections,
    )
    from qbot_tpu.tpu.planar import _conj_maker

    n = plan.n
    big = CPlan(n=2 * n, window=plan.window, num_params=plan.num_params,
                gate_count=plan.gate_count, engine="dot")
    rows = tuple(range(n))
    cols = tuple(range(n, 2 * n))

    def flip_phases(index: int):
        return [PhaseStep(rows, -1.0 + 0.0j, index),
                PhaseStep(cols, -1.0 + 0.0j, index)]

    def conj_term(t: Term) -> Term:
        return Term(t.positions,
                    None if t.matrix is None else np.conj(
                        np.asarray(t.matrix)),
                    t.param_idx,
                    None if t.maker is None else _conj_maker(t.maker),
                    t.num_controls)

    for step in expand_phases(expand_reflections(plan.steps)):
        if isinstance(step, WindowStep):
            for m in step.pre_flips:
                big.steps.extend(flip_phases(m))
            big.steps.append(WindowStep(step.start, step.width, step.terms))
            big.steps.append(WindowStep(n + step.start, step.width,
                                        tuple(conj_term(t)
                                              for t in step.terms)))
        elif isinstance(step, DiagStep):
            big.steps.append(step)
            big.steps.append(DiagStep(tuple(n + q for q in step.targets),
                                      np.conj(np.asarray(step.diag))))
        elif isinstance(step, FlipStep):
            big.steps.extend(flip_phases(step.index))
        elif isinstance(step, ContractStep):
            big.steps.append(step)
            big.steps.append(ContractStep(
                tuple(n + q for q in step.targets),
                None if step.matrix is None else np.conj(
                    np.asarray(step.matrix)),
                step.param_idx,
                None if step.maker is None else _conj_maker(step.maker),
                step.num_controls))
        else:
            return None
    big.steps = _fuse_phases(big.steps)
    return big


def make_scanned_dot_runner(plan: Plan, repeats: int, init_plan=None,
                            renorm_every: int = 0):
    """jit(psi, params?) -> state after ``repeats`` plan bodies, dot engine.

    Returns None when the plan does not lower (caller uses the planar
    runner).  Every pass is in place, so the scan carry keeps the
    canonical layout with no restore step.

    ``renorm_every=k`` re-normalises the state every k bodies — the
    error-contract mitigation for the reduced-precision dot modes: the
    norm reduction fuses into the body's last pass
    as an epilogue and the 1/√norm correction folds into the NEXT body's
    first window matrix (:func:`apply_plan_dot` ``prescale``), so the
    cadence costs no extra full-state pass.  The correction is applied
    lazily, so the returned state carries at most one pending body's
    drift (fully corrected on exit).
    """
    lowered = lower_dot_plan(plan)
    if lowered is None:
        return None
    init_lowered = None
    if init_plan is not None:
        init_lowered = lower_dot_plan(init_plan)

    @jax.jit
    def run(psi, params=None):
        shape = psi.shape
        if init_plan is not None:
            if init_lowered is not None:
                psi = apply_plan_dot(psi, init_lowered, params)
            else:
                from qbot_tpu.tpu.planar import apply_plan_planar
                psi = apply_plan_planar(psi, init_plan, params)

        # carry the pinned 4-D carrier shape
        psi = psi.reshape(carrier_shape(lowered))

        if renorm_every:
            def step(carry, i):
                psi, c = carry
                psi = apply_plan_dot(psi, lowered, params, carrier=True,
                                     prescale=c)
                tick = (i + 1) % renorm_every == 0
                nrm2 = jnp.sum(psi * psi)
                c = jnp.where(tick, jax.lax.rsqrt(nrm2),
                              jnp.ones((), psi.dtype))
                return (psi, c), None

            (psi, c), _ = jax.lax.scan(
                step, (psi, jnp.ones((), psi.dtype)),
                jnp.arange(repeats))
            psi = psi * c              # land the last pending correction
        else:
            def step(carry, _):
                return apply_plan_dot(carry, lowered, params,
                                      carrier=True), None

            psi, _ = jax.lax.scan(step, psi, None, length=repeats)
        return psi.reshape(shape)
    return run
