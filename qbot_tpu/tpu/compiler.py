"""Window-fusion circuit compiler.

Turns a :class:`~qbot_tpu.tpu.circuit.Circuit` into a static execution plan
whose hot steps are (2^a × 2^w × 2^b) · (2^w × 2^w) batched matmuls
instead of one full-state pass per gate.

Design (no analogue exists in the reference, which pays an O(8^n)
full-space construction per gate, qgates.py:161-182 + 278-279):

* The n qubit axes are partitioned into contiguous *windows* of up to
  ``window`` qubits (default 7 → 128×128 fused unitaries).
* Consecutive gates whose qubits fall inside one window are folded into
  that window's pending unitary on the fly; the state is only touched when
  a window must *flush* — so a layer of n single-qubit gates costs
  ⌈n/w⌉ HBM passes instead of n.
* Ops on disjoint qubit sets commute, so per-window pending fusion across
  program order is exact, not an approximation.
* Diagonal ops (oracles, multi-controlled-Z) on arbitrary subsets become a
  single elementwise pass (``DiagStep``); diagonals inside one window fold
  into the window unitary like any gate.
* Rare cross-window entangling gates fall back to a direct tensordot
  contraction step (``ContractStep``).

The plan is pure static metadata: executors trace it under ``jit`` /
``shard_map`` with no data-dependent control flow.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np

from qbot_tpu.ops.gates import controlled
from qbot_tpu.tpu.circuit import Circuit, CircuitOp

__all__ = ["Term", "WindowStep", "DiagStep", "FlipStep", "PhaseStep",
           "ContractStep", "ReflectStep", "Plan",
           "compile_circuit", "expand_reflections",
           "expand_phases", "phase_as_diag", "gate_as_diag",
           "eigen_decompose_controlled", "decompose_spanning_swap"]


@dataclass(frozen=True)
class Term:
    """One gate folded into a window: positions are window-relative axes."""
    positions: tuple[int, ...]
    matrix: Optional[np.ndarray]      # static (controls already folded in)
    param_idx: Optional[int] = None
    maker: Optional[Callable] = None
    num_controls: int = 0             # for param gates: wrap maker output


@dataclass(frozen=True)
class WindowStep:
    start: int                        # first qubit axis of the window
    width: int                        # window qubit count (dim = 2**width)
    terms: tuple[Term, ...]
    # basis-state sign flips applied BEFORE this window's unitary
    pre_flips: tuple[int, ...] = ()
    # controlled-phase factors applied BEFORE this window's unitary:
    # each (qubits, z, pattern) multiplies an amplitude by z when the
    # qubits' bits match the pattern — the dot engine applies them as one
    # masked elementwise multiply ahead of the window's dot
    pre_phases: tuple[tuple[tuple[int, ...], complex], ...] = ()


@dataclass(frozen=True)
class DiagStep:
    targets: tuple[int, ...]
    diag: np.ndarray                  # (2**len(targets),) phase vector


@dataclass(frozen=True)
class FlipStep:
    """Sign-flip of a single basis state (multi-controlled-Z): one scatter."""
    index: int


@dataclass(frozen=True)
class PhaseStep:
    """Multiply by ``phase`` every amplitude whose ``qubits`` bits equal
    the bits of ``pattern`` (bit k−1−j of ``pattern`` ↔ ``qubits[j]``,
    matching the diag-vector index convention).

    The normal form of any (multi-)controlled phase gate — in particular
    every cross-window CZ/CPhase left by the CX → H·CZ·H and controlled-U
    eigendecomposition rewrites (whose eigenvalue ordering may place the
    phase at any diag index, hence the pattern).  ``_fuse_phases``
    attaches it to the next window as a pre-phase.
    """
    qubits: tuple[int, ...]
    phase: complex
    pattern: int = -1                     # -1 = all qubits 1


@dataclass(frozen=True)
class ReflectStep:
    """Householder reflection ``ψ → ψ − 2⟨v|ψ⟩v`` about a product state.

    Detected from the algebraic pattern ``A-layer · flip(idx) · A†-layer``
    (windows with inverse unitaries sandwiching a basis-state sign flip),
    which equals ``I − 2|v⟩⟨v|`` with ``v = A†|idx⟩`` — a PRODUCT of
    per-block vectors, so the whole two-layer sandwich collapses to one
    read pass (the ⟨v|ψ⟩ contraction) plus one read+write pass (the rank-1
    update), instead of 2× full window layers.  This is exactly Grover's
    diffusion operator, recognised structurally rather than special-cased.

    ``factors[i]`` is the complex vector for the i-th contiguous qubit
    block; blocks tile [0, n) in order.  ``original`` keeps the replaced
    steps for executors that cannot run reflections directly (density).

    ``pre_flips`` are basis-state sign flips applied BEFORE the reflection
    (a preceding oracle).  Because the reflection is a rank-1 update, a
    flipped basis state only shifts ⟨v|ψ⟩ by a scalar and the output at one
    index — so fused flips cost O(1) gather/scatter work instead of an HBM
    pass of their own.
    """
    factors: tuple[np.ndarray, ...]
    original: tuple = ()
    pre_flips: tuple[int, ...] = ()


@dataclass(frozen=True)
class ContractStep:
    targets: tuple[int, ...]          # includes controls (leading)
    matrix: Optional[np.ndarray]
    param_idx: Optional[int] = None
    maker: Optional[Callable] = None
    num_controls: int = 0


Step = Union[WindowStep, DiagStep, FlipStep, PhaseStep, ContractStep,
             ReflectStep]


@dataclass
class Plan:
    n: int
    window: int
    steps: list[Step] = field(default_factory=list)
    num_params: int = 0
    gate_count: int = 0               # logical gates represented
    # executor the auto-compiler ranked fastest for this plan:
    # "step" = one XLA pass per plan step (tpu/planar.py), "dot" = the
    # in-place dot engine (tpu/dotplan.py).  Runners honour it.
    engine: str = "step"

    @property
    def num_passes(self) -> int:
        """Full-state passes this plan costs (the perf figure of merit).

        ReflectStep costs 2 (⟨v|ψ⟩ read pass + rank-1 update pass);
        FlipStep costs 0 (an in-place single-element scatter); every other
        step reads and writes the state once.
        """
        total = 0
        for s in self.steps:
            if isinstance(s, ReflectStep):
                total += 2
            elif not isinstance(s, FlipStep):
                total += 1
        return total

    def hbm_bytes(self, dtype_bytes: int = 4, planar: bool = True) -> int:
        """Device-memory traffic per execution: read + write of the planar
        state per pass (window matrices are noise by comparison)."""
        components = 2 if planar else 1
        state = components * (2**self.n) * dtype_bytes
        return 2 * state * self.num_passes


def plan_cache_key(plan: Plan):
    """Content digest of a Plan for executor caching, or None when the
    plan is not content-addressable (parameterised gate makers).

    Two structurally-identical plans — e.g. the same program segment
    recompiled on a later run — digest equal, so executors can reuse a
    cached jitted callable instead of re-tracing.  Every behaviourally
    relevant field is hashed: step geometry, static matrices/diagonals
    byte-wise, fused flips/phases, and the plan header (including the
    ranked engine, which selects the executor path at trace time).
    """
    import hashlib

    h = hashlib.sha1()

    def u(*parts):
        for x in parts:
            h.update(repr(x).encode())
            h.update(b";")

    def arr(a):
        a = np.asarray(a)
        u("A", a.dtype.str, a.shape)
        h.update(a.tobytes())

    def term(t) -> bool:
        if t.maker is not None:
            return False
        u("T", t.positions, t.param_idx, t.num_controls)
        if t.matrix is None:
            return False
        arr(t.matrix)
        return True

    def step(st) -> bool:
        if isinstance(st, WindowStep):
            u("W", st.start, st.width, st.pre_flips)
            for ph in st.pre_phases:
                u("ph", ph[0], complex(ph[1]),
                  ph[2] if len(ph) > 2 else -1)
            return all(term(t) for t in st.terms)
        if isinstance(st, DiagStep):
            u("D", st.targets)
            arr(st.diag)
            return True
        if isinstance(st, FlipStep):
            u("F", st.index)
            return True
        if isinstance(st, PhaseStep):
            u("Ph", st.qubits, complex(st.phase), st.pattern)
            return True
        if isinstance(st, ContractStep):
            if st.maker is not None:
                return False
            u("C", st.targets, st.num_controls)
            arr(st.matrix)
            return True
        if isinstance(st, ReflectStep):
            u("R", st.pre_flips)
            for f in st.factors:
                arr(f)
            return True
        return False

    u("hdr", plan.n, plan.window, plan.engine, plan.num_params)
    for st in plan.steps:
        if not step(st):
            return None
    return h.digest()


def _qubit_log2(size: int) -> int:
    return int(size).bit_length() - 1


def gate_as_diag(op: CircuitOp) -> Optional[CircuitOp]:
    """Normalise a diagonal (possibly controlled) gate op to a 'diag' op.

    A controlled diagonal gate is itself diagonal (identity on the
    non-triggered block), so e.g. a multi-controlled-Z over ALL qubits
    becomes one elementwise pass — and, on a sharded register, a purely
    local multiply with zero communication — instead of a full-space
    contraction.  Returns None when the op is not a static diagonal gate.
    """
    if op.kind != "gate" or op.matrix is None:
        return None
    m = np.asarray(op.matrix)
    if m.ndim != 2 or not np.allclose(m, np.diag(np.diag(m)),
                                      rtol=0.0, atol=1e-12):
        return None
    d = np.diag(m).astype(np.complex128)
    if op.controls:
        full = np.ones(2 ** len(op.controls + op.targets), np.complex128)
        full[-d.shape[0]:] = d
        d = full
    return CircuitOp("diag", tuple(op.controls) + tuple(op.targets), (), d)


_SWAP2 = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                   [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)


def _unitary_eig(U: np.ndarray, atol: float = 1e-9):
    """Orthonormal eigendecomposition U = V diag(d) V† of a unitary.

    Every unitary is normal, hence unitarily diagonalizable — but
    ``np.linalg.eig`` does not return orthonormal eigenvectors for repeated
    eigenvalues, so diagonalize a random Hermitian combination of the
    commuting Hermitian/anti-Hermitian parts instead (their joint
    eigenbasis is U's); verify, retry with fresh coefficients on the
    measure-zero failure of a degenerate combination.
    """
    H = (U + U.conj().T) / 2
    S = (U - U.conj().T) / 2j
    rng = np.random.default_rng(0)
    for _ in range(4):
        t = rng.uniform(0.2, 0.8)
        _, V = np.linalg.eigh(t * H + (1 - t) * S)
        D = V.conj().T @ U @ V
        if np.allclose(D, np.diag(np.diag(D)), atol=atol):
            return np.diag(D), V
    return None, None


def eigen_decompose_controlled(op: CircuitOp) -> Optional[list[CircuitOp]]:
    """Rewrite a static controlled-U as  V† · controlled-diag · V.

    U = V diag(d) V† (unitaries are normal) gives
    ``C-U = (I⊗V) · C-diag(d) · (I⊗V†)`` — the V factors touch ONLY the
    target qubits and the controlled part becomes a *diagonal*, which costs
    one fused elementwise pass wherever it lands (and, on a sharded
    register, factors across shards with zero communication).  This removes
    the need to ever contract a controlled gate across windows or shards —
    the replacement for the reference's full-space
    ``genMultiControlledGate`` conjugations (qgates.py:228-275).

    Returns None when the op is not a static controlled gate or the
    decomposition fails numerically (caller keeps the contraction path).
    """
    if op.kind != "gate" or op.matrix is None or not op.controls:
        return None
    U = np.asarray(op.matrix, np.complex128)
    d, V = _unitary_eig(U)
    if d is None:
        return None                      # pragma: no cover - retry exhausted
    full = np.ones(2 ** (len(op.controls) + len(op.targets)), np.complex128)
    full[-d.shape[0]:] = d
    out = []
    if not np.allclose(V, np.eye(V.shape[0]), atol=1e-12):
        out.append(CircuitOp("gate", op.targets, (), V.conj().T))
        out.append(CircuitOp("diag", tuple(op.controls) + tuple(op.targets),
                             (), full))
        out.append(CircuitOp("gate", op.targets, (), V))
    else:                                # U already diagonal
        out.append(CircuitOp("diag", tuple(op.controls) + tuple(op.targets),
                             (), full))
    return out


def decompose_spanning_swap(op: CircuitOp) -> Optional[list[CircuitOp]]:
    """A 2-qubit SWAP as 3 CXs (each then eigen-decomposes to H·CZ·H),
    for swaps spanning windows or shards."""
    if (op.kind != "gate" or op.matrix is None or op.controls
            or len(op.targets) != 2):
        return None
    if not np.allclose(np.asarray(op.matrix, complex), _SWAP2, atol=1e-12):
        return None
    a, b = op.targets
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    return [CircuitOp("gate", (b,), (a,), X),
            CircuitOp("gate", (a,), (b,), X),
            CircuitOp("gate", (b,), (a,), X)]


# Single-card cost-model constants, derived from one run of
# benchmarks/calibrate_cost.py (26 qubits, planar float32, device-trace
# times) on an NVIDIA H100 80GB HBM3 at a 400 W power limit; the raw
# times are in PERF.md.  Effective rates, not data-sheet figures:
# * _DOT_STREAM_BW: state bytes read + written over the time of an
#   in-place dot-engine window pass at width 4 (bandwidth-bound);
# * _DOT_FLOPS: window-matmul FLOPs over pass time at width 8, per dot
#   mode — compute-bound at HIGHEST; HIGH and DEFAULT are still
#   bandwidth-bound there, so their rates are lower bounds;
# * _STEP_BW: the same stream rate for the step executor's window pass;
# * _XLA_BW: an elementwise diagonal pass;
# * _DOT_SLACK: the mean of pass time over max(stream, compute) across
#   widths 4-8 at HIGHEST;
# * _PHASE_REAL/_PHASE_CPLX: the extra time of a fused real/complex
#   pre-phase over a plain width-4 pass, as a fraction of that pass.
_DOT_STREAM_BW = 1.32e12
_DOT_FLOPS = {"f32": 42.6e12, "bf16_3x": 160e12, "bf16": 159e12}
_STEP_BW = 0.542e12
_XLA_BW = 1.43e12
_DOT_SLACK = 1.19
_PHASE_REAL = 0.0006
_PHASE_CPLX = 0.045


def _window_flops(n: int, width: int) -> float:
    """Real FLOPs of one planar window product: a realified (2D × 2D)
    matrix against the (2D × 2^n/D) state columns."""
    return 4.0 * 2.0 * (2**n) * (2**width)


def dot_cost_model(plan: Plan, dot_mode: str = "f32") -> float:
    """Modeled seconds per plan execution on the in-place dot engine.

    Pairs count as two passes (the engine applies windows singly); each
    window costs max(in-place stream read+write, matmul time) plus
    scheduling slack; fused pre-phases cost their mask multiply (cheap
    for real phases); diagonals are one elementwise pass; reflections
    two.
    """
    from qbot_tpu.tpu.dotplan import _MIX_WIDTH_MIN

    state_bytes = 2 * (2**plan.n) * 4
    stream = 2 * state_bytes / _DOT_STREAM_BW
    xla_pass = 2 * state_bytes / _XLA_BW
    rate = _DOT_FLOPS.get(dot_mode, _DOT_FLOPS["f32"])

    def phase_cost(phases) -> float:
        t = 0.0
        for ph in phases:
            z = complex(ph[1])
            t += (_PHASE_REAL if abs(z.imag) < 1e-9 else _PHASE_CPLX) * stream
        return t

    def win_cost(w) -> float:
        rate_w = rate
        if dot_mode == "f32_mix":
            # selective precision: wide windows run at HIGH, the rest f32
            rate_w = (_DOT_FLOPS["bf16_3x"] if w.width >= _MIX_WIDTH_MIN
                      else _DOT_FLOPS["f32"])
        return (max(stream, _window_flops(plan.n, w.width) / rate_w)
                * _DOT_SLACK + phase_cost(w.pre_phases))

    t = 0.0
    for s in plan.steps:
        if isinstance(s, FlipStep):
            continue
        if isinstance(s, ReflectStep):
            t += 2 * xla_pass
        elif isinstance(s, WindowStep):
            t += win_cost(s)
        elif isinstance(s, PhaseStep):
            t += phase_cost([(s.qubits, s.phase)])
        else:
            t += xla_pass
    return t


def plan_cost_model(plan: Plan, dot_mode: str = "f32") -> float:
    """Modeled seconds per plan execution on the step executor.

    Each window costs max(stream read+write,
    matmul time); its fused pre-phases cost one elementwise pass each
    (the step executor applies them as diagonal passes); diagonals cost
    one elementwise pass; reflections two; flips nothing.
    """
    state_bytes = 2 * (2**plan.n) * 4
    stream = 2 * state_bytes / _STEP_BW
    xla_pass = 2 * state_bytes / _XLA_BW
    rate = _DOT_FLOPS.get(dot_mode, _DOT_FLOPS["f32"])

    t = 0.0
    for s in plan.steps:
        if isinstance(s, FlipStep):
            continue
        if isinstance(s, ReflectStep):
            t += 2 * xla_pass
        elif isinstance(s, WindowStep):
            t += (max(stream, _window_flops(plan.n, s.width) / rate)
                  + len(s.pre_phases) * xla_pass)
        else:
            t += xla_pass
    return t


def auto_candidates(circ: Circuit, mode: Optional[str] = None):
    """(cost, plan, engine) for every width the auto search ranks.

    Exposed so tests can mirror the search exactly (the auto branch of
    :func:`compile_circuit` picks the argmin of THIS list): dot-engine
    plans with ``partition="dot"`` over widths 4..8.
    """
    from qbot_tpu.tpu.dotplan import dot_mode

    if mode is None:
        mode = dot_mode()
    out = []
    for w_try in range(4, 9):
        cand = compile_circuit(circ, w_try, partition="dot")
        out.append((dot_cost_model(cand, mode), cand, "dot"))
    return out


def compile_circuit(circ: Circuit, window=7, partition: str = "step"
                    ) -> Plan:
    """Compile to a window-fused plan.

    ``window="auto"`` ranks the candidates of :func:`auto_candidates`
    (measurement-calibrated cost model, current dot mode) and keeps the
    fastest.  ``partition="dot"`` aligns window boundaries to the
    in-place dot engine's legal positions (window ends at <= n-10, n-7,
    or n).
    """
    if window == "auto":
        best = min(auto_candidates(circ), key=lambda t: t[0])
        _, plan, _ = best
        from qbot_tpu.tpu.dotplan import lower_dot_plan

        if lower_dot_plan(plan) is not None:
            plan.engine = "dot"
            return plan
        # the dot ranking won but the plan does not lower: re-rank on the
        # step partition, whose executor runs any plan
        return compile_circuit(circ, "auto_step")
    if window == "auto_step":         # internal: step-executor re-rank
        from qbot_tpu.tpu.dotplan import dot_mode

        mode = dot_mode()
        best = None
        for w_try in range(4, 8):
            cand = compile_circuit(circ, w_try)
            cost = plan_cost_model(cand, mode)
            if best is None or cost < best[0]:
                best = (cost, cand)
        return best[1]
    n = circ.n
    w = min(window, n) if n else 1
    # Step partition: the LAST group always has width min(n, 7) and the
    # remaining front qubits split END-ALIGNED into groups of width ``w``
    # (remainder group first), so every middle group keeps a trailing
    # batch dim B = 2^(sum of later widths) >= 2^7.  ``w`` < 7 trades
    # more passes for fewer matmul FLOPs (fused window matrices are 2^w
    # square), which wins when layers are gate-sparse.
    #
    # ``partition="dot"`` (n >= 14): every window end must be a
    # legal in-place position for the dot engine (<= n-10, n-7,
    # or n; dotplan.window_spec) — a 6-qubit "sub" window at [n-13, n-7)
    # and the 7-qubit lane window at [n-7, n), with the front split into
    # ``w``-chunks remainder-LAST.  At 26 qubits this puts the brickwork
    # boundaries at 7/13/19 — all odd, so alternating-layer entanglers
    # straddle windows in only half the layers and (with support-based
    # lazy flushing below) windows flush every other layer.
    LANE_LOG2 = 7
    if partition == "dot" and n >= 14:
        sub = 6
        front = n - sub - LANE_LOG2
        bounds = []
        q = 0
        while q < front:
            width = min(w, front - q)
            bounds.append((q, width))
            q += width
        bounds += [(front, sub), (front + sub, LANE_LOG2)]
    else:
        last_w = min(n, LANE_LOG2)
        front = n - last_w
        rem = front % w
        bounds = ([(0, rem)] if rem else []) + [
            (rem + i * w, w) for i in range(front // w)]
        if last_w:
            bounds.append((front, last_w))
    group_of = [0] * n
    for gi, (start, width) in enumerate(bounds):
        for q in range(start, start + width):
            group_of[q] = gi
    group_start = lambda gi: bounds[gi][0]
    group_width = lambda gi: bounds[gi][1]

    plan = Plan(n=n, window=w, num_params=circ.num_params,
                gate_count=circ.gate_count)
    pending: dict[int, list[Term]] = {}
    pending_support: dict[int, set[int]] = {}

    def fold(gi: int, qubits, term: Term) -> None:
        pending.setdefault(gi, []).append(term)
        pending_support.setdefault(gi, set()).update(qubits)

    def flush(gi: int) -> None:
        terms = pending.pop(gi, None)
        pending_support.pop(gi, None)
        if terms:
            plan.steps.append(WindowStep(group_start(gi), group_width(gi),
                                         tuple(terms)))

    def flush_overlapping(qubits) -> None:
        # support-based LAZY flushing: a window must flush before a
        # spanning step only if its PENDING terms share support with the
        # step (disjoint supports commute, so untouched pendings slide
        # past and keep accumulating — e.g. alternating-layer brickwork
        # entanglers then flush each window once per two layers, not
        # once per layer).  Later folds into a surviving pending are
        # emitted after the spanning step, which is their program order.
        qs = set(qubits)
        for gi in sorted(g for g, sup in list(pending_support.items())
                         if sup & qs):
            flush(gi)

    from collections import deque

    queue = deque(circ.ops)
    while queue:
        op = queue.popleft()
        dop = gate_as_diag(op)
        if dop is not None:
            op = dop
        if op.kind == "flip":
            flush_overlapping(op.targets)
            plan.steps.append(FlipStep(op.index))
            continue
        if op.kind == "diag":
            targets = op.targets
            gis = {group_of[q] for q in targets}
            if len(gis) == 1:
                gi = next(iter(gis))
                start = group_start(gi)
                fold(gi, targets,
                     Term(tuple(q - start for q in targets),
                          np.diag(op.matrix).astype(np.complex128)))
            else:
                d = np.asarray(op.matrix, np.complex128)
                flush_overlapping(targets)
                # rtol must be 0: the default 1e-5 would snap entries
                # within 1e-5 of 1 to identity, silently dropping small
                # phases even on the exact c128 oracle path
                nontriv = np.flatnonzero(
                    ~np.isclose(d, 1.0, rtol=0.0, atol=1e-12))
                if (nontriv.shape[0] == 1
                        and abs(abs(d[nontriv[0]]) - 1.0) < 1e-12):
                    # controlled-phase normal form (one unimodular entry
                    # off 1): fuses into the next window as a pre-phase
                    idx = int(nontriv[0])
                    plan.steps.append(
                        PhaseStep(targets, complex(d[idx]), idx))
                else:
                    plan.steps.append(DiagStep(targets, op.matrix))
            continue

        # gate op: fold controls into a block-diagonal matrix up front when
        # static, so a controlled gate is just a bigger window term
        qubits = op.controls + op.targets
        gis = {group_of[q] for q in qubits}
        if op.matrix is not None:
            if len(gis) > 1:
                # never contract across windows when a cheap algebraic
                # rewrite exists: spanning swaps → 3 CXs; controlled gates →
                # V† · controlled-diag · V (diagonals are one fused pass)
                dec = (decompose_spanning_swap(op)
                       or eigen_decompose_controlled(op))
                if dec is not None:
                    queue.extendleft(reversed(dec))
                    continue
            mat = controlled(op.matrix, len(op.controls)) if op.controls \
                else op.matrix
            if len(gis) == 1:
                gi = next(iter(gis))
                start = group_start(gi)
                fold(gi, qubits, Term(tuple(q - start for q in qubits), mat))
            else:
                flush_overlapping(qubits)
                plan.steps.append(ContractStep(qubits, mat))
        else:
            if len(gis) == 1:
                gi = next(iter(gis))
                start = group_start(gi)
                fold(gi, qubits,
                     Term(tuple(q - start for q in qubits), None,
                          op.param_idx, op.maker, len(op.controls)))
            else:
                flush_overlapping(qubits)
                plan.steps.append(ContractStep(qubits, None, op.param_idx,
                                               op.maker, len(op.controls)))

    for gi in sorted(pending):
        flush(gi)
    plan.steps = merge_adjacent_diags(plan.steps)
    plan.steps = _detect_reflections(plan.steps, n)
    plan.steps = _fuse_phases(plan.steps)
    plan.steps = _fuse_flips(plan.steps)
    return plan


def combine_diag_vectors(targets_a, diag_a, targets_b, diag_b, union):
    """Phase vector of diag_a·diag_b over the sorted union of their targets.

    Diagonals compose elementwise: each union index selects the bits of the
    two operand target subsets and multiplies the corresponding phases.
    """
    k = len(union)
    pos = {q: i for i, q in enumerate(union)}
    idx = np.arange(2**k)

    def sub_index(targets):
        s = np.zeros(2**k, dtype=np.int64)
        t = len(targets)
        for j, q in enumerate(targets):
            bit = (idx >> (k - 1 - pos[q])) & 1
            s |= bit << (t - 1 - j)
        return s

    va = np.asarray(diag_a, np.complex128)
    vb = np.asarray(diag_b, np.complex128)
    return va[sub_index(targets_a)] * vb[sub_index(targets_b)]


def merge_adjacent_diags(steps: list[Step], cap: int = 12) -> list[Step]:
    """Fuse runs of adjacent DiagSteps into one elementwise pass each.

    All diagonals commute, so adjacent DiagSteps combine exactly; the
    merged phase tensor is capped at 2^cap entries so a long run over many
    distinct qubits (e.g. a QFT's controlled-phase cascade) merges in
    chunks rather than materialising a 2^n constant.
    """
    out: list[Step] = []
    for step in steps:
        if (isinstance(step, DiagStep) and out
                and isinstance(out[-1], DiagStep)):
            prev = out[-1]
            union = tuple(sorted(set(prev.targets) | set(step.targets)))
            if len(union) <= cap:
                out[-1] = DiagStep(union, combine_diag_vectors(
                    prev.targets, prev.diag, step.targets, step.diag,
                    union))
                continue
        out.append(step)
    return out


def _static_window_matrix(step: WindowStep):
    """Folded window unitary when every term is static, else None."""
    if any(t.matrix is None for t in step.terms):
        return None
    from qbot_tpu.tpu.planar import fold_window_static
    return fold_window_static(step)


def _detect_reflections(steps: list[Step], n: int) -> list[Step]:
    """Replace ``windows_A · flip(idx) · windows_B`` with a ReflectStep when
    B is the blockwise inverse of A (same window partition, B_w ≈ A_w†).

    Runs before flip fusion, so flips are still standalone and
    window runs are contiguous.  Windows on disjoint qubits commute, so
    matching is by (start, width) regardless of order within each run.
    """
    out: list[Step] = list(steps)
    i = 0
    while i < len(out):
        step = out[i]
        if not isinstance(step, FlipStep):
            i += 1
            continue
        # maximal window runs around the flip
        a_lo = i
        while a_lo > 0 and isinstance(out[a_lo - 1], WindowStep):
            a_lo -= 1
        b_hi = i + 1
        while b_hi < len(out) and isinstance(out[b_hi], WindowStep):
            b_hi += 1
        a_run = out[a_lo:i]
        b_run = out[i + 1:b_hi]
        if not a_run or not b_run:
            i += 1
            continue
        a_by = {(w.start, w.width): w for w in a_run}
        b_by = {(w.start, w.width): w for w in b_run}
        if len(a_by) != len(a_run) or set(a_by) != set(b_by):
            i += 1
            continue
        mats = {}
        ok = True
        for key, wa in a_by.items():
            ma = _static_window_matrix(wa)
            mb = _static_window_matrix(b_by[key])
            if ma is None or mb is None or not np.allclose(
                    mb, ma.conj().T, atol=1e-9):
                ok = False
                break
            mats[key] = ma
        if not ok:
            i += 1
            continue
        # v = A† |idx⟩, a product over blocks tiling [0, n):
        # window block → conj of row idx_w of A_w; gap block → basis vector
        idx = step.index
        factors: list[np.ndarray] = []
        covered = sorted(a_by)
        q = 0
        for start, width in covered + [(n, 0)]:
            if q < start:                # gap: identity window
                gap = start - q
                bits = (idx >> (n - start)) & ((1 << gap) - 1)
                e = np.zeros(2**gap, np.complex128)
                e[bits] = 1.0
                factors.append(e)
            if width:
                w_idx = (idx >> (n - start - width)) & ((1 << width) - 1)
                factors.append(np.conj(mats[(start, width)][w_idx, :]))
            q = start + width
        out[a_lo:b_hi] = [ReflectStep(tuple(factors),
                                      tuple(out[a_lo:b_hi]))]
        i = a_lo + 1
    return out


def expand_reflections(steps):
    """Iterate steps with ReflectSteps expanded back to their window/flip
    form (for executors without a reflection fast path)."""
    for step in steps:
        if isinstance(step, ReflectStep):
            yield from step.original
        else:
            yield step


def _fuse_phases(steps: list[Step]) -> list[Step]:
    """Attach each PhaseStep to the next WindowStep as a fused pre-phase.

    Controlled phases are diagonal, so consecutive ones commute with each
    other (and with FlipSteps) but not with a later unitary — each run of
    PhaseSteps may only fuse into the *first* subsequent window.  Phases
    with no fusable successor stay standalone (executors apply them as one
    masked elementwise pass).
    """
    out: list[Step] = []
    pending: list[PhaseStep] = []
    for step in steps:
        if isinstance(step, PhaseStep):
            pending.append(step)
            continue
        if pending and isinstance(step, WindowStep):
            step = WindowStep(
                step.start, step.width, step.terms, step.pre_flips,
                step.pre_phases + tuple((p.qubits, p.phase, p.pattern)
                                        for p in pending))
            pending.clear()
        elif pending and not isinstance(step, FlipStep):
            # flips are diagonal too: let a phase run pass over them so
            # both can fuse into the same following window
            out.extend(pending)
            pending.clear()
        out.append(step)
    out.extend(pending)
    return out


def phase_as_diag(step: PhaseStep) -> DiagStep:
    """Equivalent DiagStep (for executors that apply phases as diagonals)."""
    k = len(step.qubits)
    d = np.ones(2**k, np.complex128)
    d[step.pattern if step.pattern >= 0 else 2**k - 1] = step.phase
    return DiagStep(tuple(step.qubits), d)


def expand_phases(steps):
    """Iterate steps with fused pre-phases re-materialised as DiagSteps
    (and standalone PhaseSteps converted), for executors that apply
    diagonals as their own pass (density / sharded / complex oracle)."""
    for step in steps:
        if isinstance(step, PhaseStep):
            yield phase_as_diag(step)
        elif isinstance(step, WindowStep) and step.pre_phases:
            for qubits, z, pat in step.pre_phases:
                yield phase_as_diag(PhaseStep(qubits, z, pat))
            yield WindowStep(step.start, step.width, step.terms,
                             step.pre_flips)
        else:
            yield step


def _fuse_flips(steps: list[Step]) -> list[Step]:
    """Attach each FlipStep to the next WindowStep or ReflectStep as a
    fused pre-flip.

    A flip does not commute with later steps, so it may only fuse into the
    *first* subsequent step; flips not followed by a fusable step stay
    standalone.  Fusing into a ReflectStep keeps the replaced original
    steps prefixed with the flips so ``expand_reflections`` stays exact.
    """
    out: list[Step] = []
    pending: list[int] = []
    for step in steps:
        if isinstance(step, FlipStep):
            pending.append(step.index)
            continue
        if pending and isinstance(step, WindowStep):
            step = WindowStep(step.start, step.width, step.terms,
                              step.pre_flips + tuple(pending),
                              step.pre_phases)
            pending.clear()
        elif pending and isinstance(step, ReflectStep):
            step = ReflectStep(
                step.factors,
                tuple(FlipStep(i) for i in pending) + tuple(step.original),
                step.pre_flips + tuple(pending))
            pending.clear()
        elif pending:
            out.extend(FlipStep(i) for i in pending)
            pending.clear()
        out.append(step)
    out.extend(FlipStep(i) for i in pending)
    return out
