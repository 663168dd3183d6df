"""Probabilistic control flow ON the device particle axis.

:mod:`qbot_tpu.frontend.ensemble` runs ProbVal-conditioned control flow with
host-side dense density matrices; this module is its device twin — the
bridge SURVEY.md §7 decision 2 calls for: the *classical* side of a particle
(namespace, program counter, weight) stays host-side Python, while its
*quantum* register is a :class:`~qbot_tpu.inference.ensemble_exec.QuantumEnsemble`
— a weighted batch of planar pure states living on the device.  A
ProbVal-conditioned ``cjmp``/``halt``/``retr`` forks the host particle; the
forked branches SHARE the device arrays (immutable), so a fork costs zero
device work.  ProbVal-valued *operands* (gate, targets, controls,
conditional) fan out on the device particle axis instead of mixing a dense
ρ (reference fan-out: /root/reference/qbot/probVal.py:347-390 through
operators.py:308).

Supported surface: everything the host ensemble runner supports,
including targeted ``qset`` (replace-subset — reference
``replaceArbitrary``, operators.py:133-166 — as a per-particle partial
trace + tensor insert; exact fan-out mode).  ``meas``/``disc`` fan or
sample device particles exactly like the lowered mid-measurement path; a
final merge mixes each branch's ensemble to a density matrix and reuses
the host runner's namespace merge, so ``executeTxtEnsemble`` and this
runner return THE SAME merged namespace (differentially tested).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import qbot_tpu.errors as err
from qbot_tpu.basis import Basis
from qbot_tpu.frontend import operations as ops
from qbot_tpu.frontend.ensemble import (
    MAX_PARTICLES,
    EnsembleResult,
    _clone_ns,
    _merge_particles,
    _truth_probability,
)
from qbot_tpu.frontend.evaluation import evaluate_expr
from qbot_tpu.frontend.interpreter import record_marks, tokenize_line
from qbot_tpu.helpers import int_log2
from qbot_tpu.probval import ProbVal

__all__ = ["execute_lines_device_ensemble", "executeTxtDeviceEnsemble"]

_QUANTUM_OPS = ("qset", "gate", "swap", "disc", "meas", "peek")


@dataclass
class _DeviceParticle:
    prob: float
    ns: dict
    line: int
    qreg: Optional[object] = None        # QuantumEnsemble | None
    n: int = 0                           # current register width
    done: bool = False


class _Engine:
    """Per-run device engine state (lazy imports, PRNG key, knobs).

    The quantum-op executor :func:`_exec_quantum` talks to the engine only
    through this method surface, so the sharded engine
    (:class:`_ShardedEngine`) swaps in mesh-collective twins of every
    operation while the ProbVal control-flow machinery stays untouched.
    """

    def __init__(self, max_particles: int, window: int, collapse_mode: str,
                 sample: int, seed: int):
        import jax

        from qbot_tpu.inference import ensemble_exec as ee
        from qbot_tpu.tpu import compiler, planar

        self.ee = ee
        self.compiler = compiler
        self.planar = planar
        self.jax = jax
        self.max_particles = max_particles
        self.window = window
        self.collapse_mode = collapse_mode
        self.sample = sample
        self.key = jax.random.PRNGKey(seed)

    def next_key(self):
        self.key, sub = self.jax.random.split(self.key)
        return sub

    # -- state construction -------------------------------------------------
    def init_pure(self, vec: np.ndarray):
        import jax.numpy as jnp

        from qbot_tpu.tpu.planar import to_planar
        return self.ee.init_ensemble(jnp.asarray(to_planar(vec)))

    def init_mixed(self, rho: np.ndarray):
        return self.ee.init_mixed_ensemble(rho)

    def replicate(self, qreg):
        """SMC regime: replicate to the fixed population up front."""
        import jax.numpy as jnp

        reps = max(1, self.sample // qreg.num_particles)
        return self.ee.QuantumEnsemble(
            jnp.repeat(qreg.log_w, reps) - float(np.log(reps)),
            jnp.repeat(qreg.psi, reps, axis=0), qreg.lost_mass)

    def num_particles(self, qreg) -> int:
        return qreg.num_particles

    # -- unitaries ----------------------------------------------------------
    def apply_circuit(self, qreg, circ):
        plan = self.compiler.compile_circuit(circ, window=self.window)
        return self.ee.apply_plan_ensemble(qreg, plan)

    def one_gate(self, qreg, n, matrix, targets, controls):
        from qbot_tpu.tpu.circuit import Circuit

        circ = Circuit(n)
        circ.gate(np.asarray(matrix, complex), list(targets), list(controls))
        return self.apply_circuit(qreg, circ)

    def rotate(self, qreg, n, basis, targets, inverse=False):
        """Basis rotation (B† per block, or its inverse) — None-safe."""
        from qbot_tpu.frontend.lowering import _basis_rotation_plans

        rot, inv = _basis_rotation_plans(basis, list(targets), n,
                                         self.window)
        plan = inv if inverse else rot
        if plan is None:
            return qreg
        return self.ee.apply_plan_ensemble(qreg, plan)

    # -- collapse events ----------------------------------------------------
    def measure(self, qreg, n, targets):
        if self.sample:
            qreg, dist, _ = self.ee.measure_sample(
                self.next_key(), qreg, n, targets)
            return qreg, dist
        return self.ee.measure_fanout(qreg, n, targets, self.max_particles,
                                      mode=self.collapse_mode)

    def discard(self, qreg, n, targets):
        if self.sample:
            return self.ee.discard_sample(self.next_key(), qreg, n, targets)
        return self.ee.discard_fanout(qreg, n, targets, self.max_particles)

    def peek(self, qreg, n, targets):
        return self.ee.peek_probs(qreg, n, targets)

    def replace(self, qreg, n, targets, new_states):
        """Targeted qset (reference ``replaceArbitrary`` semantics):
        partial-trace the targets out per particle and tensor the new
        state's eigen-branches back in at the same positions.  Sample
        mode draws ONE traced outcome + ONE new-state branch per
        particle (constant population, VERDICT r4 #5)."""
        if self.sample:
            return self.ee.replace_sample(self.next_key(), qreg, n,
                                          list(targets), new_states)
        return self.ee.replace_fanout(qreg, n, list(targets), new_states,
                                      self.max_particles)

    # -- branch bookkeeping -------------------------------------------------
    def concat(self, weighted):
        """Weight-concatenate [(p, QuantumEnsemble)] into one ensemble.

        ``lost_mass`` is threaded through: a p-weighted mixture of
        ensembles with TV error bounds ε_i carries bound Σ p_i ε_i / Σ p_i,
        and any subsequent prune accumulates on top of that.  Sample
        mode resamples back down to the fixed population instead of the
        (biased) top-k prune.
        """
        if self.sample:
            B = min(q.num_particles for _, q in weighted)
            return self.ee.concat_resampled(self.next_key(), weighted, B)
        return self.ee.concat_weighted(weighted, self.max_particles)

    def prune(self, qreg):
        from qbot_tpu.inference.ensemble_exec import QuantumEnsemble, _prune
        if qreg.num_particles <= self.max_particles:
            return qreg
        log_w, psi, lost = _prune(qreg.log_w, qreg.psi, self.max_particles,
                                  qreg.lost_mass)
        return QuantumEnsemble(log_w, psi, lost)

    def mixture(self, qreg) -> np.ndarray:
        return self.ee.ensemble_mixture(qreg)

    def lost_mass(self, qreg) -> float:
        return float(np.asarray(qreg.lost_mass))


class _ShardedEngine(_Engine):
    """Mesh twin: particle batches shard over the ``particles`` axis and
    each register over the ``qubits`` axis (SURVEY.md §7 decision 2 —
    "branch count B is a sharding axis").

    Every operation keeps the CANONICAL identity qubit layout (appending
    :func:`~qbot_tpu.tpu.sharded.plan_perm_to_identity` items after any
    compiled segment that resharded), so ensembles from different program
    branches stay concatenable and measurement outcome bits read in
    logical order without host-side reordering.
    """

    def __init__(self, max_particles, window, collapse_mode, sample, seed,
                 mesh):
        super().__init__(max_particles, window, collapse_mode, sample, seed)
        from qbot_tpu.tpu import sharded_ensemble as se

        self.se = se
        self.emesh = se.EnsembleMesh(mesh)
        self.k = self.emesh.k

    def q_ok(self, n: int) -> bool:
        """Can an n-qubit register shard over the qubit axis?  Needs
        n − k >= k (compile_sharded's guard); smaller registers replicate
        over the qubit axis and parallelise on particles only."""
        return self.k > 0 and n - self.k >= self.k

    def _keff(self, n: int) -> int:
        return self.k if self.q_ok(n) else 0

    # -- state construction -------------------------------------------------
    def init_pure(self, vec: np.ndarray):
        from qbot_tpu.tpu.planar import to_planar
        n = int_log2(np.asarray(vec).shape[0])
        return self.se.init_sharded_ensemble(to_planar(vec), self.emesh,
                                             q_sharded=self.q_ok(n))

    def init_mixed(self, rho: np.ndarray):
        from qbot_tpu.tpu.planar import to_planar
        n = int_log2(np.asarray(rho).shape[0])
        vals, vecs = np.linalg.eigh(np.asarray(rho, complex))
        keep = vals > 1e-12
        vals, vecs = vals[keep], vecs[:, keep]
        psi = np.stack([to_planar(vecs[:, i]) for i in range(vals.shape[0])])
        return self.se.init_sharded_ensemble(
            psi, self.emesh, log_w=np.log(vals / vals.sum()),
            q_sharded=self.q_ok(n))

    def replicate(self, qreg):
        w, kets = self.se.gather_ensemble(qreg)
        from qbot_tpu.tpu.planar import to_planar
        n = int_log2(kets.shape[-1])
        reps = max(1, self.sample // kets.shape[0])
        psi = np.repeat(np.stack([to_planar(kk) for kk in kets]), reps,
                        axis=0)
        lw = np.repeat(np.log(np.clip(w, 1e-300, None)), reps) - np.log(reps)
        return self.se.init_sharded_ensemble(psi, self.emesh, log_w=lw,
                                             q_sharded=self.q_ok(n))

    def num_particles(self, qreg) -> int:
        # count live particles (dead pad slots carry ~-1e30 log-weight)
        return int(np.sum(np.asarray(qreg.log_w) > -1e29))

    # -- unitaries ----------------------------------------------------------
    def _apply_canonical(self, qreg, circ):
        """Compile on the identity layout, run, restore the identity."""
        from qbot_tpu.tpu.sharded import (
            ShardedPlan,
            compile_sharded,
            plan_perm_to_identity,
        )

        keff = self._keff(circ.n)
        splan = compile_sharded(circ, keff, window=self.window)
        fix, perm = plan_perm_to_identity(splan.final_perm, circ.n, keff)
        if fix:
            splan = ShardedPlan(n=splan.n, k=splan.k,
                                items=list(splan.items) + fix,
                                final_perm=perm,
                                num_params=splan.num_params,
                                gate_count=splan.gate_count)
        return self.se.apply_sharded_plan_ensemble(qreg, splan, self.emesh)

    def apply_circuit(self, qreg, circ):
        return self._apply_canonical(qreg, circ)

    def rotate(self, qreg, n, basis, targets, inverse=False):
        from qbot_tpu.tpu.circuit import Circuit

        is_comp = basis.numQubits == 1 and all(
            np.allclose(kt, e) for kt, e in zip(
                basis.kets, np.eye(2, dtype=complex)))
        if is_comp:
            return qreg
        rot = np.stack(basis.kets).conj()
        if inverse:
            rot = rot.conj().T
        bq = basis.numQubits
        circ = Circuit(n)
        targets = sorted(targets)
        for i in range(0, len(targets), bq):
            circ.gate(rot, list(targets[i:i + bq]))
        return self._apply_canonical(qreg, circ)

    # -- collapse events ----------------------------------------------------
    def _layout(self, n, targets):
        """(shard positions, local axes) of sorted targets on the identity
        layout; outcome bit order is automatically logical-sorted."""
        targets = sorted(targets)
        keff = self._keff(n)
        shard_pos = [q for q in targets if q < keff]
        local = [q - keff for q in targets if q >= keff]
        return shard_pos, local

    def _localized(self, qreg, n, targets):
        """Apply reshards making targets local; returns (qreg, perm)."""
        from qbot_tpu.tpu.sharded import (
            ShardedPlan,
            plan_reshards_to_localize,
        )

        keff = self._keff(n)
        items, perm = plan_reshards_to_localize(
            list(range(n)), n, keff, sorted(targets))
        if items:
            splan = ShardedPlan(n=n, k=keff, items=items, final_perm=perm)
            qreg = self.se.apply_sharded_plan_ensemble(qreg, splan,
                                                       self.emesh)
        return qreg, perm

    def _restore(self, qreg, n, perm):
        from qbot_tpu.tpu.sharded import ShardedPlan, plan_perm_to_identity

        keff = self._keff(n)
        items, out = plan_perm_to_identity(perm, n, keff)
        if items:
            splan = ShardedPlan(n=n, k=keff, items=items, final_perm=out)
            qreg = self.se.apply_sharded_plan_ensemble(qreg, splan,
                                                       self.emesh)
        return qreg

    def measure(self, qreg, n, targets):
        targets = sorted(targets)
        q_s = self.q_ok(n)
        shard_pos, local = self._layout(n, targets)
        if self.sample:
            qreg, dist = self.se.measure_sample_sharded(
                self.next_key(), qreg, n, local, self.emesh,
                shard_positions=shard_pos, q_sharded=q_s)
            return qreg, np.asarray(dist)
        mode = self.collapse_mode
        if mode == "reference" and shard_pos:
            if len(targets) == n:
                mode = "projective"      # identical semantics on all-qubits
            else:
                from qbot_tpu.frontend.lowering import _reorder_outcome_bits

                keff = self._keff(n)
                qreg, perm = self._localized(qreg, n, targets)
                pos = [0] * n
                for p, q in enumerate(perm):
                    pos[q] = p
                local = sorted(pos[q] - keff for q in targets)
                phys_logicals = [perm[a + keff] for a in local]
                qreg, dist = self.se.measure_fanout_sharded(
                    qreg, n, local, self.emesh, self.max_particles,
                    mode=mode, q_sharded=q_s)
                qreg = self._restore(qreg, n, perm)
                dist = _reorder_outcome_bits(np.asarray(dist),
                                             phys_logicals, targets)
                return qreg, dist
        qreg, dist = self.se.measure_fanout_sharded(
            qreg, n, local, self.emesh, self.max_particles, mode=mode,
            shard_positions=shard_pos, q_sharded=q_s)
        return qreg, np.asarray(dist)

    def discard(self, qreg, n, targets):
        targets = sorted(targets)
        q_s = self.q_ok(n)
        keff = self._keff(n)
        qreg, perm = self._localized(qreg, n, targets)
        pos = [0] * n
        for p, q in enumerate(perm):
            pos[q] = p
        local = sorted(pos[q] - keff for q in targets)
        if self.sample:
            qreg = self.se.discard_sample_sharded(
                self.next_key(), qreg, n, local, self.emesh, q_sharded=q_s)
        else:
            qreg = self.se.discard_fanout_sharded(
                qreg, n, local, self.emesh, self.max_particles,
                q_sharded=q_s)
        removed = {pos[q] for q in targets}
        new_perm = [q - sum(1 for r in targets if r < q)
                    for p, q in enumerate(perm) if p not in removed]
        new_n = n - len(targets)
        if q_s and not self.q_ok(new_n):
            # the shrunk register no longer shards over the qubit axis:
            # gather (it is tiny now — at most 2^(2k−1) amplitudes),
            # restore logical order on the host, re-place replicated
            from qbot_tpu.tpu.planar import to_planar

            w, kets = self.se.gather_ensemble(qreg, new_perm)
            psi = np.stack([to_planar(kk) for kk in kets])
            lw = np.log(np.clip(w, 1e-300, None))
            fresh = self.se.init_sharded_ensemble(
                psi, self.emesh, log_w=lw, q_sharded=False)
            return self.se.ShardedEnsemble(fresh.log_w, fresh.psi,
                                           qreg.lost_mass)
        return self._restore(qreg, new_n, new_perm)

    def peek(self, qreg, n, targets):
        shard_pos, local = self._layout(n, sorted(targets))
        return np.asarray(self.se.peek_probs_sharded(
            qreg, n, local, self.emesh, shard_positions=shard_pos,
            q_sharded=self.q_ok(n)))

    def replace(self, qreg, n, targets, new_states):
        """Targeted qset on the mesh: localize, replace shard-locally
        (perm unchanged), restore the canonical layout.  Sample mode
        draws one traced outcome + one new-state branch per particle
        (constant population)."""
        q_s = self.q_ok(n)
        keff = self._keff(n)
        qreg, perm = self._localized(qreg, n, sorted(targets))
        pos = [0] * n
        for p, q in enumerate(perm):
            pos[q] = p
        local = [pos[q] - keff for q in targets]      # order preserved
        if self.sample:
            qreg = self.se.replace_sample_sharded(
                self.next_key(), qreg, n, local, new_states, self.emesh,
                q_sharded=q_s)
        else:
            qreg = self.se.replace_fanout_sharded(
                qreg, n, local, new_states, self.emesh,
                self.max_particles, q_sharded=q_s)
        return self._restore(qreg, n, perm)

    # -- branch bookkeeping -------------------------------------------------
    def concat(self, weighted):
        n = int_log2(weighted[0][1].psi.shape[-1])
        q_s = self.q_ok(n)
        cat = self.se.concat_sharded(weighted, self.emesh, q_sharded=q_s)
        if self.sample:
            B = min(q.num_particles for _, q in weighted)
            return self.se.resample_down_sharded(
                self.next_key(), cat, B, self.emesh, q_sharded=q_s)
        return self.prune(cat)

    def prune(self, qreg):
        n = int_log2(qreg.psi.shape[-1])
        return self.se.prune_sharded(qreg, self.max_particles, self.emesh,
                                     q_sharded=self.q_ok(n))

    def mixture(self, qreg) -> np.ndarray:
        return self.se.sharded_ensemble_mixture(qreg)

    def lost_mass(self, qreg) -> float:
        return float(np.asarray(qreg.lost_mass))


def _to_density_host(lines, line_num, val):
    if isinstance(val, ProbVal):
        try:
            return val.to_density_matrix()
        except Exception:
            raise err.type_error(lines, line_num,
                                 ["np.ndarray", "ProbVal<np.ndarray>"],
                                 val.type_string()) from None
    arr = np.asarray(val)
    if arr.ndim == 1:
        return np.outer(arr, arr.conj())
    return arr


def _fanout_args(lines, line_num, *vals):
    """Cartesian branches [(prob, concrete_vals)] of possibly-ProbVal vals."""
    branches = [(1.0, [])]
    for v in vals:
        if isinstance(v, ProbVal):
            branches = [(p * bp, acc + [bv])
                        for p, acc in branches
                        for bp, bv in zip(v.probs, v.values)]
        else:
            branches = [(p, acc + [v]) for p, acc in branches]
    return branches


def _exec_quantum(engine: _Engine, particle: _DeviceParticle, lines,
                  line_num, tokens) -> None:
    """Run one quantum op against the particle's device register."""
    from qbot_tpu.frontend.lowering import _make_result

    ns = particle.ns
    op_name = tokens[0]

    if op_name == "qset":
        if len(tokens) > 2:
            # TARGETED qset: replace a qubit subset in place (reference
            # replaceArbitrary, operators.py:133-166) — per-particle
            # partial trace + tensor insert on the device ensemble
            if particle.qreg is None:
                raise err.QbotScriptError(err.format_script_error(
                    lines, line_num, "DeviceEnsembleError",
                    "targeted qset before the register exists"),
                    line_num, "DeviceEnsembleError")
            from qbot_tpu.frontend.lowering import _new_state_branches

            val = evaluate_expr(lines, line_num, tokens[1], ns)
            tgts = evaluate_expr(lines, line_num, tokens[2], ns)
            n = particle.n

            def tlist(tv):
                tl = [int(q) for q in ops._ensure_container(
                    lines, line_num, tv)]
                for q in tl:
                    if q < 0 or q >= n:
                        raise err.index_error(lines, line_num, "target",
                                              q, n - 1)
                return tl

            if isinstance(tgts, ProbVal):
                parts = []
                for p, tv in zip(tgts.probs, tgts.values):
                    tl = tlist(tv)
                    nb = _new_state_branches(lines, line_num, val, len(tl))
                    parts.append((float(p),
                                  engine.replace(particle.qreg, n, tl, nb)))
                particle.qreg = engine.concat(parts)
            else:
                tl = tlist(tgts)
                nb = _new_state_branches(lines, line_num, val, len(tl))
                particle.qreg = engine.replace(particle.qreg, n, tl, nb)
            ns["__updated_state"] = True
            return
        val = evaluate_expr(lines, line_num, tokens[1], ns)
        ket = None if isinstance(val, ProbVal) else np.asarray(val)
        if ket is not None and ket.ndim == 1:
            # a ket is one pure particle: no 2^n × 2^n density detour,
            # which would not fit in host memory at device register sizes
            particle.n = int_log2(ket.shape[0])
            particle.qreg = engine.init_pure(ket / np.linalg.norm(ket))
        else:
            rho = _to_density_host(lines, line_num, val)
            particle.n = int_log2(rho.shape[0])
            vals, vecs = np.linalg.eigh(rho)
            if np.isclose(vals[-1], np.trace(rho).real, atol=1e-9):
                # pure state: a single particle, no mixture
                particle.qreg = engine.init_pure(vecs[:, -1])
            else:
                particle.qreg = engine.init_mixed(rho)
        if engine.sample:
            particle.qreg = engine.replicate(particle.qreg)
        ns["__is_q_state"] = True
        ns["__updated_state"] = True
        return

    if particle.qreg is None:
        raise err.QbotScriptError(err.format_script_error(
            lines, line_num, "DeviceEnsembleError",
            f"{op_name} before qset"), line_num, "DeviceEnsembleError")
    n = particle.n

    if op_name == "gate":
        g = evaluate_expr(lines, line_num, tokens[1], ns)
        first = (evaluate_expr(lines, line_num, tokens[2], ns)
                 if len(tokens) > 2 else 0)
        ops._check_probval_type(lines, line_num, first, ops._INT_TYPES)
        controls = (ops._ensure_container(
            lines, line_num, evaluate_expr(lines, line_num, tokens[3], ns))
            if len(tokens) > 3 else [])
        cond = (evaluate_expr(lines, line_num, tokens[4], ns)
                if len(tokens) > 4 else True)
        ops._check_probval_type(lines, line_num, cond, bool)
        if not isinstance(cond, ProbVal) and not cond:
            return

        weighted = []
        for p, (gv, fv, cv) in _fanout_args(lines, line_num, g, first,
                                            controls):
            gm = np.asarray(gv)
            k = int_log2(gm.shape[0])
            last = int(fv) + k - 1
            if fv < 0 or last > n - 1:
                raise err.index_error(lines, line_num, "target", int(fv),
                                      n - k)
            ctrls = list(cv)
            for c in ctrls:
                if c < 0 or c > n - 1:
                    raise err.index_error(lines, line_num, "control", c,
                                          n - 1)
                if fv <= c <= last:
                    raise err.control_target_overlap(lines, line_num, c,
                                                     int(fv), last)
            applied = engine.one_gate(particle.qreg, n, gm,
                                      range(int(fv), int(fv) + k), ctrls)
            weighted.append((p, applied))
        mixed = (weighted[0][1] if len(weighted) == 1
                 else engine.concat(weighted))
        if isinstance(cond, ProbVal):
            p_true, p_false = _truth_probability(cond, lines, line_num)
            # reference semantics: a ProbVal conditional MIXES applied and
            # unapplied states (operators.py:323-327) — on the particle
            # axis that is a weight-concat, not a host fork
            mixed = engine.concat([(max(p_true, 1e-300), mixed),
                                   (max(p_false, 1e-300), particle.qreg)])
        particle.qreg = mixed
        return

    if op_name == "swap":
        a = evaluate_expr(lines, line_num, tokens[1], ns)
        b = evaluate_expr(lines, line_num, tokens[2], ns)
        ops._check_probval_type(lines, line_num, a, ops._INT_TYPES)
        ops._check_probval_type(lines, line_num, b, ops._INT_TYPES)
        SWAP2 = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                          [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
        weighted = []
        for p, (av, bv) in _fanout_args(lines, line_num, a, b):
            for q in (av, bv):
                if q < 0 or q >= n:
                    raise err.index_error(lines, line_num, "target", int(q),
                                          n - 1)
            if av == bv:
                weighted.append((p, particle.qreg))
            else:
                weighted.append((p, engine.one_gate(
                    particle.qreg, n, SWAP2, [int(av), int(bv)], [])))
        particle.qreg = (weighted[0][1] if len(weighted) == 1
                         else engine.concat(weighted))
        return

    if op_name == "disc":
        targets = ops._ensure_container(
            lines, line_num, evaluate_expr(lines, line_num, tokens[1], ns))
        if isinstance(targets, ProbVal):
            # ProbVal target sets (/root/reference/qbot/operators.py:
            # 169-188 via funcWrapper): equal-size branches MIX into one
            # register on the particle axis (the reference folds the
            # fan-out to one ρ); differing sizes cannot share a batch, so
            # they fork HOST particles and merge as a ProbVal state
            branch_sets = []
            for p, tv in zip(targets.probs, targets.values):
                tset = sorted(set(int(q) for q in ops._ensure_container(
                    lines, line_num, tv)))
                ops._check_targets_in_range(lines, line_num, tset, n)
                branch_sets.append((float(p), tset))
            sizes = {len(t) for _, t in branch_sets}
            if len(sizes) != 1:
                # differing widths cannot fold into one register — the
                # reference's own toDensityMatrix fails on mixed shapes,
                # and the dense front-end renders the same type error
                raise err.type_error(lines, line_num,
                                     ["np.ndarray", "ProbVal<np.ndarray>"],
                                     "ProbVal<ndarray>")
            particle.qreg = engine.concat(
                [(p, engine.discard(particle.qreg, n, tset))
                 for p, tset in branch_sets])
            particle.n = n - sizes.pop()
            return
        targets = sorted(set(int(q) for q in targets))
        ops._check_targets_in_range(lines, line_num, targets, n)
        particle.qreg = engine.discard(particle.qreg, n, targets)
        particle.n = n - len(targets)
        return

    # meas / peek
    name = tokens[1]
    if not name.isidentifier():
        raise err.invalid_variable_name(lines, line_num, name)
    basis = evaluate_expr(lines, line_num, tokens[2], ns)
    if not isinstance(basis, Basis):
        raise err.type_error(lines, line_num, ["Basis"],
                             type(basis).__name__)
    targets = sorted(range(n)) if len(tokens) < 4 else sorted(set(
        int(q) for q in ops._ensure_container(
            lines, line_num,
            evaluate_expr(lines, line_num, tokens[3], ns))))
    ops._check_targets_in_range(lines, line_num, targets, n)
    # lazy dense-field provider: the pre-measurement mixture, gathered on
    # first .newState/.basisDensity access (clear error at large n)
    from qbot_tpu.frontend.lowering import (
        _DENSE_REPLAY_LIMIT,
        _too_large_provider,
    )

    if n <= _DENSE_REPLAY_LIMIT:
        provider = (lambda q=particle.qreg, e=engine: e.mixture(q))
    else:
        provider = _too_large_provider(n)
    qreg = engine.rotate(particle.qreg, n, basis, targets)
    if op_name == "meas":
        qreg, dist = engine.measure(qreg, n, targets)
        particle.qreg = engine.rotate(qreg, n, basis, targets, inverse=True)
    else:
        dist = engine.peek(qreg, n, targets)
    ns[name] = _make_result(basis, targets, np.asarray(dist),
                            provider=provider)


def _step_device_particle(engine: _Engine, particle: _DeviceParticle,
                          lines) -> list[_DeviceParticle]:
    """Run until halt/split/end; mirrors ensemble._step_particle with the
    quantum ops routed to the device engine."""
    ns = particle.ns
    line_num = particle.line - 1
    while line_num < len(lines) - 1:
        line_num += 1
        tokens = tokenize_line(lines[line_num])
        if not tokens:
            continue
        op_name = tokens[0]
        if op_name in ("note", "mark"):
            continue
        try:
            op, min_args, max_args = ops.OPERATIONS[op_name]
        except KeyError:
            raise err.unknown_operation(lines, line_num, op_name) from None
        num_args = len(tokens) - 1
        if num_args < min_args or num_args > max_args:
            raise err.num_arguments_error(lines, line_num, op_name, num_args,
                                          min_args, max_args)

        if op_name in _QUANTUM_OPS:
            forked = _exec_quantum(engine, particle, lines, line_num,
                                   tokens)
            if forked:
                return forked            # ProbVal disc fan-out
            continue

        if op_name in ("cjmp", "halt", "retr"):
            has_cond = num_args >= (2 if op_name == "cjmp" else 1)
            cond = True
            if has_cond:
                cond_token = tokens[2] if op_name == "cjmp" else tokens[1]
                cond = evaluate_expr(lines, line_num, cond_token, ns)
            if isinstance(cond, ProbVal):
                p_true, p_false = _truth_probability(cond, lines, line_num)
                children = []

                def _spawn(prob, target_line, clone, done=False,
                           prev_jump=None):
                    child_ns = _clone_ns(ns) if clone else ns
                    if prev_jump is not None:
                        child_ns["__prev_jump"] = prev_jump
                    # the device register is immutable: children share it
                    children.append(_DeviceParticle(
                        particle.prob * prob, child_ns, target_line,
                        particle.qreg, particle.n, done))

                if op_name == "cjmp":
                    taken = ops._mark_line(ns, lines, line_num, tokens[1])
                    if p_true > 0:
                        _spawn(p_true, taken, clone=p_false > 0,
                               prev_jump=line_num)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                elif op_name == "halt":
                    if p_true > 0:
                        _spawn(p_true, line_num + 1, clone=p_false > 0,
                               done=True)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                else:  # retr
                    if p_true > 0:
                        _spawn(p_true, ns["__prev_jump"] + 1,
                               clone=p_false > 0)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                return children
            if not isinstance(cond, bool):
                raise err.type_error(lines, line_num, ["bool"],
                                     type(cond).__name__)
            if op_name == "cjmp":
                target = ops._mark_line(ns, lines, line_num, tokens[1])
                if cond:
                    ns["__prev_jump"] = line_num
                    line_num = target - 1
                continue
            if op_name == "halt":
                if cond:
                    break
                continue
            if cond:                     # retr
                line_num = ns["__prev_jump"]
            continue

        result = op(ns, lines, line_num, tokens)
        if result is None:
            continue
        if result.halt:
            break
        if result.jump_line is not None:
            line_num = result.jump_line - 1

    particle.done = True
    return [particle]


def execute_lines_device_ensemble(lines: list[str],
                                  max_particles: int = MAX_PARTICLES,
                                  window: int = 7,
                                  collapse_mode: str = "reference",
                                  sample: int = 0,
                                  seed: int = 0,
                                  prune_tol: float = 1e-6,
                                  mesh=None):
    """Run a program with probabilistic control flow on the device engine.

    Returns (EnsembleResult, finished _DeviceParticles).  The merged
    namespace binds ``state`` to the branch-weighted mixture — identical to
    :func:`qbot_tpu.frontend.ensemble.execute_lines_ensemble`'s contract —
    while the per-branch device ensembles stay available on the particles.

    ``mesh``: a (particles × qubits) :class:`jax.sharding.Mesh` switches
    every quantum operation to the mesh-sharded engine — branch particles
    ride the ``particles`` axis and each register shards over ``qubits``
    (SURVEY.md §7 decision 2).  ProbVal control flow, branch forking, and
    the namespace merge are byte-identical to the single-device run.
    """
    if mesh is not None:
        engine = _ShardedEngine(max_particles, window, collapse_mode,
                                sample, seed, mesh)
    else:
        engine = _Engine(max_particles, window, collapse_mode, sample, seed)
    ns = {"state": None, "__updated_state": False, "__marks": {},
          "__prev_jump": -1}
    record_marks(ns, lines)

    live = [_DeviceParticle(1.0, ns, 0)]
    finished: list[_DeviceParticle] = []
    while live:
        particle = live.pop()
        for c in _step_device_particle(engine, particle, lines):
            (finished if c.done else live).append(c)
        if len(live) + len(finished) > max_particles:
            raise RuntimeError(
                f"probabilistic branching exceeded {max_particles} "
                f"particles; raise max_particles")

    # bind each branch's dense mixture so the host merge applies verbatim;
    # past _DENSE_REPLAY_LIMIT qubits a 2^n × 2^n host matrix does not
    # fit, so ``state`` stays unbound (the device ensembles remain on the
    # returned particles)
    from qbot_tpu.frontend.lowering import _DENSE_REPLAY_LIMIT
    from qbot_tpu.ops.core import empty_state
    dense = all(p.qreg is None or p.n <= _DENSE_REPLAY_LIMIT
                for p in finished)
    for p in finished:
        p.ns["state"] = (empty_state() if p.qreg is None
                         else engine.mixture(p.qreg) if dense else None)
    merged = _merge_particles(finished)
    if not dense:
        merged["state"] = None
        merged["__is_q_state"] = False
    # cumulative pruned-mass bound across branches: a prob-weighted mixture
    # of ensembles with TV bounds ε_i carries bound Σ prob_i·ε_i — surfaced
    # exactly like run_lowered_ensemble (lowering.py) so --compile
    # --ensemble never drops mass silently
    total_p = sum(p.prob for p in finished) or 1.0
    lost = sum(p.prob * engine.lost_mass(p.qreg)
               for p in finished if p.qreg is not None) / total_p
    if lost > prune_tol:
        import warnings
        warnings.warn(
            f"ensemble pruning dropped {lost:.3e} probability mass "
            f"(> prune_tol={prune_tol:g}); reported outcome probabilities "
            f"carry up to that much total-variation error — raise "
            f"max_particles or switch to sampling mode (sample > 0)",
            RuntimeWarning, stacklevel=2)
    return EnsembleResult(merged, [p.prob for p in finished],
                          [p.ns for p in finished], lost), finished


def executeTxtDeviceEnsemble(text: str,
                             max_particles: int = MAX_PARTICLES,
                             **kw) -> dict:
    """Device-engine twin of ``executeTxtEnsemble`` (same merged contract)."""
    res, _ = execute_lines_device_ensemble(text.splitlines(),
                                           max_particles, **kw)
    return res.namespace
