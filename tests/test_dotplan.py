"""Dot-engine executor (dotplan.py) vs the planar executor.

The dot engine applies each window as ONE realified in-place XLA dot.
These tests pin its semantics to the step executor on every step kind
it lowers.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qbot_tpu.tpu.circuit import (
    Circuit,
    grover_circuit,
    parameterized_layers,
    random_circuit,
)
from qbot_tpu.tpu.compiler import compile_circuit
from qbot_tpu.tpu.dotplan import apply_plan_dot, lower_dot_plan
from qbot_tpu.tpu.planar import apply_plan_planar, to_planar

F32TOL = 5e-6


def _rand_state(n, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    z /= np.linalg.norm(z)
    return jnp.asarray(to_planar(z))


def _brickwork(n, layers, seed=0):
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    for layer in range(layers):
        for q in range(n):
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            qm, r = np.linalg.qr(z)
            c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())), [q])
        for q in range(layer % 2, n - 1, 2):
            c.gate(X, [q + 1], controls=[q])
    return c


def _compare(circ, w, seed=1, params=None):
    plan = compile_circuit(circ, window=w)
    lowered = lower_dot_plan(plan)
    assert lowered is not None, "dot lowering bailed"
    assert lowered.final_perm == lowered.entry_perm
    psi0 = _rand_state(circ.n, seed)
    ref = apply_plan_planar(psi0, plan, params)
    out = apply_plan_dot(psi0, lowered, params)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=F32TOL)


class TestDifferential:
    @pytest.mark.parametrize("w", [3, 4, 5])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_brickwork(self, w, seed):
        _compare(_brickwork(8, 3, seed), w, seed)

    @pytest.mark.parametrize("w", [3, 5])
    def test_random_circuit(self, w):
        _compare(random_circuit(7, 3, seed=4), w)

    def test_parameterized(self):
        circ = parameterized_layers(6, 2)
        rng = np.random.default_rng(3)
        params = jnp.asarray(
            rng.uniform(0, 2 * np.pi, circ.num_params).astype(np.float32))
        _compare(circ, 4, params=params)

    def test_standalone_diagonal(self):
        c = Circuit(6)
        for q in range(6):
            c.h(q)
        rng = np.random.default_rng(9)
        d = np.exp(1j * rng.uniform(0, 2 * np.pi, 8))
        c.diagonal(d, [1, 3, 5])         # non-contiguous targets
        for q in range(6):
            c.h(q)
        _compare(c, 3)

    def test_grover_reflections(self):
        circ = grover_circuit(6, marked=11, iterations=3)
        plan = compile_circuit(circ, window=3)
        lowered = lower_dot_plan(plan)
        if lowered is None:             # pure-reflect plans may not carry
            pytest.skip("no window step to close the cycle on")
        _compare(circ, 3)

    def test_spanning_gate_contract(self):
        c = _brickwork(7, 2, seed=5)
        rng = np.random.default_rng(6)
        z = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
        qm, r = np.linalg.qr(z)
        c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())),
               [0, 6])                   # spans every window partition
        c2 = _brickwork(7, 1, seed=7)
        for op in c2.ops:
            c.ops.append(op)
        _compare(c, 3)


class TestRestoreBlocks:
    def test_many_block_restore(self, ):
        """Deep scatter: the final restore spans 3+ blocks, exercising the
        block-letter pool (a label collision with the reserved x/i/c/j
        letters slipped past the small cases)."""
        _compare(_brickwork(12, 4, seed=11), 3, seed=12)

    @pytest.mark.parametrize("w", [3, 4])
    def test_dot_partition_at_14q(self, w):
        """The pinned-tail partition (boundaries at n-10 and n-7) lowers
        and matches the planar executor at a size where the tail blocks
        are real (8, 128) axes."""
        from qbot_tpu.tpu.compiler import compile_circuit

        circ = _brickwork(14, 3, seed=13)
        plan = compile_circuit(circ, window=w, partition="dot")
        lowered = lower_dot_plan(plan)
        assert lowered is not None
        assert lowered.final_perm == lowered.entry_perm
        psi0 = _rand_state(14, 14)
        ref = apply_plan_planar(psi0, compile_circuit(circ, window=w))
        out = apply_plan_dot(psi0, lowered)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=F32TOL)


class TestCycle:
    def test_scanned_body_matches_sequential(self):
        circ = _brickwork(7, 2, seed=8)
        plan = compile_circuit(circ, window=4)
        lowered = lower_dot_plan(plan)
        psi0 = _rand_state(7, 4)

        @jax.jit
        def scanned(p):
            def body(c, _):
                return apply_plan_dot(c, lowered), None
            out, _ = jax.lax.scan(body, p, None, length=3)
            return out

        ref = psi0
        for _ in range(3):
            ref = apply_plan_planar(ref, plan)
        np.testing.assert_allclose(np.asarray(scanned(psi0)),
                                   np.asarray(ref), atol=2e-5)


class TestGradients:
    def test_grad_matches_planar(self):
        circ = parameterized_layers(5, 2)
        plan = compile_circuit(circ, window=3)
        lowered = lower_dot_plan(plan)
        psi0 = _rand_state(5, 5)
        target = _rand_state(5, 6)

        def loss_dot(theta):
            out = apply_plan_dot(psi0, lowered, theta)
            return jnp.sum((out - target) ** 2)

        def loss_planar(theta):
            out = apply_plan_planar(psi0, plan, theta)
            return jnp.sum((out - target) ** 2)

        theta = jnp.asarray(np.linspace(0.1, 1.0, circ.num_params),
                            dtype=jnp.float32)
        g1 = jax.grad(loss_dot)(theta)
        g2 = jax.grad(loss_planar)(theta)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   atol=1e-4)


class TestViewInvariants:
    """Layout discipline: every lowered view keeps the plan's LITERAL
    trailing (2^sub, 2^lane) dims (reshapes between passes stay
    bitcasts), and no size-1 axes appear in window specs."""

    def _brick(self, n, layers):
        rng = np.random.default_rng(0)
        c = Circuit(n)
        X = np.array([[0, 1], [1, 0]], dtype=complex)
        for layer in range(layers):
            for q in range(n):
                z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                qm, r = np.linalg.qr(z)
                c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())),
                       [q])
            for q in range(layer % 2, n - 1, 2):
                c.gate(X, [q + 1], controls=[q])
        return c

    @pytest.mark.parametrize("n,part", [(26, "dot"), (26, "step"),
                                        (20, "dot"), (16, "step")])
    def test_trailing_dims_identical_across_views(self, n, part):
        from qbot_tpu.tpu.dotplan import _Win, lower_dot_plan

        plan = compile_circuit(self._brick(n, 4), 7, partition=part)
        low = lower_dot_plan(plan)
        assert low is not None
        wins = [s for s in low.steps if isinstance(s, _Win)]
        assert wins
        trailing = {tuple(s.view[-2:]) for s in wins}
        assert len(trailing) == 1, trailing
        front, sub, lane = low.tail
        assert trailing == {(2 ** sub, 2 ** lane)}
        for s in wins:
            assert 1 not in s.view, s.view

    def test_brickwork_pass_count_is_twelve(self):
        """The support-based lazy flushing + all-odd dot boundaries keep
        the 4-layer 26q brickwork at 12 window passes."""
        from qbot_tpu.tpu.dotplan import _Win, lower_dot_plan

        plan = compile_circuit(self._brick(26, 4), 7, partition="dot")
        low = lower_dot_plan(plan)
        wins = [s for s in low.steps if isinstance(s, _Win)]
        assert len(wins) == 12
        assert sum(len(s.phases) for s in wins) == 6


class TestDensityDotEngine:
    """Round-4: mixed states run on the in-place dot engine — the plan
    rewrites to a 2n-qubit rows+conjugated-columns plan (density_plan_2n)
    and must match the step-by-step density executor exactly."""

    def _plan_both(self, c, w=4):
        import jax.numpy as jnp

        from qbot_tpu.tpu.planar import apply_plan_density_planar

        rng = np.random.default_rng(11)
        n = c.n
        # random mixed state: convex mix of two pure states
        k1 = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
        k2 = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
        k1, k2 = k1 / np.linalg.norm(k1), k2 / np.linalg.norm(k2)
        rho = 0.6 * np.outer(k1, k1.conj()) + 0.4 * np.outer(k2, k2.conj())
        rp = jnp.asarray(np.stack([rho.real, rho.imag]).astype(np.float32))

        plan = compile_circuit(c, w)
        plan.engine = "step"
        ref = apply_plan_density_planar(rp, plan)
        plan_dot = compile_circuit(c, w)
        plan_dot.engine = "dot"
        got = apply_plan_density_planar(rp, plan_dot)
        return np.asarray(ref), np.asarray(got)

    def test_matches_density_executor(self):
        rng = np.random.default_rng(5)
        c = Circuit(6)
        X = np.array([[0, 1], [1, 0]], dtype=complex)
        for layer in range(2):
            for q in range(6):
                z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                qm, r = np.linalg.qr(z)
                c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())),
                       [q])
            for q in range(layer % 2, 5, 2):
                c.gate(X, [q + 1], controls=[q])
        ref, got = self._plan_both(c)
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_flip_and_diag_steps(self):
        c = Circuit(5)
        for q in range(5):
            c.h(q)
        c.phase_flip(13)
        rng = np.random.default_rng(9)
        d = np.exp(1j * rng.uniform(0, 2 * np.pi, 4))
        c.diagonal(d, [0, 4])
        for q in range(5):
            c.h(q)
        ref, got = self._plan_both(c, w=3)
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_large_register_lowers(self):
        """At 2n >= 14 the pinned-tail machinery engages (the density
        sizes that actually need the engine)."""
        from qbot_tpu.tpu.dotplan import density_plan_2n, lower_dot_plan

        rng = np.random.default_rng(2)
        c = Circuit(8)
        for q in range(8):
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            qm, r = np.linalg.qr(z)
            c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())), [q])
        plan = compile_circuit(c, 4)
        big = density_plan_2n(plan)
        low = lower_dot_plan(big)
        assert low is not None
        ref, got = self._plan_both(c, w=4)
        np.testing.assert_allclose(got, ref, atol=1e-5)


class TestRenormCadence:
    """Free-cadence renormalisation (round 5, VERDICT r4 #8): the norm
    reduction fuses into the body's last pass and the 1/sqrt(norm)
    correction folds into the NEXT body's first window matrix
    (apply_plan_dot ``prescale``) — verified by scanning a deliberately
    norm-inflating body and checking unit norm + unchanged direction."""

    def _runner(self, renorm_every, repeats=8):
        from qbot_tpu.tpu.planar import make_scanned_planar_runner

        n = 14
        c = Circuit(n)
        H = np.array([[1, 1], [1, -1]], complex) / np.sqrt(2)
        c.gate(1.5 * H, [0])          # norm grows 1.5x per body
        c.gate(H, [5])
        plan = compile_circuit(c, 4)
        plan.engine = "dot"
        return make_scanned_planar_runner(plan, repeats,
                                          renorm_every=renorm_every), n

    def test_unit_norm_and_direction(self):
        from qbot_tpu.tpu.planar import zero_state_planar

        base, n = self._runner(0)
        ren, _ = self._runner(1)
        psi0 = zero_state_planar(n)
        a = np.asarray(base(psi0))
        b = np.asarray(ren(psi0))
        assert abs(float((b ** 2).sum()) - 1.0) < 1e-5
        a_unit = a / np.sqrt((a ** 2).sum())
        np.testing.assert_allclose(b, a_unit, atol=1e-5)

    def test_cadence_two_lands_final_correction(self):
        from qbot_tpu.tpu.planar import zero_state_planar

        base, n = self._runner(0)
        ren2, _ = self._runner(2)
        psi0 = zero_state_planar(n)
        a = np.asarray(base(psi0))
        b = np.asarray(ren2(psi0))
        # 8 bodies, renorm every 2: the exit correction lands the last
        # pending 1/sqrt(norm), so the result is exactly unit-norm too
        assert abs(float((b ** 2).sum()) - 1.0) < 1e-5
        a_unit = a / np.sqrt((a ** 2).sum())
        np.testing.assert_allclose(b, a_unit, atol=1e-5)
