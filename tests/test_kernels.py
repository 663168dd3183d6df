"""Step-executor window and phase formulations vs complex oracles.

Each test runs one state geometry (middle window, trailing window, two
adjacent windows, fused flips and phases) through the plain XLA
formulation in :mod:`qbot_tpu.tpu.planar` and compares it with a dense
complex einsum or the complex executor.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from qbot_tpu.tpu import dotplan
from qbot_tpu.tpu.circuit import Circuit, random_circuit
from qbot_tpu.tpu.compiler import compile_circuit
from qbot_tpu.tpu.planar import (
    apply_plan_planar,
    from_planar,
    planar_window_apply,
    zero_state_planar,
)
from qbot_tpu.tpu.simulator import apply_plan, zero_state


def _rand_planar(n, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    return psi


class TestPlanarWindowApply:
    def test_left_multiply_geometry(self):
        """Middle window (a>1, B>=128)."""
        n, start, width = 10, 1, 2     # a=2, D=4, B=128
        psi = _rand_planar(n, 1)
        W = np.linalg.qr(np.random.default_rng(2).normal(size=(4, 4))
                         + 1j * np.random.default_rng(3).normal(size=(4, 4)))[0]
        planar = jnp.asarray(np.stack([psi.real, psi.imag]), dtype=jnp.float32)
        got = planar_window_apply(
            planar, n, start, width,
            jnp.asarray(W.real, jnp.float32), jnp.asarray(W.imag, jnp.float32))
        # oracle
        t = psi.reshape(2, 4, 128)
        want = np.einsum("ij,ajb->aib", W, t).reshape(-1)
        np.testing.assert_allclose(from_planar(np.asarray(got)), want,
                                   atol=1e-5)

    def test_right_multiply_geometry(self):
        """Trailing window (B==1)."""
        n, start, width = 10, 3, 7     # a=8, D=128, B=1
        psi = _rand_planar(n, 4)
        rng = np.random.default_rng(5)
        W = np.linalg.qr(rng.normal(size=(128, 128))
                         + 1j * rng.normal(size=(128, 128)))[0]
        planar = jnp.asarray(np.stack([psi.real, psi.imag]), dtype=jnp.float32)
        got = planar_window_apply(
            planar, n, start, width,
            jnp.asarray(W.real, jnp.float32), jnp.asarray(W.imag, jnp.float32))
        want = np.einsum("ij,aj->ai", W, psi.reshape(8, 128)).reshape(-1)
        np.testing.assert_allclose(from_planar(np.asarray(got)), want,
                                   atol=1e-4)

    def test_full_circuit_with_kernels(self):
        n = 10
        c = random_circuit(n, 2, seed=6)
        plan = compile_circuit(c)
        want = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan))
        got = apply_plan_planar(zero_state_planar(n), plan)
        np.testing.assert_allclose(from_planar(np.asarray(got)), want,
                                   atol=2e-5)

    def test_mode_validation(self):
        with pytest.raises(ValueError):
            dotplan.set_dot_mode("bogus")
        assert dotplan.dot_mode() == "f32"


class TestPairKernels:
    def _run_pair(self, n, s1, w1, s2, w2, seed, flips=()):
        rng = np.random.default_rng(seed)
        psi = _rand_planar(n, seed)
        D1, D2 = 2**w1, 2**w2
        W1 = np.linalg.qr(rng.normal(size=(D1, D1))
                          + 1j * rng.normal(size=(D1, D1)))[0]
        W2 = np.linalg.qr(rng.normal(size=(D2, D2))
                          + 1j * rng.normal(size=(D2, D2)))[0]
        planar = jnp.asarray(np.stack([psi.real, psi.imag]),
                             dtype=jnp.float32)
        assert s1 + w1 == s2
        got = planar_window_apply(
            planar, n, s1, w1,
            jnp.asarray(W1.real, jnp.float32), jnp.asarray(W1.imag, jnp.float32),
            pre_flips=flips)
        got = planar_window_apply(
            got, n, s2, w2,
            jnp.asarray(W2.real, jnp.float32), jnp.asarray(W2.imag, jnp.float32))
        # oracle: flips, then window 1, then window 2, dense einsum
        want = psi.copy()
        for m in flips:
            want[m] = -want[m]
        A, B = 2**s1, 2**n // (2**(s1 + w1 + w2))
        t = want.reshape(A, D1, D2 * B)
        t = np.einsum("ij,ajb->aib", W1, t)
        t = t.reshape(A * D1, D2, B)
        t = np.einsum("ij,ajb->aib", W2, t)
        return np.asarray(got), t.reshape(-1)

    def test_trailing_pair_b1(self):
        """Adjacent windows ending at the last qubit: B == 1."""
        got, want = self._run_pair(n=10, s1=2, w1=4, s2=6, w2=4, seed=7)
        np.testing.assert_allclose(from_planar(got), want, atol=1e-4)

    def test_trailing_pair_b1_with_flips(self):
        got, want = self._run_pair(n=10, s1=2, w1=4, s2=6, w2=4, seed=8,
                                   flips=(0, 513, 1023))
        np.testing.assert_allclose(from_planar(got), want, atol=1e-4)

    def test_middle_pair_bt(self):
        """Adjacent windows from qubit 0 with a trailing B >= 128."""
        got, want = self._run_pair(n=12, s1=0, w1=2, s2=2, w2=3, seed=9)
        np.testing.assert_allclose(from_planar(got), want, atol=1e-4)

    def test_middle_pair_bt_with_flips(self):
        got, want = self._run_pair(n=12, s1=0, w1=2, s2=2, w2=3, seed=10,
                                   flips=(5, 700, 4095))
        np.testing.assert_allclose(from_planar(got), want, atol=1e-4)

    def test_paired_plan_matches_unpaired(self):
        """End-to-end: a plan of adjacent windows (one pass each) on the
        step executor, the dot engine and the complex executor.

        Layers of distinct rotations (so the H·flip·H reflection pattern
        does NOT trigger and the windows stay windows)."""
        from qbot_tpu.tpu.compiler import FlipStep, WindowStep

        n = 10
        c = Circuit(n)
        c.phase_flip(123)
        for q in range(n):
            c.ry(q, 0.1 + 0.2 * q)
        c.phase_flip(17)
        for q in range(n):
            c.rx(q, 0.3 + 0.1 * q)
        plan = compile_circuit(c, window=4)
        wins = [s for s in plan.steps if isinstance(s, WindowStep)]
        assert any(a.start + a.width == b.start
                   for a, b in zip(wins, wins[1:]))
        assert plan.num_passes == sum(not isinstance(s, FlipStep)
                                      for s in plan.steps)
        got = apply_plan_planar(zero_state_planar(n), plan)
        plan.engine = "dot"
        want = apply_plan_planar(zero_state_planar(n), plan)
        plan.engine = "step"
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4)
        ref = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan))
        np.testing.assert_allclose(from_planar(np.asarray(got)), ref,
                                   atol=1e-4)


class TestPhaseFusion:
    """Cross-window controlled phases fuse into windows as pre-phases."""

    def _brickwork(self, n, layers=2, seed=5):
        rng = np.random.default_rng(seed)
        c = Circuit(n)
        for layer in range(layers):
            for q in range(n):
                z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                qm, r = np.linalg.qr(z)
                c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())),
                       [q])
            for q in range(layer % 2, n - 1, 2):
                c.cx(q, q + 1)
            c.gate(np.diag([1.0, np.exp(0.3j)]).astype(complex), [0],
                   controls=[n - 1])        # max-span controlled phase
        return c

    def test_no_standalone_diag_steps(self):
        from qbot_tpu.tpu.compiler import DiagStep, PhaseStep, compile_circuit

        plan = compile_circuit(self._brickwork(12), window=4)
        kinds = [type(s).__name__ for s in plan.steps]
        assert "DiagStep" not in kinds
        # every cross-window CZ/CPhase fused into a window's pre_phases
        from qbot_tpu.tpu.compiler import WindowStep
        fused = sum(len(s.pre_phases) for s in plan.steps
                    if isinstance(s, WindowStep))
        standalone = sum(isinstance(s, PhaseStep) for s in plan.steps)
        assert fused + standalone > 0
        assert fused > 0

    @pytest.mark.parametrize("n,window", [(10, 3), (11, 4), (12, 5)])
    def test_planar_kernels_match_simulator(self, n, window):
        """Fused phases through every window geometry of the step
        executor vs the complex oracle."""
        circ = self._brickwork(n)
        plan = compile_circuit(circ, window=window)
        psi0 = _rand_planar(n, seed=n)
        planar = jnp.asarray(np.stack([psi0.real, psi0.imag]),
                             dtype=jnp.float32)
        got = from_planar(np.asarray(apply_plan_planar(planar, plan)))
        want = np.asarray(apply_plan(jnp.asarray(psi0), plan))
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_xla_fallback_matches(self):
        """The same plan on the dot engine matches the complex oracle."""
        circ = self._brickwork(10)
        plan = compile_circuit(circ, window=3)
        plan.engine = "dot"
        psi0 = _rand_planar(10, seed=3)
        planar = jnp.asarray(np.stack([psi0.real, psi0.imag]),
                             dtype=jnp.float32)
        got = from_planar(np.asarray(apply_plan_planar(planar, plan)))
        want = np.asarray(apply_plan(jnp.asarray(psi0), plan))
        np.testing.assert_allclose(got, want, atol=2e-5)

    def test_density_expansion_matches(self):
        from qbot_tpu.tpu.planar import (
            apply_plan_density_planar,
            zero_density_planar,
        )
        from qbot_tpu.tpu.simulator import apply_plan_density

        n = 6
        circ = self._brickwork(n)
        plan = compile_circuit(circ, window=3)
        rho = np.asarray(apply_plan_density_planar(
            zero_density_planar(n), plan))
        got = rho[0] + 1j * rho[1]
        rho0 = jnp.zeros((2**n, 2**n), dtype=jnp.complex64)
        rho0 = rho0.at[0, 0].set(1.0)
        want = np.asarray(apply_plan_density(rho0, plan)).reshape(2**n, 2**n)
        np.testing.assert_allclose(got, want, atol=2e-5)
