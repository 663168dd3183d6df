"""Device-path tests: window-fusion compiler + jitted executors vs the numpy
oracle engine (the framework's own cross-validation pattern, SURVEY §4).

Runs on CPU-jax under the test env (conftest sets JAX_PLATFORMS=cpu); the
same code path runs unchanged on the GPU.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from qbot_tpu.ops import core, gates
from qbot_tpu.tpu.circuit import (
    Circuit,
    grover_circuit,
    parameterized_layers,
    qft_circuit,
    random_circuit,
)
from qbot_tpu.tpu.compiler import DiagStep, WindowStep, compile_circuit
from qbot_tpu.tpu.simulator import (
    apply_plan,
    computation_probs,
    expectation_z,
    make_density_runner,
    make_scanned_runner,
    make_statevector_runner,
    zero_state,
)


def oracle_statevector(circ: Circuit) -> np.ndarray:
    """Reference path: apply ops one by one with the numpy engine."""
    psi = np.zeros(2**circ.n, dtype=complex)
    psi[0] = 1
    for op in circ.ops:
        if op.kind == "flip":
            psi = psi.copy()
            psi[op.index] *= -1
            continue
        if op.kind == "diag":
            t = psi.reshape((2,) * circ.n)
            k = len(op.targets)
            d = op.matrix.reshape((2,) * k)
            d = np.moveaxis(d.reshape((2,) * k + (1,) * (circ.n - k)),
                            range(k), op.targets)
            psi = (t * d).reshape(-1)
        else:
            m = op.matrix
            if m is None:
                raise ValueError("param circuit needs explicit params")
            if op.controls:
                m = gates.controlled(m, len(op.controls))
            psi = core.apply_gate_state(psi, m,
                                        list(op.controls) + list(op.targets))
    return psi


class TestCompiler:
    def test_single_window_fuses_layer(self):
        c = Circuit(4)
        for q in range(4):
            c.h(q)
        plan = compile_circuit(c, window=7)
        assert plan.num_passes == 1
        assert isinstance(plan.steps[0], WindowStep)

    def test_two_windows_pair_fused(self):
        c = Circuit(10)
        for q in range(10):
            c.h(q)
        # the H-layer folds into two adjacent windows, one pass each
        plan = compile_circuit(c, window=7)
        assert plan.num_passes == 2
        assert [type(s) for s in plan.steps] == [WindowStep, WindowStep]
        a, b = plan.steps
        assert (a.start, a.width, b.start, b.width) == (0, 3, 3, 7)

    def test_cross_window_controlled_gate_becomes_phase(self):
        # controlled gates never contract across windows: CX rewrites to
        # H · controlled-Z · H, and the controlled-Z fuses into a window
        # kernel as a pre-phase factor (zero extra HBM passes)
        c = Circuit(10).h(0).cx(0, 9)
        plan = compile_circuit(c, window=7)
        kinds = [type(s).__name__ for s in plan.steps]
        assert "ContractStep" not in kinds
        assert "DiagStep" not in kinds
        from qbot_tpu.tpu.compiler import PhaseStep, WindowStep
        fused = sum(len(s.pre_phases) for s in plan.steps
                    if isinstance(s, WindowStep))
        standalone = sum(isinstance(s, PhaseStep) for s in plan.steps)
        assert fused + standalone >= 1

    def test_cross_window_generic_gate_falls_back(self):
        # a generic (non-controlled, non-swap) 2q unitary across windows
        # still needs the contraction path
        rng = np.random.default_rng(0)
        m = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
        q, _ = np.linalg.qr(m)
        c = Circuit(10).gate(q, [0, 9])
        plan = compile_circuit(c, window=7)
        kinds = [type(s).__name__ for s in plan.steps]
        assert "ContractStep" in kinds

    def test_cross_window_swap_decomposes(self):
        c = Circuit(10)
        for q in range(10):
            c.h(q)
        c.swap(0, 9)
        plan = compile_circuit(c, window=7)
        kinds = [type(s).__name__ for s in plan.steps]
        assert "ContractStep" not in kinds

    def test_phase_flip_costs_zero_passes(self):
        c = Circuit(10)
        c.phase_flip(3)
        plan = compile_circuit(c, window=7)
        # a FlipStep is an in-place single-element scatter: zero HBM passes
        assert plan.num_passes == 0
        from qbot_tpu.tpu.compiler import FlipStep
        assert isinstance(plan.steps[0], FlipStep)

    def test_grover_pass_count_scales_with_windows(self):
        n, iters = 14, 3
        c = grover_circuit(n, marked=5, iterations=iters)
        plan = compile_circuit(c, window=7)
        # per iteration: 2 diag passes + 2×(n/7) fused window passes (+init)
        assert plan.num_passes < c.gate_count / 3


class TestExecutorVsOracle:
    @pytest.mark.parametrize("n,depth,seed", [(3, 2, 0), (6, 3, 1), (9, 2, 2)])
    def test_random_circuits(self, n, depth, seed):
        c = random_circuit(n, depth, seed)
        plan = compile_circuit(c)
        psi = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan))
        np.testing.assert_allclose(psi, oracle_statevector(c), atol=1e-10)

    def test_qft_matches_dense_matrix(self):
        n = 5
        c = qft_circuit(n)
        plan = compile_circuit(c)
        psi0 = np.zeros(2**n, dtype=complex)
        psi0[13] = 1
        got = np.asarray(apply_plan(jnp.asarray(psi0), plan))
        want = gates.qft(n) @ psi0
        np.testing.assert_allclose(got, want, atol=1e-10)

    def test_grover_finds_marked(self):
        n = 8
        c = grover_circuit(n, marked=177)
        run = make_statevector_runner(compile_circuit(c))
        probs = computation_probs(run(zero_state(n)), n=n)
        assert int(np.argmax(probs)) == 177
        assert probs[177] > 0.99

    def test_scanned_grover_equals_unrolled(self):
        n, iters = 6, 3
        init = Circuit(n)
        for q in range(n):
            init.h(q)
        body = Circuit(n)
        body.phase_flip(9)
        for q in range(n):
            body.h(q)
        body.phase_flip(0)
        for q in range(n):
            body.h(q)
        scan_run = make_scanned_runner(compile_circuit(body), iters,
                                       init_plan=compile_circuit(init))
        unrolled = grover_circuit(n, marked=9, iterations=iters)
        want = np.asarray(apply_plan(zero_state(n, jnp.complex128),
                                     compile_circuit(unrolled)))
        got = np.asarray(scan_run(zero_state(n, jnp.complex128)))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_controlled_cross_window(self):
        c = Circuit(9).x(0).cx(0, 8)
        plan = compile_circuit(c, window=7)
        psi = np.asarray(apply_plan(zero_state(9, jnp.complex128), plan))
        np.testing.assert_allclose(psi, oracle_statevector(c), atol=1e-12)

    def test_param_circuit(self):
        n, depth = 4, 2
        c = parameterized_layers(n, depth)
        plan = compile_circuit(c)
        theta = np.linspace(0.1, 1.5, c.num_params)
        got = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan,
                                    jnp.asarray(theta)))
        # oracle: substitute concrete matrices
        oracle = Circuit(n)
        k = 0
        for layer in range(depth):
            for q in range(n):
                oracle.ry(q, theta[k])
                k += 1
            for q in range(layer % 2, n - 1, 2):
                oracle.cx(q, q + 1)
        np.testing.assert_allclose(got, oracle_statevector(oracle), atol=1e-6)

    def test_density_runner_matches_pure(self):
        n = 4
        c = random_circuit(n, 2, seed=3)
        plan = compile_circuit(c)
        psi = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan))
        rho0 = jnp.zeros((2**n, 2**n), dtype=jnp.complex128)
        rho0 = rho0.at[0, 0].set(1.0)
        rho = np.asarray(make_density_runner(plan)(rho0))
        np.testing.assert_allclose(rho, np.outer(psi, psi.conj()), atol=1e-10)


class TestReadout:
    def test_probs_full(self):
        psi = zero_state(3)
        p = np.asarray(computation_probs(psi, n=3))
        np.testing.assert_allclose(p, [1, 0, 0, 0, 0, 0, 0, 0], atol=1e-6)

    def test_probs_marginal(self):
        c = Circuit(3).h(0)
        psi = apply_plan(zero_state(3), compile_circuit(c))
        p = np.asarray(computation_probs(psi, targets=[0], n=3))
        np.testing.assert_allclose(p, [0.5, 0.5], atol=1e-6)

    def test_expectation_z(self):
        c = Circuit(2).x(1)
        psi = apply_plan(zero_state(2), compile_circuit(c))
        assert np.asarray(expectation_z(psi, 0, n=2)) == pytest.approx(1.0)
        assert np.asarray(expectation_z(psi, 1, n=2)) == pytest.approx(-1.0)


class TestAutoWindow:
    def test_auto_picks_modeled_best_and_matches(self):
        import jax.numpy as jnp

        from qbot_tpu.tpu.compiler import compile_circuit, plan_cost_model
        from qbot_tpu.tpu.planar import (
            apply_plan_planar,
            planar_probs,
            zero_state_planar,
        )
        from qbot_tpu.tpu.circuit import Circuit

        rng = np.random.default_rng(7)
        n = 9
        c = Circuit(n)
        X = np.array([[0, 1], [1, 0]], dtype=complex)
        for layer in range(2):
            for q in range(n):
                z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                qm, r = np.linalg.qr(z)
                c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())),
                       [q])
            for q in range(layer % 2, n - 1, 2):
                c.gate(X, [q + 1], controls=[q])

        auto = compile_circuit(c, window="auto")
        # mirror the auto search EXACTLY (ADVICE r3): same widths, same
        # per-engine partitions, via the search's own candidate list
        from qbot_tpu.tpu.compiler import auto_candidates, dot_cost_model
        costs = [cost for cost, _, _ in auto_candidates(c)]
        chosen_model = (dot_cost_model if auto.engine == "dot"
                        else plan_cost_model)
        assert np.isclose(chosen_model(auto), min(costs))
        # numerics identical to the fixed-window plan
        psi_a = apply_plan_planar(zero_state_planar(n), auto)
        psi_7 = apply_plan_planar(zero_state_planar(n),
                                  compile_circuit(c, 7))
        np.testing.assert_allclose(
            np.asarray(planar_probs(psi_a, None, n)),
            np.asarray(planar_probs(psi_7, None, n)), atol=1e-5)
