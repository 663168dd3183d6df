"""Sharded planar executor (shard_map + all_to_all qubit resharding) vs the
unsharded planar path, on the host-emulated 8-device CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qbot_tpu.tpu.circuit import Circuit, grover_circuit, random_circuit
from qbot_tpu.tpu.compiler import compile_circuit
from qbot_tpu.tpu.planar import (
    apply_plan_planar,
    from_planar,
    planar_probs,
    zero_state_planar,
)
from qbot_tpu.tpu.sharded import (
    LocalSegment,
    Reshard,
    compile_sharded,
    make_sharded_planar_runner,
    sharded_probs_fn,
    sharded_zero_state,
    unpermute_planar,
)
from qbot_tpu.tpu.sharding import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 emulated devices")


def _mesh(K):
    return make_mesh((1, K), devices=jax.devices()[:K])


def _unsharded(circ, n):
    plan = compile_circuit(circ)
    return np.asarray(apply_plan_planar(zero_state_planar(n), plan))


def _sharded(circ, n, k, params=None):
    """Run sharded and restore logical qubit order for comparison."""
    mesh = _mesh(2**k)
    splan = compile_sharded(circ, k)
    run = make_sharded_planar_runner(splan, mesh)
    psi = run(sharded_zero_state(n, mesh), params)
    psi = unpermute_planar(np.asarray(psi), splan.final_perm)
    return np.asarray(psi), splan, mesh


class TestCompileSharded:
    def test_local_only_circuit_no_reshard(self):
        c = Circuit(8)
        for q in range(3, 8):
            c.h(q)
        splan = compile_sharded(c, k=3)
        assert splan.num_reshards == 0

    def test_gate_on_sharded_qubit_inserts_reshard(self):
        c = Circuit(8).h(0)
        splan = compile_sharded(c, k=3)
        assert splan.num_reshards == 1

    def test_reshard_count_batches_ops(self):
        # an H-layer over all qubits needs exactly one reshard
        c = Circuit(8)
        for q in range(8):
            c.h(q)
        splan = compile_sharded(c, k=3)
        assert splan.num_reshards == 1


class TestShardedExecution:
    def test_h_layer_matches_unsharded(self):
        n, k = 8, 3
        c = Circuit(n)
        for q in range(n):
            c.h(q)
        want = _unsharded(c, n)
        got, _, _ = _sharded(c, n, k)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_random_circuit_matches(self):
        n, k = 9, 3
        c = random_circuit(n, 3, seed=12)
        want = _unsharded(c, n)
        got, splan, _ = _sharded(c, n, k)
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert splan.num_reshards >= 1

    def test_grover_with_flips_matches(self):
        n, k = 8, 2
        c = grover_circuit(n, marked=37, iterations=12)
        want = _unsharded(c, n)
        got, _, _ = _sharded(c, n, k)
        np.testing.assert_allclose(got, want, atol=1e-4)
        # and the marked state is amplified
        p = got[0] ** 2 + got[1] ** 2
        assert p[37] > 0.5

    def test_param_circuit_matches(self):
        n, k = 8, 2
        c = Circuit(n)
        for q in range(n):
            c.pry(q, q)
        c.cx(0, 7)
        theta = np.linspace(0.1, 1.5, n).astype(np.float32)
        plan = compile_circuit(c)
        want = np.asarray(apply_plan_planar(zero_state_planar(n), plan,
                                            jnp.asarray(theta)))
        got, _, _ = _sharded(c, n, k, params=jnp.asarray(theta))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_qubit_identity_preserved_after_reshards(self):
        # X on one sharded qubit and one local qubit: exact basis state
        n, k = 8, 3
        c = Circuit(n).x(0).x(6)
        got, _, _ = _sharded(c, n, k)
        psi = from_planar(got)
        expect_index = (1 << (n - 1)) | (1 << (n - 1 - 6))
        assert np.argmax(np.abs(psi)) == expect_index


class TestShardedProbs:
    def test_full_distribution(self):
        n, k = 8, 3
        c = grover_circuit(n, marked=11, iterations=3)
        mesh = _mesh(2**k)
        splan = compile_sharded(c, k)
        run = make_sharded_planar_runner(splan, mesh)
        psi = run(sharded_zero_state(n, mesh))
        probs = np.asarray(sharded_probs_fn(splan, mesh)(psi))
        want = np.asarray(planar_probs(
            jnp.asarray(_unsharded(c, n)), n=n))
        np.testing.assert_allclose(probs, want, atol=1e-5)

    def test_marginal_mixing_sharded_and_local_targets(self):
        n, k = 8, 3
        c = Circuit(n)
        for q in range(n):
            c.h(q)
        c.cx(0, 7)
        mesh = _mesh(2**k)
        splan = compile_sharded(c, k)
        run = make_sharded_planar_runner(splan, mesh)
        psi = run(sharded_zero_state(n, mesh))
        # targets straddle the shard boundary (logical 0 is sharded at start)
        probs = np.asarray(sharded_probs_fn(splan, mesh, targets=[0, 7])(psi))
        want = np.asarray(planar_probs(jnp.asarray(_unsharded(c, n)),
                                       targets=[0, 7], n=n))
        np.testing.assert_allclose(probs, want, atol=1e-5)


class TestShardedLowering:
    def test_deutsch_sharded_matches_unsharded(self):
        from qbot_tpu.frontend.lowering import (
            lower_program,
            run_lowered,
            run_lowered_sharded,
        )

        src = """qset tensorExp(ketToDensity(np_array([1,0])), 5)
gate hadamardGate ; 0
gate hadamardGate ; 1
gate hadamardGate ; 2
gate pauliXGate ; 4
gate hadamardGate ; 4
gate simonsGate(3, lambda x: x % 2) ; 0
meas res ; computation ; [0,1,2]
"""
        lp = lower_program(src)
        want, _ = run_lowered(lp)
        got, _, splan = run_lowered_sharded(lp, k=2)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_nontrivial_initial_state_prep(self):
        from qbot_tpu.frontend.lowering import (
            lower_program,
            run_lowered,
            run_lowered_sharded,
        )

        # |+⟩⊗|1⟩⊗|0...⟩ initial product state exercises ket→unitary prep
        src = """qset tensorProd(ketToDensity(np_array([1,1])/np_sqrt(2)), ketToDensity(np_array([0,1])), tensorExp(ketToDensity(np_array([1,0])), 4))
gate pauliXGate ; 2 ; [1]
meas res ; computation ; [0,1,2]
"""
        lp = lower_program(src)
        want, _ = run_lowered(lp)
        got, _, _ = run_lowered_sharded(lp, k=3)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_hadamard_basis_measurement_sharded(self):
        from qbot_tpu.frontend.lowering import (
            lower_program,
            run_lowered,
            run_lowered_sharded,
        )

        src = """qset tensorExp(ketToDensity(np_array([1,0])), 6)
gate hadamardGate ; 3
meas res ; hadamard ; [3,4]
"""
        lp = lower_program(src)
        want, _ = run_lowered(lp)
        got, _, _ = run_lowered_sharded(lp, k=2)
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestShardedDiag:
    def test_mcz_over_all_qubits_no_reshard(self):
        from qbot_tpu.tpu.sharded import ShardedDiag

        # multi-controlled-Z over EVERY qubit: diagonal, so shardable with
        # zero communication (previously unshardeable: global support)
        n, k = 8, 3
        import qbot_tpu.ops.gates as g

        c = Circuit(n)
        for q in range(n):
            c.h(q)
        c.gate(g.pauli_z(), [n - 1], list(range(n - 1)))
        for q in range(n):
            c.h(q)
        splan = compile_sharded(c, k)
        assert any(isinstance(i, ShardedDiag) for i in splan.items)
        want = _unsharded(c, n)
        got, _, _ = _sharded(c, n, k)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_phase_diag_on_sharded_and_local_qubits(self):
        n, k = 8, 3
        c = Circuit(n)
        for q in range(n):
            c.h(q)
        # diagonal over qubits straddling the shard boundary, unsorted
        c.diagonal(np.exp(1j * np.linspace(0.3, 2.1, 8)), [5, 1, 6])
        c.gate(np.diag([1, 1j]).astype(complex), [2])     # S gate, sharded
        want = _unsharded(c, n)
        got, splan, _ = _sharded(c, n, k)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_diag_normalization_in_compiler(self):
        from qbot_tpu.tpu.compiler import ContractStep, gate_as_diag

        import qbot_tpu.ops.gates as g

        # cross-window controlled-Z compiles to a DiagStep, not a big
        # block-diag contraction
        c = Circuit(10).h(0).cz(0, 9)
        plan = compile_circuit(c, window=7)
        kinds = [type(s).__name__ for s in plan.steps]
        assert "ContractStep" not in kinds
        # non-diagonal gates are untouched
        assert gate_as_diag(c.ops[0]) is None


class TestTrafficAccounting:
    def test_plan_hbm_bytes(self):
        c = Circuit(10)
        for q in range(10):
            c.h(q)
        plan = compile_circuit(c, window=7)       # two window passes
        assert plan.hbm_bytes() == 2 * 2 * 1024 * 4 * plan.num_passes

    def test_sharded_comm_bytes(self):
        c = Circuit(8)
        for q in range(8):
            c.h(q)
        splan = compile_sharded(c, k=3)
        # one reshard, 7/8 of the planar state crosses the links
        assert splan.num_reshards == 1
        assert splan.comm_bytes() == 2 * 256 * 4 * 7 // 8
        assert splan.hbm_bytes() > 0


class TestShardedReflect:
    def test_grover_body_zero_reshards(self):
        from qbot_tpu.tpu.sharded import ShardedReflect

        n, k = 8, 3
        c = grover_circuit(n, marked=37, iterations=12)
        splan = compile_sharded(c, k)
        # the init H-layer needs one reshard; every diffusion sandwich
        # becomes a ShardedReflect, so the 12-iteration body needs NONE
        assert sum(isinstance(i, ShardedReflect) for i in splan.items) == 12
        assert splan.num_reshards <= 1
        want = _unsharded(c, n)
        got, _, _ = _sharded(c, n, k)
        np.testing.assert_allclose(got, want, atol=1e-4)
        p = got[0] ** 2 + got[1] ** 2
        assert p[37] > 0.97

    def test_reflect_with_nonzero_flip_and_rotations(self):
        from qbot_tpu.tpu.circuit import Circuit

        n, k = 8, 2
        c = Circuit(n)
        for q in range(n):
            c.ry(q, 0.3 + 0.1 * q)
        c.phase_flip(173)
        for q in range(n):
            c.ry(q, -(0.3 + 0.1 * q))    # Ry(-t) = Ry(t)^{-1}
        want = _unsharded(c, n)
        got, splan, _ = _sharded(c, n, k)
        from qbot_tpu.tpu.sharded import ShardedReflect
        assert any(isinstance(i, ShardedReflect) for i in splan.items)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_non_inverse_layers_still_reshard(self):
        from qbot_tpu.tpu.circuit import Circuit
        from qbot_tpu.tpu.sharded import ShardedReflect

        n, k = 8, 2
        c = Circuit(n)
        for q in range(n):
            c.h(q)
        c.phase_flip(5)
        for q in range(n):
            c.x(q)                       # X != H^{-1}: no reflection
        splan = compile_sharded(c, k)
        assert not any(isinstance(i, ShardedReflect) for i in splan.items)
        want = _unsharded(c, n)
        got, _, _ = _sharded(c, n, k)
        np.testing.assert_allclose(got, want, atol=1e-4)
