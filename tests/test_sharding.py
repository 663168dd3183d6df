"""Multi-chip sharding tests on the host-emulated 8-device CPU mesh.

Validates that plans execute correctly when the amplitude tensor is sharded
over the ``qubits`` mesh axis and ensembles over ``particles`` (GSPMD
inserts the collectives for window steps touching sharded major qubits).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from qbot_tpu.tpu.circuit import Circuit, grover_circuit, random_circuit
from qbot_tpu.tpu.compiler import compile_circuit
from qbot_tpu.tpu.sharding import (
    batched_state_sharding,
    make_mesh,
    make_sharded_runner,
    shard_state,
    state_sharding,
)
from qbot_tpu.tpu.simulator import apply_plan, zero_state

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 emulated devices")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 8))


@pytest.fixture(scope="module")
def mesh2x4():
    return make_mesh((2, 4))


class TestShardedExecution:
    def test_sharded_matches_unsharded(self, mesh):
        n = 10
        c = random_circuit(n, 3, seed=7)
        plan = compile_circuit(c)
        want = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan))

        psi0 = shard_state(zero_state(n, jnp.complex128), mesh)
        run = make_sharded_runner(plan, mesh)
        got = run(psi0, None)
        assert len(got.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-10)

    def test_sharded_grover(self, mesh):
        n = 12
        c = grover_circuit(n, marked=999, iterations=20)
        plan = compile_circuit(c)
        run = make_sharded_runner(plan, mesh)
        got = run(shard_state(zero_state(n), mesh), None)
        probs = np.abs(np.asarray(got)) ** 2
        assert int(np.argmax(probs)) == 999

    def test_gate_on_sharded_major_qubit(self, mesh):
        """A gate on qubit 0 (fully sharded axis) forces collectives."""
        n = 9
        c = Circuit(n).h(0).cx(0, 8).h(0)
        plan = compile_circuit(c)
        want = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan))
        run = make_sharded_runner(plan, mesh)
        got = run(shard_state(zero_state(n, jnp.complex128), mesh), None)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-10)

    def test_batched_particles_axis(self, mesh2x4):
        """(particles, amplitudes) ensemble on a 2×4 mesh."""
        n, batch = 8, 4
        c = random_circuit(n, 2, seed=8)
        plan = compile_circuit(c)
        want = np.asarray(apply_plan(zero_state(n, jnp.complex128), plan))

        psi0 = jnp.tile(zero_state(n, jnp.complex128)[None, :], (batch, 1))
        psi0 = jax.device_put(psi0, batched_state_sharding(mesh2x4))
        run = make_sharded_runner(plan, mesh2x4, batched=True)
        got = np.asarray(run(psi0, None))
        for b in range(batch):
            np.testing.assert_allclose(got[b], want, atol=1e-10)


class TestMeshConstruction:
    def test_default_mesh_all_qubits(self):
        m = make_mesh()
        assert m.devices.size == 8
        assert m.axis_names == ("particles", "qubits")

    def test_bad_shape_raises(self):
        with pytest.raises(ValueError):
            make_mesh((3, 3))

    def test_state_sharding_spec(self, mesh):
        s = state_sharding(mesh)
        assert isinstance(s, NamedSharding)


class TestCollectives:
    def test_psum_weight_normalization(self, mesh):
        """SMC weight normalisation as a psum over the particle axis."""
        # version-guarded import (jax.shard_map on new jax, the
        # experimental module on old)
        try:
            from jax import shard_map
        except ImportError:          # pragma: no cover - older jax
            from jax.experimental.shard_map import shard_map

        lw = jnp.log(jnp.arange(1.0, 9.0))
        spec = P(("particles", "qubits"))

        def body(local_lw):
            local_sum = jnp.sum(jnp.exp(local_lw))
            total = jax.lax.psum(local_sum, ("particles", "qubits"))
            return jnp.exp(local_lw) / total

        f = shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
        w = np.asarray(f(lw))
        np.testing.assert_allclose(w, np.arange(1.0, 9.0) / 36.0, atol=1e-6)
