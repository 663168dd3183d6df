"""Planar (real/imag float) executor vs the complex executor.

The device path stores states planar; this cross-checks that the planar
float path is numerically identical to the complex path on every step kind.
"""
import numpy as np

import jax.numpy as jnp

from qbot_tpu.tpu.circuit import Circuit, grover_circuit, parameterized_layers, random_circuit
from qbot_tpu.tpu.compiler import compile_circuit
from qbot_tpu.tpu.planar import (
    apply_plan_planar,
    from_planar,
    make_scanned_planar_runner,
    planar_norm,
    planar_probs,
    to_planar,
    zero_state_planar,
)
from qbot_tpu.tpu.simulator import apply_plan, zero_state


def planar_vs_complex(circ, params=None, atol=1e-5):
    plan = compile_circuit(circ)
    want = np.asarray(apply_plan(zero_state(circ.n, jnp.complex128), plan,
                                 params))
    got_planar = apply_plan_planar(
        zero_state_planar(circ.n, jnp.float64), plan, params)
    np.testing.assert_allclose(from_planar(np.asarray(got_planar)), want,
                               atol=atol)


def test_random_circuit():
    planar_vs_complex(random_circuit(6, 3, seed=4), atol=1e-10)


def test_cross_window_and_diag():
    c = Circuit(9)
    for q in range(9):
        c.h(q)
    c.cx(0, 8)
    c.phase_flip(100)
    c.s(3)
    planar_vs_complex(c, atol=1e-10)


def test_param_circuit():
    c = parameterized_layers(5, 2)
    theta = jnp.linspace(0.2, 1.2, c.num_params, dtype=jnp.float64)
    planar_vs_complex(c, theta, atol=1e-10)


def test_grover_planar_finds_marked():
    n = 8
    c = grover_circuit(n, marked=201)
    run = make_scanned_planar_runner(compile_circuit(c), 1)
    psi = run(zero_state_planar(n))
    probs = np.asarray(planar_probs(psi, n=n))
    assert int(np.argmax(probs)) == 201


def test_norm_preserved():
    c = random_circuit(7, 4, seed=5)
    psi = apply_plan_planar(zero_state_planar(7, jnp.float64),
                            compile_circuit(c))
    assert abs(float(planar_norm(psi)) - 1.0) < 1e-8


def test_to_from_planar_roundtrip():
    rng = np.random.default_rng(0)
    psi = rng.normal(size=8) + 1j * rng.normal(size=8)
    np.testing.assert_allclose(from_planar(to_planar(psi, np.float64)), psi)


class TestPlanarDensity:
    """Planar density executor (the device mixed-state path) vs the
    complex-dtype density executor."""

    def _check(self, circ, atol=1e-4, params=None, window=7):
        import jax.numpy as jnp

        from qbot_tpu.tpu.compiler import compile_circuit
        from qbot_tpu.tpu.planar import (
            apply_plan_density_planar,
            zero_density_planar,
        )
        from qbot_tpu.tpu.simulator import apply_plan_density

        plan = compile_circuit(circ, window=window)
        n = circ.n
        rho0 = np.zeros((2**n, 2**n), dtype=np.complex128)
        rho0[0, 0] = 1.0
        want = np.asarray(apply_plan_density(
            jnp.asarray(rho0), plan,
            None if params is None else jnp.asarray(params)))
        got = np.asarray(apply_plan_density_planar(
            zero_density_planar(n), plan,
            None if params is None else jnp.asarray(params, jnp.float32)))
        np.testing.assert_allclose(got[0] + 1j * got[1], want, atol=atol)
        return got

    def test_bell_density(self):
        from qbot_tpu.tpu.circuit import Circuit

        c = Circuit(2)
        c.h(0)
        c.cx(0, 1)
        got = self._check(c)
        # diag of bell state: [0.5, 0, 0, 0.5]
        np.testing.assert_allclose(np.diag(got[0]), [0.5, 0, 0, 0.5],
                                   atol=1e-6)

    def test_random_circuit_density(self):
        from qbot_tpu.tpu.circuit import random_circuit

        self._check(random_circuit(5, 3, seed=11), window=3)

    def test_flips_and_diag_density(self):
        from qbot_tpu.tpu.circuit import Circuit

        c = Circuit(4)
        for q in range(4):
            c.h(q)
        c.phase_flip(9)
        for q in range(4):
            c.h(q)
        c.diagonal(np.exp(1j * np.linspace(0, 1, 4)), [1, 3])
        self._check(c, window=2)

    def test_param_circuit_density(self):
        from qbot_tpu.tpu.circuit import Circuit

        c = Circuit(3)
        c.pry(0)
        c.prx(1)
        c.cx(0, 2)
        c.prz(2)
        self._check(c, params=[0.3, 1.1, -0.7])

    def test_density_probs(self):
        import jax.numpy as jnp

        from qbot_tpu.tpu.circuit import Circuit
        from qbot_tpu.tpu.compiler import compile_circuit
        from qbot_tpu.tpu.planar import (
            apply_plan_density_planar,
            planar_density_probs,
            zero_density_planar,
        )

        c = Circuit(3)
        c.h(0)
        c.cx(0, 1)
        rho = apply_plan_density_planar(zero_density_planar(3),
                                        compile_circuit(c))
        p = np.asarray(planar_density_probs(rho, targets=[0, 1]))
        np.testing.assert_allclose(p, [0.5, 0, 0, 0.5], atol=1e-6)
        p0 = np.asarray(planar_density_probs(rho, targets=[2]))
        np.testing.assert_allclose(p0, [1.0, 0.0], atol=1e-6)
