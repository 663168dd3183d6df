"""SMC particle ensemble and HMC inference tests."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qbot_tpu.inference import hmc, smc
from qbot_tpu.probval import ProbVal
from qbot_tpu.tpu.circuit import parameterized_layers
from qbot_tpu.tpu.compiler import compile_circuit
from qbot_tpu.tpu.simulator import apply_plan, computation_probs, zero_state


class TestEnsemble:
    def test_from_probs_and_weights(self):
        e = smc.from_probs([0.25, 0.75], jnp.array([1.0, 2.0]))
        np.testing.assert_allclose(np.asarray(e.weights()), [0.25, 0.75],
                                   atol=1e-6)

    def test_normalize_logsumexp(self):
        lw = jnp.array([0.0, 0.0, -jnp.inf, -jnp.inf])
        w = np.exp(np.asarray(smc.normalize(lw)))
        np.testing.assert_allclose(w[:2], [0.5, 0.5], atol=1e-6)

    def test_effective_sample_size(self):
        uniform = smc.from_probs([0.25] * 4, jnp.arange(4.0))
        assert float(smc.effective_sample_size(uniform.log_weights)) == \
            pytest.approx(4.0, rel=1e-4)
        degenerate = smc.from_probs([1 - 3e-9, 1e-9, 1e-9, 1e-9],
                                    jnp.arange(4.0))
        assert float(smc.effective_sample_size(degenerate.log_weights)) == \
            pytest.approx(1.0, rel=1e-3)

    def test_systematic_resample_preserves_mean(self):
        key = jax.random.PRNGKey(0)
        vals = jnp.array([0.0, 1.0, 2.0, 3.0])
        e = smc.from_probs([0.1, 0.2, 0.3, 0.4], vals)
        r = smc.systematic_resample(key, e)
        # resampled ensemble is uniform-weighted
        np.testing.assert_allclose(np.asarray(r.weights()), [0.25] * 4,
                                   atol=1e-6)
        got_mean = float(jnp.mean(r.values))
        want_mean = float(jnp.sum(e.weights() * vals))
        assert abs(got_mean - want_mean) < 0.8  # single-draw variance bound

    def test_resample_if_needed_skips_uniform(self):
        key = jax.random.PRNGKey(1)
        e = smc.from_probs([0.25] * 4, jnp.arange(4.0))
        r = smc.resample_if_needed(key, e)
        np.testing.assert_allclose(np.asarray(r.values),
                                   np.asarray(e.values))

    def test_branch_fanout(self):
        e = smc.from_probs([0.5, 0.5], jnp.array([0.0, 1.0]))
        blp = jnp.log(jnp.array([[0.5, 0.5], [0.9, 0.1]]))
        bvals = jnp.array([[10.0, 11.0], [20.0, 21.0]])
        out = smc.branch(e, blp, bvals)
        assert out.num_particles == 4
        w = np.asarray(out.weights())
        np.testing.assert_allclose(w, [0.25, 0.25, 0.45, 0.05], atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.values), [10, 11, 20, 21])

    def test_lift_vmap(self):
        e = smc.from_probs([0.5, 0.5], jnp.array([1.0, 2.0]))
        out = smc.lift_vmap(lambda v: v * 10, e)
        np.testing.assert_allclose(np.asarray(out.values), [10.0, 20.0])

    def test_mix_to_density(self):
        kets = jnp.array([[1, 0], [0, 1]], dtype=jnp.complex128)
        e = smc.from_probs([0.25, 0.75], kets)
        rho = np.asarray(smc.mix_to_density(e, kets))
        np.testing.assert_allclose(rho, np.diag([0.25, 0.75]), atol=1e-8)

    def test_to_probval_roundtrip(self):
        e = smc.from_probs([0.25, 0.75], jnp.array([1.0, 2.0]))
        pv = smc.to_probval(e)
        assert isinstance(pv, ProbVal)
        assert pv.is_equivalent(ProbVal([0.25, 0.75], [1.0, 2.0]))


class TestHMC:
    def setup_method(self):
        # posterior over a single rotation angle given measurement counts:
        # circuit = Ry(θ)|0⟩, observed mostly |1⟩ → θ near π
        self.circ = parameterized_layers(1, 1)
        self.plan = compile_circuit(self.circ)
        counts = np.array([5.0, 95.0])
        self.log_prob = hmc.make_circuit_log_prob(
            self.plan, counts, dtype=jnp.complex128)

    def test_log_prob_peak(self):
        lp_pi = float(self.log_prob(jnp.array([np.pi])))
        lp_0 = float(self.log_prob(jnp.array([0.1])))
        assert lp_pi > lp_0

    def test_gradient_flows(self):
        g = jax.grad(self.log_prob)(jnp.array([1.0]))
        assert np.isfinite(float(g[0])) and abs(float(g[0])) > 0

    def test_hmc_converges_to_posterior(self):
        qs, lps = jax.jit(
            lambda k, t0: hmc.run_hmc(k, self.log_prob, t0, 200,
                                      step_size=0.05, num_leapfrog=8)
        )(jax.random.PRNGKey(2), jnp.array([1.0]))
        samples = np.asarray(qs)[100:, 0]
        # Ry(θ)|0⟩ has P(|1⟩)=sin²(θ/2)=0.95 → θ ≈ π±0.45; accept either sign
        assert abs(abs(np.median(samples)) % (2 * np.pi) - np.pi) < 0.6

    def test_multi_chain(self):
        theta0 = jnp.array([[0.5], [1.5]])
        qs, lps = hmc.run_hmc_chains(jax.random.PRNGKey(3), self.log_prob,
                                     theta0, 10, step_size=0.05)
        assert qs.shape == (2, 10, 1)

    def test_dual_averaging_warmup(self):
        eps, state = jax.jit(
            lambda k, t0: hmc.dual_averaging_warmup(k, self.log_prob, t0,
                                                    num_warmup=50)
        )(jax.random.PRNGKey(4), jnp.array([1.0]))
        assert 1e-4 < float(eps) < 10.0
        assert np.isfinite(float(state.log_prob))


class TestPlanarLogProb:
    """Device HMC path: planar log-prob + gradients through the planar
    executors (JAX's own differentiation rules) vs the complex oracle."""

    def _setup(self):
        import jax.numpy as jnp

        from qbot_tpu.inference.hmc import (
            make_circuit_log_prob,
            make_circuit_log_prob_planar,
        )
        from qbot_tpu.tpu.circuit import parameterized_layers
        from qbot_tpu.tpu.compiler import compile_circuit

        from qbot_tpu.tpu.compiler import WindowStep

        # default plan: the gradient flows through adjacent window passes
        circ = parameterized_layers(8, 2)
        plan = compile_circuit(circ, window=4)
        wins = [s for s in plan.steps if isinstance(s, WindowStep)]
        assert any(a.start + a.width == b.start
                   for a, b in zip(wins, wins[1:]))
        counts = jnp.zeros(2**8).at[0].set(40.0).at[3].set(24.0)
        lp_c = make_circuit_log_prob(plan, counts)
        lp_p = make_circuit_log_prob_planar(plan, counts)
        theta = jnp.linspace(0.2, 1.4, circ.num_params)
        return lp_c, lp_p, theta

    def test_value_matches_complex(self):
        lp_c, lp_p, theta = self._setup()
        np.testing.assert_allclose(float(lp_p(theta)), float(lp_c(theta)),
                                   rtol=1e-4)

    def test_grad_matches_complex(self):
        import jax

        lp_c, lp_p, theta = self._setup()
        gc = np.asarray(jax.grad(lp_c)(theta))
        gp = np.asarray(jax.grad(lp_p)(theta))
        np.testing.assert_allclose(gp, gc, rtol=2e-3, atol=1e-3)

    def test_grad_through_pallas_kernels(self):
        """The same gradient through the dot engine's in-place windows."""
        import jax
        import jax.numpy as jnp

        from qbot_tpu.inference.hmc import (
            make_circuit_log_prob,
            make_circuit_log_prob_planar,
        )
        from qbot_tpu.tpu.circuit import parameterized_layers
        from qbot_tpu.tpu.compiler import compile_circuit

        circ = parameterized_layers(8, 2)
        plan = compile_circuit(circ, window=4)
        plan.engine = "dot"
        counts = jnp.zeros(2**8).at[0].set(40.0).at[3].set(24.0)
        theta = jnp.linspace(0.2, 1.4, circ.num_params)
        gp = np.asarray(jax.grad(make_circuit_log_prob_planar(
            plan, counts))(theta))
        gc = np.asarray(jax.grad(make_circuit_log_prob(plan, counts))(theta))
        np.testing.assert_allclose(gp, gc, rtol=2e-3, atol=1e-3)

    def test_grad_through_reflect_step(self):
        """Gradients flow through a ReflectStep (Grover-in-the-loss): the
        reflect custom VJP applies R† = F(I − 2vv†) to the cotangent."""
        import jax
        import jax.numpy as jnp

        from qbot_tpu.inference.hmc import (
            make_circuit_log_prob,
            make_circuit_log_prob_planar,
        )
        from qbot_tpu.tpu.circuit import Circuit
        from qbot_tpu.tpu.compiler import ReflectStep, compile_circuit

        H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
        n = 6
        c = Circuit(n)
        for q in range(n):
            c.pry(q, q)
        for q in range(n):          # prep layer (fuses with the rotations)
            c.gate(H, [q])
        c.phase_flip(3)              # oracle
        for q in range(n):          # diffusion: H^n · flip(0) · H^n
            c.gate(H, [q])
        c.phase_flip(0)
        for q in range(n):
            c.gate(H, [q])
        plan = compile_circuit(c, window=3)
        assert any(isinstance(s, ReflectStep) for s in plan.steps)
        counts = jnp.zeros(2**n).at[0].set(10.0).at[5].set(6.0)
        theta = jnp.linspace(0.3, 1.1, n)
        gc = np.asarray(jax.grad(make_circuit_log_prob(plan, counts))(theta))
        gp = np.asarray(
            jax.grad(make_circuit_log_prob_planar(plan, counts))(theta))
        np.testing.assert_allclose(gp, gc, rtol=2e-3, atol=1e-3)

    def test_hmc_chain_runs_planar(self):
        import jax
        import jax.numpy as jnp

        from qbot_tpu.inference.hmc import run_hmc_chains

        _, lp_p, theta = self._setup()
        theta0 = jnp.stack([theta, theta + 0.1])
        qs, lps = run_hmc_chains(jax.random.PRNGKey(0), lp_p, theta0, 4,
                                 step_size=0.05, num_leapfrog=3)
        assert qs.shape == (2, 4, theta.shape[0])
        assert np.isfinite(np.asarray(lps)).all()
