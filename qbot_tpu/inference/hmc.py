"""HMC / NUTS over continuous gate parameters.

The continuous-inference layer (BASELINE config 5): gate angles are leaf
parameters of a jitted log-probability ``θ → log p(observed | circuit(θ))``
built from a compiled parameterised circuit plan; leapfrog integration is
vectorised over chains with ``vmap``, and chains ride the ``particles``
mesh axis next to SMC particles.

No analogue exists in the reference (it has no sampling at all,
README.md:50); PRNG is threaded `jax.random` keys so the deterministic
ProbVal semantics remain untouched.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from qbot_tpu.tpu.compiler import Plan
from qbot_tpu.tpu.simulator import apply_plan, computation_probs, zero_state

__all__ = ["make_circuit_log_prob", "make_circuit_log_prob_planar",
           "HMCState", "hmc_init", "hmc_step", "run_hmc", "run_hmc_chains",
           "dual_averaging_warmup"]


def make_circuit_log_prob(plan: Plan, observed_counts, targets=None,
                          prior_sigma: float = 10.0,
                          dtype=jnp.complex64) -> Callable:
    """Posterior log-density over gate angles given measurement counts.

    ``observed_counts``: (K,) counts over computation-basis outcomes of
    ``targets`` (all qubits if None).  Likelihood = multinomial; prior =
    isotropic normal on angles.
    """
    counts = jnp.asarray(observed_counts)

    def log_prob(theta):
        psi = apply_plan(zero_state(plan.n, dtype), plan, theta)
        p = computation_probs(psi, targets=targets, n=plan.n)
        p = jnp.clip(p, 1e-12, 1.0)
        loglik = jnp.sum(counts * jnp.log(p))
        logprior = -0.5 * jnp.sum((theta / prior_sigma) ** 2)
        return loglik + logprior

    return log_prob


def make_circuit_log_prob_planar(plan: Plan, observed_counts, targets=None,
                                 prior_sigma: float = 10.0) -> Callable:
    """Planar-float32 twin of :func:`make_circuit_log_prob`.

    Evaluates the same posterior through the planar executor, the device
    compute path.  Every step is plain JAX, so gradients come from JAX's
    own differentiation rules and the default ``compile_circuit`` plan
    works directly.
    """
    from qbot_tpu.tpu.planar import (
        apply_plan_planar,
        planar_probs,
        zero_state_planar,
    )

    counts = jnp.asarray(observed_counts)

    def log_prob(theta):
        psi = apply_plan_planar(zero_state_planar(plan.n), plan, theta)
        p = planar_probs(psi, targets=targets, n=plan.n)
        p = jnp.clip(p, 1e-12, 1.0)
        loglik = jnp.sum(counts * jnp.log(p))
        logprior = -0.5 * jnp.sum((theta / prior_sigma) ** 2)
        return loglik + logprior

    return log_prob


class HMCState(NamedTuple):
    position: jax.Array
    log_prob: jax.Array
    grad: jax.Array


def hmc_init(log_prob: Callable, theta0: jax.Array) -> HMCState:
    lp, g = jax.value_and_grad(log_prob)(theta0)
    return HMCState(theta0, lp, g)


def _leapfrog(log_prob_grad, q, p, grad, eps: float, steps: int):
    def body(_, carry):
        q, p, grad = carry
        p = p + 0.5 * eps * grad
        q = q + eps * p
        _, grad = log_prob_grad(q)
        p = p + 0.5 * eps * grad
        return q, p, grad

    return jax.lax.fori_loop(0, steps, body, (q, p, grad))


def hmc_step(key: jax.Array, state: HMCState, log_prob: Callable,
             step_size: float = 0.1, num_leapfrog: int = 10) -> HMCState:
    """One Metropolis-adjusted HMC transition (traceable)."""
    lp_and_grad = jax.value_and_grad(log_prob)
    key_mom, key_acc = jax.random.split(key)
    p0 = jax.random.normal(key_mom, state.position.shape,
                           state.position.dtype)
    q, p, grad = _leapfrog(lp_and_grad, state.position, p0, state.grad,
                           step_size, num_leapfrog)
    new_lp, new_grad = lp_and_grad(q)
    ham0 = state.log_prob - 0.5 * jnp.sum(p0**2)
    ham1 = new_lp - 0.5 * jnp.sum(p**2)
    accept = jnp.log(jax.random.uniform(key_acc, ())) < (ham1 - ham0)
    return HMCState(
        jnp.where(accept, q, state.position),
        jnp.where(accept, new_lp, state.log_prob),
        jnp.where(accept, new_grad, state.grad),
    )


def run_hmc(key: jax.Array, log_prob: Callable, theta0: jax.Array,
            num_samples: int, step_size: float = 0.1,
            num_leapfrog: int = 10):
    """Single-chain HMC via lax.scan; returns (positions, log_probs)."""
    init = hmc_init(log_prob, theta0)

    def step(state, k):
        new = hmc_step(k, state, log_prob, step_size, num_leapfrog)
        return new, (new.position, new.log_prob)

    keys = jax.random.split(key, num_samples)
    _, (qs, lps) = jax.lax.scan(step, init, keys)
    return qs, lps


def run_hmc_chains(key: jax.Array, log_prob: Callable, theta0: jax.Array,
                   num_samples: int, step_size: float = 0.1,
                   num_leapfrog: int = 10):
    """vmapped multi-chain HMC; ``theta0``: (chains, dim).

    The chain axis is the data-parallel ``particles`` mesh axis — shard
    ``theta0`` with ``NamedSharding(mesh, P("particles", None))`` and jit
    this function to scale chains across chips/hosts.
    """
    chains = theta0.shape[0]
    keys = jax.random.split(key, chains)
    return jax.vmap(
        lambda k, t0: run_hmc(k, log_prob, t0, num_samples, step_size,
                              num_leapfrog)
    )(keys, theta0)


def dual_averaging_warmup(key: jax.Array, log_prob: Callable,
                          theta0: jax.Array, num_warmup: int = 100,
                          target_accept: float = 0.8,
                          init_step_size: float = 0.1,
                          num_leapfrog: int = 10):
    """Nesterov dual-averaging step-size adaptation (NUTS-style warmup).

    Returns (adapted_step_size, warmed_state).  Traceable; the acceptance
    statistic is the expected Metropolis ratio of each transition.
    """
    lp_and_grad = jax.value_and_grad(log_prob)
    mu = jnp.log(10.0 * init_step_size)
    state0 = hmc_init(log_prob, theta0)

    def step(carry, k):
        state, log_eps, log_eps_avg, h_avg, t = carry
        eps = jnp.exp(log_eps)
        key_mom, key_acc = jax.random.split(k)
        p0 = jax.random.normal(key_mom, state.position.shape,
                               state.position.dtype)
        q, p, grad = _leapfrog(lp_and_grad, state.position, p0, state.grad,
                               eps, num_leapfrog)
        new_lp, new_grad = lp_and_grad(q)
        ham0 = state.log_prob - 0.5 * jnp.sum(p0**2)
        ham1 = new_lp - 0.5 * jnp.sum(p**2)
        accept_prob = jnp.minimum(1.0, jnp.exp(ham1 - ham0))
        accept = jnp.log(jax.random.uniform(key_acc, ())) < (ham1 - ham0)
        state = HMCState(
            jnp.where(accept, q, state.position),
            jnp.where(accept, new_lp, state.log_prob),
            jnp.where(accept, new_grad, state.grad),
        )
        # dual averaging (Hoffman & Gelman 2014, alg. 5 constants)
        t = t + 1.0
        h_avg = (1 - 1 / (t + 10)) * h_avg + (target_accept - accept_prob) / (t + 10)
        log_eps = mu - jnp.sqrt(t) / 0.05 * h_avg
        w = t ** -0.75
        log_eps_avg = w * log_eps + (1 - w) * log_eps_avg
        return (state, log_eps, log_eps_avg, h_avg, t), accept_prob

    keys = jax.random.split(key, num_warmup)
    (state, _, log_eps_avg, _, _), accepts = jax.lax.scan(
        step, (state0, jnp.log(init_step_size), jnp.log(init_step_size),
               0.0, 0.0), keys)
    return jnp.exp(log_eps_avg), state
