"""On-card smoke test: the system's main paths, end to end, on one GPU.

    python chip_smoke.py            # phases device..grad on one card
    python chip_smoke.py --multi    # the sharded paths on four cards

Each phase drives a user entry point or the engine it rests on at the
bench sizes (26 qubits statevector, 13 qubits density, 24 qubits SMC,
20 qubits gradients, 28 qubits sharded) and compares the result with an
independent reference: a closed form, the gate-by-gate ``ops/core.py``
contraction oracle in complex64, the dense interpreter, or the
single-card executor.  The run stops with a non-zero exit at the first
phase that fails.  Every phase prints its wall time and memory peak; the
last line of standard output is one JSON object naming the device.

Without a GPU (JAX falls back to the CPU) the script exits non-zero
before any phase runs.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

# Tolerances, each with its reason:
# * GROVER_RTOL: the marked-state probability after 512 reflections of a
#   2^26 f32 state; every pass rounds at ~1e-7 relative, so 1e-4 leaves
#   room for the accumulated reduction error and nothing else.
# * STATE_ATOL / STATE_RTOL: a 26-qubit state has typical amplitudes of
#   2^-13 ~ 1.2e-4, so a max-abs bound of 1e-4 alone would accept noise;
#   the binding checks are max-abs 1e-5 and a relative L2 error of 1e-4
#   (f32 at Precision.HIGHEST against a complex64 reference over ~12
#   passes sits near 1e-6).
# * NORM_TOL / TRACE_TOL: unitarity and trace preservation to 1e-4.
# * DIST_ATOL: exact outcome distributions from two executors agree to
#   f32 reduction noise, 1e-5.
# * SIGMAS: the outcome frequency among B sampled particles lies within
#   4 binomial standard deviations of the exact probability.
# * GRAD_RTOL: relative L2 gap of two float32 gradients through different
#   executors over two circuit layers, 1e-3.
#
# Exact fan-out runs in the projective collapse mode (a K-way fan-out per
# event) with EXACT_PARTICLES slots: the bench SMC program's 32 branches
# fit, so no branch is pruned (checked on the single-device run).
GROVER_RTOL = 1e-4
STATE_ATOL = 1e-5
STATE_RTOL = 1e-4
NORM_TOL = 1e-4
TRACE_TOL = 1e-4
DIST_ATOL = 1e-5
SIGMAS = 4.0
GRAD_RTOL = 1e-3
EXACT_PARTICLES = 32
EXACT = {"max_particles": EXACT_PARTICLES, "collapse_mode": "projective"}
# a measured qubit counts as definite within this of 0 or 1
DEFINITE_TOL = 1e-4
# dependent_program: P(a=1), P(b=1 | a=1), P(c=1 | b=1); the measured
# qubits sit at the first, middle and last axes
DEP_P1 = (0.8, 0.7, 0.25)


def _dep_qubits(n: int) -> tuple[int, int, int]:
    return 0, n // 2, n - 1


def check_device(count: int = 1):
    """Phase 1: the first device must be a GPU and ``count`` must exist."""
    import jax

    import bench

    bench.require_gpu()
    devs = jax.devices()
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX sees {len(devs)}")
    return devs


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _compiled_peak(compiled) -> int | None:
    """Bytes the executable needs: arguments + outputs + temporaries."""
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return int(ma.argument_size_in_bytes + ma.output_size_in_bytes
               + ma.temp_size_in_bytes - ma.alias_size_in_bytes)


def _device_peak() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else int(stats.get("peak_bytes_in_use", 0))


def _run_compiled(fn, *args):
    """AOT-compile ``fn`` for ``args``, run it, return (out, peak bytes)."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    return jax.block_until_ready(compiled(*args)), _compiled_peak(compiled)


def _planar_to_complex(psi) -> np.ndarray:
    psi = np.asarray(psi)
    return psi[0].astype(np.complex128) + 1j * psi[1]


def _state_errors(got: np.ndarray, want: np.ndarray) -> dict:
    diff = got.ravel() - want.ravel()
    return {"max_abs": float(np.max(np.abs(diff))),
            "rel_l2": float(np.linalg.norm(diff) / np.linalg.norm(want))}


def _gate_of(op):
    from qbot_tpu.ops import core

    gate = np.asarray(op.matrix, np.complex64)
    if op.controls:
        gate = core.controlled_matrix(gate, len(op.controls))
    return gate, tuple(op.controls) + tuple(op.targets)


_REF_JITS: dict = {}


def _ref_apply(kind: str):
    """Jitted gate-by-gate oracle step (targets static, state donated)."""
    import jax
    import jax.numpy as jnp

    from qbot_tpu.ops import core

    fn = _REF_JITS.get(kind)
    if fn is None:
        op = (core.apply_gate_state if kind == "state"
              else core.apply_gate_targets)
        fn = jax.jit(lambda x, g, t: op(x, g, list(t), xp=jnp),
                     static_argnums=2, donate_argnums=0)
        _REF_JITS[kind] = fn
    return fn


def reference_state(circ) -> np.ndarray:
    """|ψ⟩ = circ|0…0⟩ gate by gate through the ``ops/core.py``
    contraction oracle, complex64, Precision.HIGHEST."""
    import jax
    import jax.numpy as jnp

    step = _ref_apply("state")
    with jax.default_matmul_precision("highest"):
        psi = jnp.zeros(2**circ.n, jnp.complex64).at[0].set(1.0)
        for op in circ.ops:
            gate, qubits = _gate_of(op)
            psi = step(psi, jnp.asarray(gate), qubits)
        return np.asarray(psi)


def reference_density(circ) -> np.ndarray:
    """ρ = G|0⟩⟨0|G† gate by gate through the density contraction
    oracle, complex64, Precision.HIGHEST."""
    import jax
    import jax.numpy as jnp

    step = _ref_apply("density")
    d = 2**circ.n
    with jax.default_matmul_precision("highest"):
        rho = jnp.zeros((d, d), jnp.complex64).at[0, 0].set(1.0)
        for op in circ.ops:
            gate, qubits = _gate_of(op)
            rho = step(rho, jnp.asarray(gate), qubits)
        return np.asarray(rho)


def _run_cli(argv) -> tuple[int, str]:
    """``qbot_tpu.cli.main`` in this process, stdout captured."""
    from qbot_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _outcome_table(text: str) -> list[float]:
    """Probabilities from the CLI's ``<symbols>- <p> (<pct>%)`` lines."""
    probs = []
    for line in text.splitlines():
        if line.endswith("%)") and "- " in line:
            probs.append(float(line.rsplit(" (", 1)[0].rsplit("- ", 1)[1]))
    return probs


def _compare_dists(got: dict, want: dict, names, atol: float) -> float:
    worst = 0.0
    for name in names:
        g = np.asarray(got[name].probs, float)
        w = np.asarray(want[name].probs, float)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        worst = max(worst, float(np.max(np.abs(g - w))))
    assert worst <= atol, f"distributions differ by {worst:.3e} > {atol}"
    return worst


def _check_freqs(label: str, freq, exact, B: int) -> float:
    """Outcome frequencies of B sampled particles against the exact
    distribution: each within SIGMAS binomial σ.  Returns the largest
    deviation in units of σ."""
    freq = np.asarray(freq, float)
    exact = np.asarray(exact, float)
    assert freq.shape == exact.shape, (label, freq.shape, exact.shape)
    sigma = np.sqrt(exact * (1.0 - exact) / B)
    dev = np.abs(freq - exact)
    assert np.all(dev <= SIGMAS * sigma + DIST_ATOL), (
        f"{label}: sampled frequencies {freq} vs exact {exact} "
        f"(sigma {sigma})")
    return float(np.max(dev / np.where(sigma > 0, sigma, np.inf)))


def _final_outcomes(ens, perm, qubits) -> np.ndarray:
    """Weighted outcome frequencies of logical ``qubits`` (MSB first)
    read from the particles of a finished run.

    The qubits of a run's last ``meas`` are untouched after it, so each
    live particle holds them definite: its sampled outcome.  Fails when
    a particle holds a measured qubit in superposition."""
    import jax
    import jax.numpy as jnp

    from qbot_tpu.tpu.sharded_ensemble import _NEG

    n = len(perm)
    B = ens.psi.shape[0]
    cols = []
    for q in qubits:
        p = list(perm).index(q)
        p1 = jax.jit(lambda x, p=p: jnp.sum(
            x.reshape(B, 2, 2**p, 2, 2**(n - p - 1))[:, :, :, 1] ** 2,
            axis=(1, 2, 3)))(ens.psi)
        cols.append(np.asarray(p1, float))
    p1 = np.stack(cols, axis=1)
    log_w = np.asarray(ens.log_w, float)
    live = log_w > _NEG / 2
    p1 = p1[live]
    assert np.all(np.minimum(p1, 1.0 - p1) <= DEFINITE_TOL), (
        f"measured qubits {qubits} not definite: {p1.tolist()}")
    w = np.exp(log_w[live] - log_w[live].max())
    w /= w.sum()
    bits = np.rint(p1).astype(int)
    idx = (bits << np.arange(len(qubits))[::-1]).sum(axis=1)
    return np.bincount(idx, weights=w, minlength=2 ** len(qubits))


def dependent_program(n: int) -> str:
    """An SMC program whose later marginals depend on earlier outcomes,
    with non-dyadic probabilities: qubit a is rotated to P(1) = 0.8, b
    is rotated controlled on a to P(1 | a=1) = 0.7, c controlled on b to
    P(1 | b=1) = 0.25; every other qubit carries a Hadamard."""
    qa, qb, qc = _dep_qubits(n)
    lines = [f"qset tensorExp(computation.kets[0], {n})"]
    lines += [f"gate hadamardGate ; {q}" for q in range(n)
              if q not in (qa, qb, qc)]
    th = [2.0 * math.asin(math.sqrt(p)) for p in DEP_P1]
    lines += [f"gate yRotGate({th[0]!r}) ; {qa}",
              f"meas a ; computation ; [{qa}]",
              f"gate yRotGate({th[1]!r}) ; {qb} ; [{qa}]",
              f"meas b ; computation ; [{qb}]",
              f"gate yRotGate({th[2]!r}) ; {qc} ; [{qb}]",
              f"meas c ; computation ; [{qc}]"]
    return "\n".join(lines)


def dependent_exact() -> dict:
    """Closed-form outcome distributions of :func:`dependent_program`."""
    pa = DEP_P1[0]
    pb = pa * DEP_P1[1]
    pc = pb * DEP_P1[2]
    return {"a": [1 - pa, pa], "b": [1 - pb, pb], "c": [1 - pc, pc]}


def _check_dependent_sample(sampled: dict, ens, perm, B: int) -> dict:
    """Sample-mode checks of :func:`dependent_program`.

    With uniform weights, the ensemble marginal that ``meas b`` reports
    is P(1 | a=1) times the fraction of particles that sampled a = 1, and
    likewise for c and b; the outcome of c is read from the final
    particles.  Each recovered frequency must be a whole number of
    particles and lie within SIGMAS σ of its exact probability."""
    exact = dependent_exact()
    freqs = {
        "a": lambda: float(sampled["b"].probs[1]) / DEP_P1[1],
        "b": lambda: float(sampled["c"].probs[1]) / DEP_P1[2],
        "c": lambda: float(_final_outcomes(
            ens, perm, [_dep_qubits(len(perm))[2]])[1]),
    }
    out = {}
    for name, freq in freqs.items():
        f = freq()
        whole = abs(f * B - round(f * B))
        assert whole <= 1e-3, f"{name}: frequency {f} is not k/{B}"
        out[name] = _check_freqs(name, [1 - f, f], exact[name], B)
    return out


def _grover_qb(n: int, marked: int, iters: int, k: int) -> str:
    """A Grover search .qb program measuring its first ``k`` qubits."""
    ctrl = "[" + ", ".join(str(q) for q in range(n - 1)) + "]"
    zeros = [q for q in range(n) if not (marked >> (n - 1 - q)) & 1]
    lines = [f"qset tensorExp(computation.kets[0], {n})"]
    lines += [f"gate hadamardGate ; {q}" for q in range(n)]
    for _ in range(iters):
        lines += [f"gate pauliXGate ; {q}" for q in zeros]
        lines += [f"gate pauliZGate ; {n - 1} ; {ctrl}"]
        lines += [f"gate pauliXGate ; {q}" for q in zeros]
        lines += [f"gate hadamardGate ; {q}" for q in range(n)]
        lines += [f"gate pauliXGate ; {q}" for q in range(n)]
        lines += [f"gate pauliZGate ; {n - 1} ; {ctrl}"]
        lines += [f"gate pauliXGate ; {q}" for q in range(n)]
        lines += [f"gate hadamardGate ; {q}" for q in range(n)]
    targets = ", ".join(str(q) for q in range(k))
    lines += [f"meas out ; computation ; [{targets}]"]
    return "\n".join(lines) + "\n"


def _grover_marginal(n: int, marked: int, iters: int, k: int) -> np.ndarray:
    """Closed-form distribution of the first k qubits after Grover: the
    marked state holds p, every other state (1 − p)/(2^n − 1)."""
    import bench

    p = bench.grover_marked_prob(n, iters)
    other = (1.0 - p) / (2**n - 1)
    dist = np.full(2**k, other * 2**(n - k))
    dist[marked >> (n - k)] += p - other
    return dist


# ---------------------------------------------------------------------------
# phases (each returns a dict of what it measured; failures raise)
# ---------------------------------------------------------------------------

def phase_grover(workdir: str, n: int = 26, repeats: int = 512,
                 cli_iters: int = 2, cli_k: int = 4) -> dict:
    """Scanned Grover runner vs the closed form, then a Grover .qb
    program through the CLI's ``--compile`` path in this process."""
    import bench
    from qbot_tpu.tpu.planar import zero_state_planar

    marked = bench.GROVER_MARKED % 2**n
    run, _, _, _ = bench.make_grover_runner(n, repeats, marked)
    psi0 = zero_state_planar(n)
    compiled = run.lower(psi0).compile()
    out = np.asarray(compiled(psi0)[:, marked])
    p = float(out[0]) ** 2 + float(out[1]) ** 2
    want = bench.grover_marked_prob(n, repeats)
    rel = abs(p - want) / want
    assert rel <= GROVER_RTOL, f"marked prob {p} vs {want} (rel {rel:.2e})"

    path = os.path.join(workdir, "grover.qb")
    with open(path, "w") as f:
        f.write(_grover_qb(n, marked, cli_iters, cli_k))
    rc, text = _run_cli([path, "--compile"])
    assert rc == 0, f"cli --compile exited {rc}"
    got = np.asarray(_outcome_table(text))
    dist = _grover_marginal(n, marked, cli_iters, cli_k)
    assert got.shape == dist.shape, (got.shape, text[-500:])
    cli_rel = float(np.max(np.abs(got - dist) / dist))
    assert cli_rel <= GROVER_RTOL, f"cli marginal rel error {cli_rel:.2e}"
    return {"marked_prob": p, "expected": want, "rel_err": rel,
            "cli_rel_err": cli_rel, "peak_bytes": _compiled_peak(compiled),
            "tol": f"rel {GROVER_RTOL}"}


def phase_general(n: int = 26, layers: int = 16, seed: int = 0) -> dict:
    """One brickwork body through the auto plan (dot engine) and the step
    executor vs the gate-by-gate complex64 oracle."""
    import bench
    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.planar import apply_plan_planar, zero_state_planar

    body = bench.brickwork(n, layers, seed)
    want = reference_state(body)
    plans = {"dot": compile_circuit(body, window="auto"),
             "step": compile_circuit(body)}
    assert plans["dot"].engine == "dot" and plans["step"].engine == "step"
    res = {"tol": f"max_abs {STATE_ATOL}, rel_l2 {STATE_RTOL}, "
                  f"norm {NORM_TOL}"}
    for name, plan in plans.items():
        out, peak = _run_compiled(
            lambda p, plan=plan: apply_plan_planar(p, plan),
            zero_state_planar(n))
        got = _planar_to_complex(out)
        err = _state_errors(got, want)
        norm = float(np.sum(np.abs(got) ** 2))
        assert err["max_abs"] <= STATE_ATOL, (name, err)
        assert err["rel_l2"] <= STATE_RTOL, (name, err)
        assert abs(norm - 1.0) <= NORM_TOL, (name, norm)
        res[name] = {**err, "norm": norm, "passes": plan.num_passes,
                     "peak_bytes": peak}
    return res


def phase_density(nd: int = 13, layers: int = 16, seed: int = 7) -> dict:
    """The density plan (density_plan_2n on the dot engine) vs the
    gate-by-gate density oracle."""
    import bench
    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.dotplan import (
        apply_plan_dot,
        density_plan_2n,
        lower_dot_plan,
    )
    from qbot_tpu.tpu.planar import zero_density_planar

    body = bench.brickwork(nd, layers, seed)
    lowered = lower_dot_plan(density_plan_2n(
        compile_circuit(body, window="auto")))
    assert lowered is not None, "density plan did not lower"
    out, peak = _run_compiled(lambda r: apply_plan_dot(r, lowered),
                              zero_density_planar(nd).reshape(2, -1))
    got = _planar_to_complex(out).reshape(2**nd, 2**nd)
    want = reference_density(body)
    err = _state_errors(got, want)
    trace = float(np.real(np.trace(got)))
    assert err["rel_l2"] <= STATE_RTOL, err
    assert abs(trace - 1.0) <= TRACE_TOL, trace
    return {**err, "trace": trace, "peak_bytes": peak,
            "tol": f"rel_fro {STATE_RTOL}, trace {TRACE_TOL}"}


def phase_smc(workdir: str, n: int = 24, particles: int = 32,
              n_dense: int = 12) -> dict:
    """Two SMC programs, the bench workload and
    :func:`dependent_program`, at n qubits: exact fan-out on the device
    vs the single-device exact executor (and, for the dependent
    program, its closed form), and vs the dense interpreter at n_dense;
    sample mode with the sampled outcome frequencies within SIGMAS σ of
    the exact distributions; the bench program through the CLI's
    ``--ensemble --smc`` path."""
    import jax

    import bench
    from qbot_tpu.frontend.interpreter import executeTxt
    from qbot_tpu.frontend.lowering import (
        lower_program,
        run_lowered_ensemble,
        run_lowered_sharded_ensemble,
    )
    from qbot_tpu.tpu.sharding import make_mesh

    names = ("a", "b", "c")
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    res = {"tol": f"exact {DIST_ATOL}, sample {SIGMAS} sigma"}
    for label, make in (("bench", bench.smc_program),
                        ("dependent", dependent_program)):
        exact = {}
        for size in (n, n_dense):
            src = make(size)
            exact[size], _, _, _ = run_lowered_sharded_ensemble(
                lower_program(src, mid_measure=True), mesh=mesh, **EXACT)
        single, single_ens = run_lowered_ensemble(
            lower_program(make(n), mid_measure=True), **EXACT)
        assert float(single_ens.lost_mass) == 0.0, "exact run pruned"
        row = {"exact_vs_single": _compare_dists(exact[n], single, names,
                                                 DIST_ATOL),
               "exact_vs_dense": _compare_dists(
                   exact[n_dense], executeTxt(make(n_dense)), names,
                   DIST_ATOL)}
        if label == "dependent":
            closed = dependent_exact()
            row["exact_vs_closed_form"] = max(
                float(np.max(np.abs(np.asarray(exact[n][k].probs)
                                    - closed[k]))) for k in names)
            assert row["exact_vs_closed_form"] <= DIST_ATOL, row

        t0 = time.perf_counter()
        sampled, ens, perm, _ = run_lowered_sharded_ensemble(
            lower_program(make(n), mid_measure=True), mesh=mesh,
            sample=particles, seed=0)
        row["sample_wall_s"] = time.perf_counter() - t0
        assert ens.num_particles == particles
        if label == "dependent":
            row["sample_sigma"] = _check_dependent_sample(
                sampled, ens, perm, particles)
        else:
            # meas c ([1, 2]) is the program's last operation
            row["sample_sigma"] = _check_freqs(
                "c", _final_outcomes(ens, perm, [1, 2]),
                exact[n]["c"].probs, particles)
        res[label] = row

    path = os.path.join(workdir, "smc.qb")
    with open(path, "w") as f:
        f.write(bench.smc_program(n) + "\n")
    rc, text = _run_cli([path, "--compile", "--ensemble", "--smc",
                         str(particles)])
    assert rc == 0, f"cli --ensemble --smc exited {rc}"
    for name in names:
        assert f"{name}:" in text, (name, text[-500:])
    return res


def phase_grad(n: int = 20, depth: int = 2) -> dict:
    """jax.grad of a log-likelihood through the planar executors (step
    and dot engines) vs the complex reference; then one HMC step."""
    import jax
    import jax.numpy as jnp

    from qbot_tpu.inference.hmc import (
        hmc_init,
        hmc_step,
        make_circuit_log_prob,
        make_circuit_log_prob_planar,
    )
    from qbot_tpu.tpu.circuit import parameterized_layers
    from qbot_tpu.tpu.compiler import compile_circuit

    circ = parameterized_layers(n, depth)
    counts = jnp.zeros(2**n).at[0].set(40.0).at[3].set(24.0)
    theta = jnp.linspace(0.2, 1.4, circ.num_params, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        g_ref = np.asarray(jax.jit(jax.grad(make_circuit_log_prob(
            compile_circuit(circ), counts)))(theta))
    res = {"tol": f"rel_l2 {GRAD_RTOL}"}
    for name, plan in (("step", compile_circuit(circ)),
                       ("dot", compile_circuit(circ, window="auto"))):
        lp = make_circuit_log_prob_planar(plan, counts)
        g, peak = _run_compiled(jax.grad(lp), theta)
        g = np.asarray(g)
        rel = float(np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref))
        assert rel <= GRAD_RTOL, (name, rel)
        res[name] = {"rel_l2": rel, "peak_bytes": peak}
    state = jax.jit(lambda t: hmc_init(lp, t))(theta)
    step = jax.jit(lambda k, s: hmc_step(k, s, lp, step_size=0.01,
                                         num_leapfrog=3))
    new = jax.block_until_ready(step(jax.random.PRNGKey(0), state))
    assert np.all(np.isfinite(np.asarray(new.position)))
    assert np.isfinite(float(new.log_prob))
    res["hmc_log_prob"] = float(new.log_prob)
    return res


# ---------------------------------------------------------------------------
# four-card phases (--multi)
# ---------------------------------------------------------------------------

def _spread(x, count: int) -> None:
    got = len(x.sharding.device_set)
    assert got == count, f"state spans {got} devices, expected {count}"


def _unpermute_host(psi: np.ndarray, perm) -> np.ndarray:
    """:func:`qbot_tpu.tpu.sharded.unpermute_planar` in host memory: the
    rank-(n+1) device transpose did not compile within two minutes on
    the H100 at 28 qubits (PERF.md)."""
    n = len(perm)
    pos = [0] * n
    for p, q in enumerate(perm):
        pos[q] = p
    t = psi.reshape((2,) + (2,) * n)
    t = t.transpose((0,) + tuple(1 + pos[q] for q in range(n)))
    return np.ascontiguousarray(t).reshape(2, -1)


def phase_multi_planar(n: int = 28, layers: int = 4, k: int = 2) -> dict:
    """The shard_map planar executor on a (1, 2^k) mesh vs the single-
    card dot engine."""
    import jax

    import bench
    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.planar import apply_plan_planar, zero_state_planar
    from qbot_tpu.tpu.sharded import (
        compile_sharded,
        make_sharded_planar_runner,
        sharded_zero_state,
    )
    from qbot_tpu.tpu.sharding import make_mesh

    K = 2**k
    circ = bench.brickwork(n, layers, seed=3)
    mesh = make_mesh((1, K), devices=jax.devices()[:K])
    splan = compile_sharded(circ, k)
    psi = jax.block_until_ready(
        make_sharded_planar_runner(splan, mesh)(sharded_zero_state(n, mesh)))
    _spread(psi, K)
    got = _unpermute_host(np.asarray(psi), splan.final_perm)
    del psi
    plan = compile_circuit(circ, window="auto")
    want, peak = _run_compiled(lambda p: apply_plan_planar(p, plan),
                               zero_state_planar(n))
    want = np.asarray(want)
    diff = got - want
    err = {"max_abs": float(np.max(np.abs(diff))),
           "rel_l2": float(np.sqrt(np.sum(np.square(diff, dtype=np.float64))
                                   / np.sum(np.square(want,
                                                      dtype=np.float64))))}
    assert err["max_abs"] <= STATE_ATOL and err["rel_l2"] <= STATE_RTOL, err
    return {**err, "reshards": splan.num_reshards, "devices": K,
            "reference_peak_bytes": peak,
            "tol": f"max_abs {STATE_ATOL}, rel_l2 {STATE_RTOL}"}


def phase_multi_ensemble(workdir: str, n: int = 24,
                         particles: int = 32) -> dict:
    """run_lowered_sharded_ensemble on (4,1), (2,2), (1,4): exact mode
    (the bench SMC program) vs single-card exact; q-sharded sample mode
    (:func:`dependent_program`) with the sampled-frequency checks of
    :func:`phase_smc`; then the CLI's ``--mesh 2x2 --smc`` path."""
    import jax

    import bench
    from qbot_tpu.frontend.lowering import (
        lower_program,
        run_lowered_ensemble,
        run_lowered_sharded_ensemble,
    )
    from qbot_tpu.tpu.sharding import make_mesh

    names = ("a", "b", "c")
    src = bench.smc_program(n)
    dep = dependent_program(n)
    single, single_ens = run_lowered_ensemble(
        lower_program(src, mid_measure=True), **EXACT)
    assert float(single_ens.lost_mass) == 0.0, "exact run pruned branches"
    out = {}
    for shape in ((4, 1), (2, 2), (1, 4)):
        mesh = make_mesh(shape, devices=jax.devices()[:4])
        exact, ens, _, _ = run_lowered_sharded_ensemble(
            lower_program(src, mid_measure=True), mesh=mesh, **EXACT)
        _spread(ens.psi, 4)
        row = {"exact_vs_single": _compare_dists(exact, single, names,
                                                 DIST_ATOL)}
        if shape[1] > 1:
            sampled, sens, perm, _ = run_lowered_sharded_ensemble(
                lower_program(dep, mid_measure=True), mesh=mesh,
                sample=particles, seed=0)
            _spread(sens.psi, 4)
            row["sample_sigma"] = _check_dependent_sample(
                sampled, sens, perm, particles)
        out[f"{shape[0]}x{shape[1]}"] = row

    path = os.path.join(workdir, "smc.qb")
    with open(path, "w") as f:
        f.write(src + "\n")
    rc, text = _run_cli([path, "--compile", "--ensemble", "--mesh", "2x2",
                         "--smc", str(particles)])
    assert rc == 0, f"cli --mesh 2x2 --smc exited {rc}"
    for name in names:
        assert f"{name}:" in text, (name, text[-500:])
    out["tol"] = f"exact {DIST_ATOL}, sample {SIGMAS} sigma"
    return out


# ---------------------------------------------------------------------------

def _run_phase(name: str, fn, *args) -> None:
    t0 = time.perf_counter()
    res = fn(*args)
    wall = time.perf_counter() - t0
    print(f"phase {name}: ok wall_s={wall:.3f} "
          f"device_peak_bytes={_device_peak()} {json.dumps(res)}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args(argv)

    import jax

    import bench
    from qbot_tpu.utils.compile_cache import enable_compile_cache

    count = 4 if args.multi else 1
    devs = check_device(count)
    enable_compile_cache()
    print(f"card: {bench.gpu_identity()}", flush=True)
    print(f"phase device: ok platform={devs[0].platform} "
          f"kind={devs[0].device_kind!r} count={len(devs)}", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        if args.multi:
            _run_phase("multi_planar", phase_multi_planar)
            _run_phase("multi_ensemble", phase_multi_ensemble, workdir)
        else:
            _run_phase("grover", phase_grover, workdir)
            _run_phase("general", phase_general)
            _run_phase("density", phase_density)
            _run_phase("smc", phase_smc, workdir)
            _run_phase("grad", phase_grad)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
