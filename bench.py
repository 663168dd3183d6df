"""Benchmark: gate-applications/s on one GPU (BASELINE north-star metric).

Workloads, all on the first device (refuses to run on a CPU):

* **Grover 26q** (headline): the compiler's structural Householder-
  reflection detection collapses each iteration to one fused pass
  (scanned XLA loop).  Cold-start decomposes into staged fields
  (construct/trace/backend/first-run).
* **General circuit 26q**: a 256-layer brickwork of random SU(2) gates +
  CX entanglers (16-layer scan bodies; see GENERAL_LAYERS), the path
  every non-Grover program takes — the in-place dot engine, its ratio to
  the step executor, and the reduced-precision rows (bf16_3x, bf16,
  f32_mix, f32_mix+renorm) with norm/delta canaries.
* **Density 13q** (= 26q planar): mixed states through density_plan_2n
  on the same engine — the reference's only representation.
* **SMC 24q** (BASELINE config 5): particles through a mid-measurement
  program in sample mode on the sharded-ensemble path.

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
baseline is the same-task, same-qubit-count dense NumPy contraction path —
the strongest CPU formulation of the reference's math (the reference's own
O(8^n) full-space-operator design cannot represent 26 qubits at all; its
ceiling is ~13-14 qubits, SURVEY.md §6).

Compilation uses the persistent cache (qbot_tpu.utils.compile_cache); the
JSON reports the measured compile seconds and per-workload cache-hit
evidence.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
from __future__ import annotations

import json
import time

import numpy as np

N = 26
GROVER_REPEATS = 512   # Grover iterations timed (scanned body)
# 256 brickwork layers total, scanned as 16 bodies of 16 layers: the
# compiler's support-based lazy flushing merges interior layer PAIRS
# into one window round, but each scan-body boundary forces a flush —
# a 4-layer body costs 12 passes/4 layers, a 16-layer body 9 (measured
# schedule; round-5 change, same total gate count as rounds 1-4)
GENERAL_LAYERS = 16    # brickwork layers per scanned body
GENERAL_REPEATS = 16
BASELINE_GATES = 4     # numpy same-task gates to time for the ratio


def _timed(run, psi):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(run(psi))
    return time.perf_counter() - t0, out


def _timed_stages(run, psi):
    """Split cold-start cost into its stages via the AOT API.  Returns
    (stages dict, out):

    * ``trace_s``   — Python tracing + StableHLO lowering (host CPU);
    * ``backend_s`` — ``lowered.compile()``: persistent-cache lookup +
      executable deserialization, or the compile on a miss;
    * ``first_run_s`` — first dispatch + device execution + sync.
    """
    import jax

    t0 = time.perf_counter()
    lowered = run.lower(psi)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    out = jax.block_until_ready(compiled(psi))
    t3 = time.perf_counter()
    return {"trace_s": t1 - t0, "backend_s": t2 - t1,
            "first_run_s": t3 - t2, "total_s": t3 - t0}, out


GROVER_MARKED = 12345


def grover_circuits(n: int, marked: int = GROVER_MARKED):
    """(init, body) circuits of Grover search: H^n, then per iteration the
    oracle flip of ``marked`` and the diffusion H^n · flip(0) · H^n."""
    from qbot_tpu.tpu.circuit import Circuit

    init = Circuit(n)
    for q in range(n):
        init.h(q)
    body = Circuit(n)
    body.phase_flip(marked)
    for q in range(n):
        body.h(q)
    body.phase_flip(0)
    for q in range(n):
        body.h(q)
    return init, body


def grover_marked_prob(n: int, iterations: int) -> float:
    """Closed form: the marked-state probability after R iterations is
    sin²((2R+1)·asin(2^{-n/2}))."""
    import math

    return math.sin((2 * iterations + 1) * math.asin(2 ** (-n / 2))) ** 2


def make_grover_runner(n: int, repeats: int, marked: int = GROVER_MARKED):
    """(jitted scanned runner, body circuit, init circuit, body plan)."""
    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.planar import make_scanned_planar_runner

    init, body = grover_circuits(n, marked)
    body_plan = compile_circuit(body)
    run = make_scanned_planar_runner(body_plan, repeats,
                                     init_plan=compile_circuit(init))
    return run, body, init, body_plan


def bench_grover() -> tuple[float, dict]:
    from qbot_tpu.tpu.planar import zero_state_planar
    from qbot_tpu.utils.compile_cache import CacheHitProbe

    n = N
    t0 = time.perf_counter()
    run, body, init, body_plan = make_grover_runner(n, GROVER_REPEATS)
    psi0 = zero_state_planar(n)
    construct_s = time.perf_counter() - t0

    with CacheHitProbe() as probe:
        stages, out = _timed_stages(run, psi0)  # staged compile+first run
    compile_s = stages["total_s"] + construct_s
    elapsed = min(_timed(run, psi0)[0] for _ in range(2))
    _, out = _timed(run, psi0)

    # numeric correctness on the device: the closed-form marked-state
    # probability — a hardware-precision canary
    amp = np.asarray(out[:, GROVER_MARKED])
    p_marked = float(amp[0]) ** 2 + float(amp[1]) ** 2
    p_expected = grover_marked_prob(n, GROVER_REPEATS)

    gates = body.gate_count * GROVER_REPEATS + init.gate_count
    info = {
        "qubits": n,
        "grover_iterations": GROVER_REPEATS,
        "passes_per_iteration": body_plan.num_passes,
        "compile_seconds": round(compile_s, 2),
        "compile_construct_seconds": round(construct_s, 2),
        "compile_trace_seconds": round(stages["trace_s"], 2),
        "compile_backend_seconds": round(stages["backend_s"], 2),
        "compile_first_run_seconds": round(stages["first_run_s"], 2),
        "compile_cache_evidence": probe.verdict(),
        "run_seconds": round(elapsed, 4),
        "marked_prob": round(p_marked, 8),
        "marked_prob_expected": round(p_expected, 8),
    }
    return gates / elapsed, info


def brickwork(n: int, layers: int, seed: int = 0):
    from qbot_tpu.tpu.circuit import Circuit

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


def bench_general() -> dict:
    import jax
    import jax.numpy as jnp

    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.dotplan import set_dot_mode
    from qbot_tpu.tpu.planar import make_scanned_planar_runner, \
        zero_state_planar

    body = brickwork(N, GENERAL_LAYERS)
    # headline: the auto-compiled plan (the in-place dot engine, with
    # support-based lazy flushing and cross-window CZs as fused mask
    # multiplies)
    plan = compile_circuit(body, window="auto")
    gates = body.gate_count * GENERAL_REPEATS
    psi0 = zero_state_planar(N)

    from qbot_tpu.utils.compile_cache import CacheHitProbe

    results = {}
    outs = {}
    probes = {}
    # "on" = the auto plan (its ranked engine); "off" = the step executor
    # on the step partition (the XLA floor every engine is measured
    # against)
    plan_fallback = compile_circuit(body)
    for mode, pl in (("on", plan), ("off", plan_fallback)):
        run = make_scanned_planar_runner(pl, GENERAL_REPEATS)
        with CacheHitProbe() as probe:
            compile_s, _ = _timed(run, psi0)
        probes[mode] = probe
        elapsed, out = min((_timed(run, psi0) for _ in range(2)),
                           key=lambda t: t[0])
        results[mode] = elapsed
        outs[mode] = out
        if mode == "on":
            results["compile_on"] = compile_s

    # precision sweep.  The dot mode is read at trace time; each mode
    # builds a fresh runner, and clearing the in-process caches frees the
    # previous mode's executables.
    def _mode_run(mode, renorm):
        set_dot_mode(mode)
        jax.clear_caches()
        # re-rank under the mode's cost model: cheaper matmuls may move
        # the auto search to other widths
        pl = compile_circuit(body, window="auto")
        run = make_scanned_planar_runner(pl, GENERAL_REPEATS,
                                         renorm_every=renorm)
        c_s, _ = _timed(run, psi0)
        el, out = min((_timed(run, psi0) for _ in range(2)),
                      key=lambda t: t[0])
        set_dot_mode("f32")
        jax.clear_caches()
        return c_s, el, out

    # every reduced-precision mode, with its norm and delta canaries:
    # bf16_3x = Precision.HIGH on every window, bf16 = DEFAULT, f32_mix =
    # HIGH only on wide windows (plain, and with the free-cadence renorm
    # that folds 1/sqrt(norm) into the next body's first window matrix)
    rows = {}
    for label, mode, renorm in (("bf16_3x", "bf16_3x", 0),
                                ("bf16", "bf16", 0),
                                ("f32_mix", "f32_mix", 0),
                                ("f32_mix_renorm", "f32_mix", 1)):
        c_s, el, out = _mode_run(mode, renorm)
        rows.update({
            f"general_{label}_gates_per_s": round(gates / el, 1),
            f"general_{label}_vs_f32": round(results["on"] / el, 3),
            f"general_{label}_compile_seconds": round(c_s, 2),
            f"general_{label}_norm": round(float(jnp.sum(out ** 2)), 7),
            f"general_{label}_max_delta_vs_f32": float(
                f"{float(jnp.max(jnp.abs(out - outs['on']))):.2e}"),
        })

    # canaries: unitarity + engine/XLA agreement on the full final state
    norm = float(jnp.sum(outs["on"] ** 2))
    delta = float(jnp.max(jnp.abs(outs["on"] - outs["off"])))
    return {
        "general_gates_per_s": round(gates / results["on"], 1),
        "general_engine": plan.engine,
        "general_layers": GENERAL_LAYERS,
        "general_repeats": GENERAL_REPEATS,
        "general_passes_per_body": plan.num_passes,
        "general_compile_seconds": round(results["compile_on"], 2),
        "general_compile_cache_evidence": probes["on"].verdict(),
        "general_run_seconds": round(results["on"], 4),
        "general_vs_xla_fallback": round(results["off"] / results["on"], 3),
        "general_norm": round(norm, 6),
        "general_engine_xla_max_delta": float(f"{delta:.2e}"),
        **rows,
    }


DENSITY_QUBITS = 13    # 13q density = 26q planar through density_plan_2n
DENSITY_LAYERS = 8
DENSITY_REPEATS = 16


def bench_density() -> dict:
    """Mixed-state throughput on the device: a 13-qubit density-matrix
    brickwork — the reference's ONLY representation (reference
    qgates.py:278-279 is always G rho G-dagger) —
    through the 2n-qubit rows+conjugated-columns rewrite
    (dotplan.density_plan_2n), so rho runs on the same in-place dot
    engine as the statevector headline.  Canaries: trace preservation
    and a one-body delta against the step-by-step density executor.
    """
    import jax.numpy as jnp

    import gc

    import jax

    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.dotplan import (
        density_plan_2n,
        lower_dot_plan,
        make_scanned_dot_runner,
    )
    from qbot_tpu.tpu.planar import (
        make_planar_density_runner,
        zero_density_planar,
    )
    from qbot_tpu.utils.compile_cache import CacheHitProbe

    # the prior sections' cached executables pin constants and outputs;
    # the 13q density state is 512 MB per buffer and the canary needs
    # several — start from a clean device-memory slate
    jax.clear_caches()
    gc.collect()

    nd = DENSITY_QUBITS
    body = brickwork(nd, DENSITY_LAYERS, seed=7)
    plan = compile_circuit(body, window="auto")
    big = density_plan_2n(plan)
    big.engine = "dot"
    assert lower_dot_plan(big) is not None
    run = make_scanned_dot_runner(big, DENSITY_REPEATS)
    rho0 = zero_density_planar(nd).reshape(2, -1)

    with CacheHitProbe() as probe:
        compile_s, out = _timed(run, rho0)
    elapsed = min(_timed(run, rho0)[0] for _ in range(2))
    _, out = _timed(run, rho0)
    gates = body.gate_count * DENSITY_REPEATS

    rho = jnp.asarray(out).reshape(2, 2**nd, 2**nd)
    trace = float(jnp.sum(jnp.diagonal(rho[0])))
    # one-body parity vs the step-by-step density executor (jitted so
    # XLA manages the 512 MB intermediates instead of eager per-op
    # buffers)
    plan_step = compile_circuit(body, window="auto")
    plan_step.engine = "step"
    ref1 = make_planar_density_runner(plan_step)(zero_density_planar(nd))
    delta_dev = jax.jit(
        lambda r: jnp.max(jnp.abs(
            make_planar_density_runner(plan)(
                zero_density_planar(nd)) - r)))(ref1)
    delta = float(delta_dev)
    return {
        "density_gates_per_s": round(gates / elapsed, 1),
        "density_qubits": nd,
        "density_layers": DENSITY_LAYERS,
        "density_repeats": DENSITY_REPEATS,
        "density_passes_per_body": big.num_passes,
        "density_compile_seconds": round(compile_s, 2),
        "density_compile_cache_evidence": probe.verdict(),
        "density_run_seconds": round(elapsed, 4),
        "density_trace": round(trace, 6),
        "density_vs_step_executor_delta": float(f"{delta:.2e}"),
    }


SMC_QUBITS = 24
SMC_PARTICLES = 32


def smc_program(n: int) -> str:
    """The SMC workload's .qb source: three entangling layers with a
    ``meas`` after each, a ``disc`` before the last (4 collapse
    events)."""
    def layers():
        out = []
        for q in range(0, n, 3):
            out.append(f"gate hadamardGate ; {q}")
        for q in range(0, n - 1, 3):
            out.append(f"gate pauliXGate ; {q + 1} ; [{q}]")
        return out

    lines = [f"qset tensorExp(computation.kets[0], {n})"]
    lines += layers()
    lines += ["meas a ; computation ; [0]"]
    lines += layers()
    lines += [f"gate hadamardGate ; {n // 2}",
              f"meas b ; computation ; [{n // 2}]"]
    lines += layers()
    lines += [f"disc [{n - 1}]", "meas c ; computation ; [1, 2]"]
    return "\n".join(lines)


def bench_smc() -> dict:
    """The north-star probabilistic-computing workload (BASELINE.json
    config 5): SMC particles through a 24-qubit mid-measurement program
    in sample mode (constant memory) on the sharded-ensemble mesh path.

    This is the engine that replaces the reference's measurement/branch
    loop (reference measurement.py:107-165 + probVal.py:347-390); a
    "sample" is one full particle trajectory through the program (4
    collapse events).
    """
    import gc

    import jax

    from qbot_tpu.frontend.lowering import (
        lower_program,
        run_lowered_sharded_ensemble,
    )
    from qbot_tpu.tpu.sharding import make_mesh
    from qbot_tpu.utils.compile_cache import CacheHitProbe

    jax.clear_caches()           # free the prior sections' device memory
    gc.collect()

    n = SMC_QUBITS
    src = smc_program(n)

    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    walls = []
    with CacheHitProbe() as probe:
        for _ in range(3):
            stats: dict = {}
            lp = lower_program(src, mid_measure=True)
            t0 = time.perf_counter()
            res, _, _, _ = run_lowered_sharded_ensemble(
                lp, mesh=mesh, sample=SMC_PARTICLES, seed=0, stats=stats)
            walls.append(time.perf_counter() - t0)
    for r in ("a", "b", "c"):
        assert abs(sum(res[r].probs) - 1.0) < 1e-3
    wall = min(walls[1:])            # warm (first run pays cache loads)
    events = stats["collapse_events"]
    return {
        "smc_samples_per_s": round(SMC_PARTICLES / wall, 1),
        "smc_qubits": n,
        "smc_particles": SMC_PARTICLES,
        "smc_collapse_events": events,
        "smc_wall_s": round(wall, 3),
        "smc_first_run_s": round(walls[0], 3),
        "smc_per_collapse_wall_s": round(wall / events, 3),
        "smc_effective_gb_per_s": round(
            stats["hbm_bytes"] / wall / 1e9, 2),
        "smc_compile_cache_evidence": probe.verdict(),
    }


def numpy_baseline_gates_per_sec() -> float:
    """Same task on CPU NumPy: contraction-based statevector gate apply.

    Warm-up gate first (first-touch allocation), then per-gate median —
    the raw first-run timing is noisy at 0.5 GB working set.
    """
    from qbot_tpu.ops import core, gates

    psi = np.zeros(2**N, dtype=np.complex64)
    psi[0] = 1.0
    h = gates.hadamard().astype(np.complex64)
    psi = core.apply_gate_state(psi, h, [0])       # warm-up
    times = []
    for q in range(1, 1 + BASELINE_GATES):
        t0 = time.perf_counter()
        psi = core.apply_gate_state(psi, h, [q])
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1.0 / times[len(times) // 2]


def gpu_identity() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    return dev


def main():
    import jax

    from qbot_tpu.utils.compile_cache import cache_is_warm, \
        enable_compile_cache

    warm = cache_is_warm()
    enable_compile_cache()
    dev = require_gpu()
    card = gpu_identity()
    # per-workload cache-hit evidence comes from CacheHitProbe (JAX's own
    # monitoring events); "compile_cache" is only the directory state
    value, info = bench_grover()
    general = bench_general()
    density = bench_density()
    smc = bench_smc()
    baseline = numpy_baseline_gates_per_sec()
    out = {
        "metric": f"gate-applications/s/chip @ {N} qubits (Grover, "
                  f"statevector)",
        "value": round(value, 1),
        "unit": "gates/s",
        "vs_baseline": round(value / baseline, 2),
        "baseline_cpu_numpy_gates_per_s": round(baseline, 2),
        "compile_cache": "warm" if warm else "cold",
        "device": str(dev),
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi": card,
        **info,
        **general,
        **density,
        **smc,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
