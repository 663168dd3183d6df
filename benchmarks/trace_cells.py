"""Device busy and idle share of each bench cell, from profiler traces.

For each ``bench.py`` workload at its bench size: build and warm it up
(compilation is set-up, outside the window), then trace ONE steady run
and report the window's host wall time, the device busy time (union of
the GPU's kernel intervals) and the idle share 1 − busy / wall.

    python benchmarks/trace_cells.py [--out chiprun_out/trace_cells.json]

Refuses to run without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def cell_runners():
    """name -> zero-argument callable running one steady bench iteration
    and blocking until the device is done."""
    import jax

    import bench
    from qbot_tpu.frontend.lowering import (
        lower_program,
        run_lowered_sharded_ensemble,
    )
    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.dotplan import density_plan_2n, make_scanned_dot_runner
    from qbot_tpu.tpu.planar import (
        make_scanned_planar_runner,
        zero_density_planar,
        zero_state_planar,
    )
    from qbot_tpu.tpu.sharding import make_mesh

    grover, _, _, _ = bench.make_grover_runner(bench.N, bench.GROVER_REPEATS)
    general = make_scanned_planar_runner(
        compile_circuit(bench.brickwork(bench.N, bench.GENERAL_LAYERS),
                        window="auto"), bench.GENERAL_REPEATS)
    big = density_plan_2n(compile_circuit(
        bench.brickwork(bench.DENSITY_QUBITS, bench.DENSITY_LAYERS, seed=7),
        window="auto"))
    density = make_scanned_dot_runner(big, bench.DENSITY_REPEATS)
    psi0 = zero_state_planar(bench.N)
    rho0 = zero_density_planar(bench.DENSITY_QUBITS).reshape(2, -1)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    src = bench.smc_program(bench.SMC_QUBITS)

    def smc():
        res, ens, _, _ = run_lowered_sharded_ensemble(
            lower_program(src, mid_measure=True), mesh=mesh,
            sample=bench.SMC_PARTICLES, seed=0)
        jax.block_until_ready(ens.psi)

    return {
        "grover": lambda: jax.block_until_ready(grover(psi0)),
        "general": lambda: jax.block_until_ready(general(psi0)),
        "density": lambda: jax.block_until_ready(density(rho0)),
        "smc": smc,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/trace_cells.json")
    args = ap.parse_args(argv)

    import jax

    import bench
    from calibrate_cost import device_busy_ns
    from qbot_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    bench.require_gpu()
    out = {"card": bench.gpu_identity()}
    with tempfile.TemporaryDirectory() as troot:
        for name, run in cell_runners().items():
            run()                                   # compile + warm up
            tdir = os.path.join(troot, name)
            jax.profiler.start_trace(tdir)
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
            jax.profiler.stop_trace()
            busy, _ = device_busy_ns(tdir)
            out[name] = {"wall_s": wall, "device_busy_s": busy * 1e-9,
                         "idle_share": 1.0 - busy * 1e-9 / wall}
            print(f"{name}: {json.dumps(out[name])}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
