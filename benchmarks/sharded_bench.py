"""Sharded-register scaling benchmark (BASELINE config 4: Grover sharded).

Runs Grover at --qubits over 1/2/4/8-way qubit sharding through the
shard_map planar executor and reports, per mesh size: reshard count,
interconnect bytes, reflection count, and wall time per iteration.

By default timings come from the host-emulated CPU mesh (harness-only
numbers — emulated devices share the physical cores); `--platform gpu`
runs on the GPUs JAX finds.  The STRUCTURAL metrics (reshards, comm
bytes, reflects) are exact on either: a Grover iteration is 2 local
passes + one scalar psum, independent of mesh size, so weak scaling is
communication-free by construction.

Usage: python benchmarks/sharded_bench.py [--qubits 20] [--iters 8]
       [--platform cpu|gpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--qubits", type=int, default=20)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu")
    args = ap.parse_args()

    if args.platform == "cpu":
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit("--platform gpu: JAX found no GPU")

    from qbot_tpu.tpu.circuit import grover_circuit
    from qbot_tpu.tpu.sharded import (
        ShardedReflect,
        compile_sharded,
        make_sharded_planar_runner,
        sharded_probs_fn,
        sharded_zero_state,
    )
    from qbot_tpu.tpu.sharding import make_mesh

    n = args.qubits
    circ = grover_circuit(n, marked=12345 % 2**n, iterations=args.iters)
    max_dev = len(jax.devices())

    results = []
    for ndev in [d for d in (1, 2, 4, 8) if d <= max_dev]:
        k = ndev.bit_length() - 1
        mesh = make_mesh((1, ndev), devices=jax.devices()[:ndev])
        splan = compile_sharded(circ, k)
        run = make_sharded_planar_runner(splan, mesh)
        psi0 = sharded_zero_state(n, mesh)
        psi = run(psi0)
        jax.block_until_ready(psi)                    # compile
        t0 = time.perf_counter()
        psi = run(psi0)
        jax.block_until_ready(psi)
        dt = time.perf_counter() - t0
        probs = sharded_probs_fn(splan, mesh,
                                 targets=list(range(min(n, 14))))(psi)
        jax.block_until_ready(probs)
        results.append({
            "devices": ndev,
            "reshards": splan.num_reshards,
            "reflections": sum(isinstance(i, ShardedReflect)
                               for i in splan.items),
            "comm_bytes": splan.comm_bytes(),
            "ms_per_iteration": round(dt * 1e3 / args.iters, 3),
        })

    print(json.dumps({
        "metric": f"sharded Grover {n}q x {args.iters} iterations",
        "platform": args.platform,
        "results": results,
        "note": ("emulated-mesh wall times measure the harness only; "
                 "reshard/comm metrics are exact"
                 if args.platform == "cpu" else "wall times on GPUs"),
    }))


if __name__ == "__main__":
    main()
