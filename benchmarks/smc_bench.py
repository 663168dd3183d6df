"""SMC/HMC samples/s and weak-scaling benchmark (BASELINE config 5).

Runs the parameterised-rotation posterior with HMC chains sharded over the
``particles`` mesh axis, at 1/2/4/8 devices with chains-per-device held
fixed, and reports samples/s plus weak-scaling efficiency.

By default the scaling runs on the host-emulated CPU mesh
(`--platform cpu`); `--platform gpu` runs it on the GPUs JAX finds, through
the planar log-prob path.

Usage: python benchmarks/smc_bench.py [--qubits 10] [--chains-per-dev 4]
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
    ap.add_argument("--qubits", type=int, default=10)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--chains-per-dev", type=int, default=4)
    ap.add_argument("--samples", type=int, default=32)
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
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qbot_tpu.inference import hmc
    from qbot_tpu.tpu.circuit import parameterized_layers
    from qbot_tpu.tpu.compiler import compile_circuit
    from qbot_tpu.tpu.sharding import make_mesh

    n = args.qubits
    circ = parameterized_layers(n, args.depth)
    counts = jnp.zeros(2**n).at[0].set(64.0).at[1].set(32.0)
    if args.platform == "cpu":
        plan = compile_circuit(circ)
        log_prob = hmc.make_circuit_log_prob(plan, counts,
                                             dtype=jnp.complex64)
    else:
        # the device path: the planar log-prob
        from qbot_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        plan = compile_circuit(circ)
        log_prob = hmc.make_circuit_log_prob_planar(plan, counts)

    results = []
    base_rate = None
    max_dev = len(jax.devices())
    for ndev in [d for d in (1, 2, 4, 8) if d <= max_dev]:
        chains = args.chains_per_dev * ndev
        mesh = make_mesh((ndev, 1), devices=jax.devices()[:ndev])
        sharding = NamedSharding(mesh, P("particles", None))
        theta0 = jax.device_put(
            jnp.linspace(0.1, 1.0, chains * circ.num_params)
            .reshape(chains, circ.num_params), sharding)

        run = jax.jit(lambda k, t0: hmc.run_hmc_chains(
            k, log_prob, t0, args.samples, step_size=0.05, num_leapfrog=5),
            in_shardings=(None, sharding))
        key = jax.random.PRNGKey(0)
        qs, _ = run(key, theta0)
        jax.block_until_ready(qs)                     # compile
        t0 = time.perf_counter()
        qs, _ = run(key, theta0)
        jax.block_until_ready(qs)
        dt = time.perf_counter() - t0
        rate = chains * args.samples / dt
        per_dev = rate / ndev
        if base_rate is None:
            base_rate = per_dev
        results.append({
            "devices": ndev,
            "chains": chains,
            "samples_per_s": round(rate, 1),
            "weak_scaling_efficiency": round(per_dev / base_rate, 3),
        })

    out = {
        "metric": f"SMC/HMC samples/s, {n}q ansatz depth {args.depth}",
        "platform": args.platform,
        "results": results,
    }
    if args.platform == "cpu":
        out["note"] = (
            f"emulated devices share {os.cpu_count()} physical cores; "
            "weak-scaling efficiency here measures the harness, not the "
            "hardware - chains are independent on real devices")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
