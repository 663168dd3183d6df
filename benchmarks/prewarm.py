"""Pre-warm the persistent compilation cache for the bench workloads.

Compiles the Grover and general bench workloads once so later
`python bench.py` runs load their executables from the cache
(`JAX_COMPILATION_CACHE_DIR` when set, else `.jax_cache/`).  Running
bench.py itself warms the cache the same way while reporting
per-workload cache evidence via CacheHitProbe.  Needs a GPU.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import bench
    from qbot_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    bench.require_gpu()
    print(f"prewarming compile cache at {cache} ...", file=sys.stderr)
    t0 = time.perf_counter()
    bench.bench_grover()
    print(f"  grover workload compiled ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr)
    t0 = time.perf_counter()
    bench.bench_general()
    print(f"  general workloads compiled ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr)
    print("done; bench.py will now run warm", file=sys.stderr)


if __name__ == "__main__":
    main()
