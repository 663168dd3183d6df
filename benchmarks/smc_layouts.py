"""The SMC bench workload in one collapse formulation, on one GPU.

    python benchmarks/smc_layouts.py           # direct (2,)*n views
    python benchmarks/smc_layouts.py --safe    # mask/carrier formulations

Prints one JSON line: the bench SMC fields plus the process's peak
device memory.  Run each form in its own process, one after the other,
so the two peaks are comparable.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--safe", action="store_true")
    args = ap.parse_args(argv)

    import bench
    import qbot_tpu.inference.ensemble_exec as ee
    from qbot_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = bench.require_gpu()
    ee._FORCE_SAFE = args.safe
    out = bench.bench_smc()
    stats = dev.memory_stats() or {}
    out.update({"form": "safe" if args.safe else "direct",
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "device_kind": dev.device_kind,
                "nvidia_smi": bench.gpu_identity()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
