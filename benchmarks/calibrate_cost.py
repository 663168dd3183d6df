"""Cost-model calibration and per-operation roofline probe (one GPU).

Times, at 26 qubits (planar float32, 512 MiB per state):

* the in-place dot-engine window pass at widths 4-8, at each dot mode's
  precision (HIGHEST, HIGH, DEFAULT);
* the step executor's window pass at widths 4-8, two adjacent windows,
  an elementwise diagonal pass, and window passes with a fused real and
  complex pre-phase;
* one Grover iteration of the scanned reflection runner;
* a large bf16 matmul and a large copy, as the card's practical ceilings.

Each operation runs as a jitted ``lax.scan`` of REPEATS passes; the host
time is the best of three runs ending in ``block_until_ready``.  A
separate profiler trace of one run gives the device busy time, from which
the achieved bytes/s and the share of the card's peak follow.  The
constants of ``qbot_tpu.tpu.compiler``'s cost model are derived at the
end.  Also checks whether ``lowered.compile()`` writes the persistent
compilation cache.

    python benchmarks/calibrate_cost.py [--out chiprun_out/calibrate_cost.json]

Refuses to run without a GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N = 26
REPEATS = 20
WIDTHS = (4, 5, 6, 7, 8)
MODES = ("f32", "bf16_3x", "bf16")

# Published peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit),
# keyed by JAX's device_kind.  An unknown device is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops": 67e12, "tf32_flops": 495e12,
                              "bf16_flops": 989e12},
}


def device_peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device {kind!r}")
    return PEAKS[kind]


def _unitary(dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (r.diagonal() / np.abs(r.diagonal())).conj()


def _window(start: int, width: int, phases=()):
    from qbot_tpu.tpu.compiler import Term, WindowStep

    return WindowStep(start, width,
                      (Term(tuple(range(width)),
                            _unitary(2**width, 10 * start + width)),),
                      pre_phases=tuple(phases))


def _plan(steps, engine: str):
    from qbot_tpu.tpu.compiler import Plan

    return Plan(n=N, window=8, steps=list(steps), engine=engine)


def _union_ns(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_busy_ns(trace_dir: str) -> tuple[float, dict]:
    """Union of device event intervals in one profiler trace, and the
    per-line event time (for inspection).  Lines named like "Stream"
    carry the kernels; other device lines (modules, steps) are derived
    spans and only count when no stream line exists."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[0])
    stream, other, per_line = [], [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.start_ns + e.duration_ns)
                   for e in line.events]
            key = f"{plane.name}|{line.name}"
            per_line[key] = sum(e - s for s, e in evs)
            (stream if "stream" in line.name.lower() else other).extend(evs)
    return _union_ns(stream or other), per_line


def measure(fn, arg, bytes_per_rep: float, flops_per_rep: float,
            trace_root: str, name: str) -> dict:
    """Host and device time of ``fn(arg)`` (a REPEATS-long scan)."""
    import jax

    compiled = jax.jit(fn).lower(arg).compile()
    jax.block_until_ready(compiled(arg))
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(arg))
        host.append(time.perf_counter() - t0)
    tdir = os.path.join(trace_root, name)
    jax.profiler.start_trace(tdir)
    jax.block_until_ready(compiled(arg))
    jax.profiler.stop_trace()
    busy, lines = device_busy_ns(tdir)
    dev_s = busy * 1e-9 / REPEATS
    host_s = min(host) / REPEATS
    out = {"host_s_per_pass": host_s, "device_s_per_pass": dev_s,
           "gb_per_s": bytes_per_rep / dev_s / 1e9 if dev_s else None,
           "trace_lines_ns": lines}
    if flops_per_rep:
        out["tflops"] = flops_per_rep / dev_s / 1e12 if dev_s else None
    return out


def _scan(step):
    """jit-able fn(psi) applying ``step`` REPEATS times."""
    import jax

    def run(psi):
        def body(c, _):
            return step(c), None
        out, _ = jax.lax.scan(body, psi, None, length=REPEATS)
        return out
    return run


def aot_writes_cache() -> dict:
    """Does ``lowered.compile()`` write the persistent cache?"""
    import jax
    import jax.numpy as jnp

    from qbot_tpu.utils.compile_cache import cache_dir

    d = cache_dir()
    before = set(os.listdir(d)) if d and os.path.isdir(d) else set()
    prev = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    try:
        salt = float(time.time() % 1000)
        f = jax.jit(lambda x: jnp.sin(x) * salt + jnp.cos(x) ** 3)
        f.lower(jnp.ones((1024,), jnp.float32)).compile()
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          prev)
    after = set(os.listdir(d)) if d and os.path.isdir(d) else set()
    return {"cache_dir": d, "new_entries": len(after - before)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/calibrate_cost.json")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import bench
    from qbot_tpu.tpu.compiler import DiagStep, _window_flops
    from qbot_tpu.tpu.dotplan import (
        apply_plan_dot,
        carrier_shape,
        lower_dot_plan,
        set_dot_mode,
    )
    from qbot_tpu.tpu.planar import apply_plan_planar, zero_state_planar
    from qbot_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = bench.require_gpu()
    card = bench.gpu_identity()
    state_bytes = 2 * 2**N * 4
    rw = 2 * state_bytes                      # one pass: read + write
    psi = zero_state_planar(N)
    res = {"card": card, "device_kind": dev.device_kind, "qubits": N,
           "repeats": REPEATS,
           "aot_compile_cache": aot_writes_cache()}

    with tempfile.TemporaryDirectory() as troot:
        def run_op(name, step, arg, nbytes, flops=0.0):
            res[name] = measure(_scan(step), arg, nbytes, flops, troot,
                                name)
            print(f"{name}: {json.dumps({k: v for k, v in res[name].items() if k != 'trace_lines_ns'})}",
                  flush=True)

        # in-place dot-engine window passes, per precision mode
        for mode in MODES:
            set_dot_mode(mode)
            for w in WIDTHS:
                low = lower_dot_plan(_plan([_window(0, w)], "dot"))
                carrier = psi.reshape(carrier_shape(low))
                run_op(f"dot_{mode}_w{w}",
                       lambda p, low=low: apply_plan_dot(p, low,
                                                         carrier=True),
                       carrier, rw, _window_flops(N, w))
        set_dot_mode("f32")
        # fused pre-phases on the dot engine (width 4)
        for tag, z in (("real", -1.0), ("cplx", np.exp(0.3j))):
            low = lower_dot_plan(_plan(
                [_window(0, 4, [((0, N - 3), z, -1)])], "dot"))
            carrier = psi.reshape(carrier_shape(low))
            run_op(f"dot_phase_{tag}_w4",
                   lambda p, low=low: apply_plan_dot(p, low, carrier=True),
                   carrier, rw, _window_flops(N, 4))
        # step executor: windows, two adjacent windows, one diagonal pass
        for w in WIDTHS:
            plan = _plan([_window(0, w)], "step")
            run_op(f"step_w{w}",
                   lambda p, plan=plan: apply_plan_planar(p, plan),
                   psi, rw, _window_flops(N, w))
        two = _plan([_window(N - 13, 6), _window(N - 7, 7)], "step")
        run_op("step_w6_then_w7",
               lambda p: apply_plan_planar(p, two), psi, 2 * rw,
               _window_flops(N, 6) + _window_flops(N, 7))
        diag = _plan([DiagStep((3, N - 9), np.exp(1j * np.arange(4.0)))],
                     "step")
        run_op("step_diag", lambda p: apply_plan_planar(p, diag), psi, rw)

        # one Grover iteration (scanned reflection runner: one fused pass)
        grover, _, _, _ = bench.make_grover_runner(N, REPEATS)
        res["grover_iteration"] = measure(grover, psi, rw, 0.0, troot,
                                          "grover")
        # practical ceilings: a large copy and a large bf16 matmul
        big = jnp.ones((2, 2**N), jnp.float32)
        run_op("copy", lambda x: x * 1.0000001, big, rw)
        a = jnp.ones((8192, 8192), jnp.bfloat16)
        run_op("matmul_bf16_8192",
               lambda x: jnp.dot(x, a, preferred_element_type=jnp.float32
                                 ).astype(jnp.bfloat16),
               a, 3 * 8192 * 8192 * 2, 2.0 * 8192**3)

    # derived cost-model constants (device times)
    def t(name):
        return res[name]["device_s_per_pass"]

    stream = t("dot_f32_w4")
    flops = {m: _window_flops(N, 8) / t(f"dot_{m}_w8") for m in MODES}
    model = [max(stream, _window_flops(N, w) / flops["f32"]) for w in WIDTHS]
    slack = float(np.mean([t(f"dot_f32_w{w}") / m
                           for w, m in zip(WIDTHS, model)]))
    mix_min = next((w for w in WIDTHS
                    if t(f"dot_f32_w{w}") > 1.1 * t(f"dot_bf16_3x_w{w}")),
                   None)
    res["derived"] = {
        "_DOT_STREAM_BW": rw / stream,
        "_DOT_FLOPS": flops,
        "_STEP_BW": rw / t("step_w4"),
        "_XLA_BW": rw / t("step_diag"),
        "_DOT_SLACK": slack,
        "_PHASE_REAL": (t("dot_phase_real_w4") - stream) / stream,
        "_PHASE_CPLX": (t("dot_phase_cplx_w4") - stream) / stream,
        "_MIX_WIDTH_MIN": mix_min,
    }
    print("derived: " + json.dumps(res["derived"]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    # shares of the published peaks (an unknown device raises here, after
    # the raw times are written)
    peaks = device_peaks(dev.device_kind)
    res["peaks"] = peaks
    for v in res.values():
        if isinstance(v, dict) and v.get("gb_per_s"):
            v["hbm_share"] = v["gb_per_s"] * 1e9 / peaks["hbm_bytes_per_s"]
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
