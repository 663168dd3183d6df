"""Command-line interface.

Capability parity with the reference CLI (reference ``qbot/cli.py:7-57``,
``qbot FILE``) plus engine flags for the device backend (mesh shape, dtype,
seed — SURVEY.md §5 config plan).
"""
from __future__ import annotations

import argparse
import os
import sys


def _file_path(path: str) -> str:
    if os.path.isabs(path):
        return path
    return os.path.join(os.getcwd(), path.lstrip("/"))




def build_parser() -> argparse.ArgumentParser:
    from qbot_tpu import __version__

    parser = argparse.ArgumentParser(
        prog="qbot-tpu",
        description=(
            "a JAX language runtime for analyzing quantum algorithms "
            "using the quantum circuit model and probabilistic computing.\n"
            "paradigms: quantum, probabilistic, imperative, interpreted"
        ),
    )
    parser.add_argument("--version", action="version",
                        version="%(prog)s " + __version__)
    parser.add_argument("FILE", type=str,
                        help="path to the .qb file to execute (relative or absolute)")
    parser.add_argument("--backend", choices=["numpy", "jax"], default="numpy",
                        help="numeric engine: numpy oracle (default) or jax")
    parser.add_argument("--dtype", choices=["c64", "c128"], default=None,
                        help="complex precision (default: c128 numpy, c64 jax)")
    parser.add_argument("--seed", type=int, default=0,
                        help="PRNG seed for sampling layers (SMC/HMC)")
    parser.add_argument("--precision",
                        choices=["f32", "f32_mix", "bf16_3x", "bf16"],
                        default=None,
                        help="device window matmul precision: f32 "
                             "(Precision.HIGHEST, default), f32_mix "
                             "(HIGH only on windows of width >= 5, "
                             "HIGHEST elsewhere), bf16_3x "
                             "(Precision.HIGH), bf16 (Precision.DEFAULT). "
                             " The reduced modes drift the norm; their "
                             "measured error is in PERF.md")
    parser.add_argument("--profile", action="store_true",
                        help="print a per-line wall-time report after execution")
    parser.add_argument("--compile", dest="compile_mode", action="store_true",
                        help="lower the program to the circuit IR and run it "
                             "on the device engine (unitary fragment only)")
    parser.add_argument("--shard", type=int, default=0, metavar="K",
                        help="with --compile: shard the register over 2^K "
                             "devices (shard_map + all_to_all qubit "
                             "reshards); 0 = single device")
    parser.add_argument("--ensemble", action="store_true",
                        help="enable probabilistic control flow: ProbVal "
                             "conditions on cjmp/halt/retr fork weighted "
                             "execution branches")
    parser.add_argument("--smc", type=int, default=0, metavar="B",
                        help="with --compile --ensemble: run B sampled SMC "
                             "particles (constant memory) instead of the "
                             "exact outcome fan-out; keyed by --seed")
    parser.add_argument("--mesh", type=str, default=None, metavar="PxQ",
                        help="device mesh shape particles x qubit-shards "
                             "for --shard runs (e.g. 2x4); default 1 x 2^K")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    path = _file_path(args.FILE)
    if not os.path.exists(path):
        print(f"File Not Found at Path: \n{path}")
        return 1

    from qbot_tpu.backend import set_backend, set_dtype
    from qbot_tpu.errors import QbotScriptError
    from qbot_tpu.frontend.interpreter import executeFile
    from qbot_tpu.utils.config import EngineConfig, set_runtime_config
    from qbot_tpu.utils.profiling import line_profile_report, profiling_enabled

    set_backend(args.backend)
    set_dtype(args.dtype)
    try:
        set_runtime_config(EngineConfig.from_args(args))
    except ValueError as e:
        print(f"mesh error: {e}", file=sys.stderr)
        return 1
    if args.compile_mode or args.shard:
        # the persistent cache turns repeat compiles into loads
        from qbot_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    if args.precision:
        from qbot_tpu.tpu.dotplan import set_dot_mode

        set_dot_mode(args.precision)

    try:
        if args.compile_mode and args.ensemble:
            # the device ensemble runner: quantum registers live on the
            # device particle axis; ProbVal control flow forks host-side
            # particles that SHARE device arrays; mid-circuit meas/disc fan
            # (or, with --smc, sample) device particles
            from qbot_tpu.frontend.device_ensemble import (
                execute_lines_device_ensemble,
            )
            from qbot_tpu.frontend.interpreter import peek_opcode
            from qbot_tpu.ops.measurement import MeasurementResult

            mesh = None
            if args.shard or args.mesh:
                import jax
                from qbot_tpu.tpu.sharding import make_mesh
                from qbot_tpu.utils.config import (
                    auto_mesh_shape,
                    parse_mesh_shape,
                )
                try:
                    if args.mesh == "auto":
                        # particles-only until device memory forces qubit
                        # shards (utils.config.auto_mesh_shape); the
                        # register width is read off the program's
                        # initial qset when it lowers
                        n_q = None
                        try:
                            from qbot_tpu.frontend.lowering import \
                                lower_program
                            with open(path, "r") as f:
                                n_q = lower_program(f.read(),
                                                    mid_measure=True).n
                        except Exception:
                            pass
                        shape = auto_mesh_shape(len(jax.devices()), n_q)
                        print(f"mesh auto: {shape[0]}x{shape[1]} "
                              f"(particles x qubit-shards)",
                              file=sys.stderr)
                    else:
                        shape = (parse_mesh_shape(args.mesh) if args.mesh
                                 else (1, 2**args.shard))
                    ndev = shape[0] * shape[1]
                    if ndev > len(jax.devices()):
                        raise ValueError(
                            f"mesh {shape[0]}x{shape[1]} needs {ndev} "
                            f"devices, only {len(jax.devices())} available")
                    mesh = make_mesh(shape, devices=jax.devices()[:ndev])
                except ValueError as e:
                    print(f"mesh error: {e}", file=sys.stderr)
                    return 1
            with open(path, "r") as f:
                lines = f.read().splitlines()
            res, particles = execute_lines_device_ensemble(
                lines, sample=args.smc, seed=args.seed, mesh=mesh)
            n_dev = sum(p.qreg.num_particles for p in particles
                        if p.qreg is not None)
            extra = (f", pruned mass <= {res.lost_mass:.3e}"
                     if res.lost_mass > 0 else "")
            print(f"device ensemble: {len(particles)} branches, "
                  f"{n_dev} device particles{extra}", file=sys.stderr)
            # programs that print their own output did so during execution;
            # otherwise show every bound measurement result
            if not any(peek_opcode(l) == "cout" for l in lines):
                for name, val in res.namespace.items():
                    if not name.startswith("__") and isinstance(
                            val, MeasurementResult):
                        print(f"{name}:")
                        print(val, end="")
            return 0
        if args.compile_mode:
            from qbot_tpu.frontend.lowering import lower_program, run_lowered
            with open(path, "r") as f:
                lp = lower_program(f.read())
            from qbot_tpu.tpu.compiler import compile_circuit
            plan = compile_circuit(lp.circuit, window="auto")
            print(f"lowered: {lp.n} qubits, {lp.circuit.gate_count} gates, "
                  f"{plan.num_passes} device passes "
                  f"({plan.engine} engine)", file=sys.stderr)
            if args.shard:
                from qbot_tpu.frontend.lowering import run_lowered_sharded
                mesh = None
                if args.mesh:
                    import jax
                    from qbot_tpu.tpu.sharding import make_mesh
                    from qbot_tpu.utils.config import parse_mesh_shape
                    try:
                        shape = parse_mesh_shape(args.mesh)
                        ndev = shape[0] * shape[1]
                        if ndev > len(jax.devices()):
                            raise ValueError(
                                f"--mesh {args.mesh} needs {ndev} devices, "
                                f"only {len(jax.devices())} available")
                        mesh = make_mesh(shape, devices=jax.devices()[:ndev])
                    except ValueError as e:
                        print(f"mesh error: {e}", file=sys.stderr)
                        return 1
                try:
                    probs, _, splan = run_lowered_sharded(lp, k=args.shard,
                                                          mesh=mesh)
                except ValueError as e:
                    print(f"sharding error: {e}", file=sys.stderr)
                    return 1
                print(f"sharded: 2^{args.shard} devices, "
                      f"{splan.num_reshards} reshards, "
                      f"{splan.comm_bytes()} interconnect bytes/run",
                      file=sys.stderr)
            else:
                probs, _ = run_lowered(lp, window="auto")
            # programs with a classical epilogue print their own output
            # (the epilogue ran inside run_lowered with the result bound);
            # otherwise print the outcome table directly
            if probs is not None and not lp.has_epilogue:
                basis = lp.measure_basis
                m = len(lp.measure_targets) // basis.numQubits
                for i, p in enumerate(probs):
                    syms = ""
                    rem, digs = i, []
                    for _ in range(m):
                        digs.append(rem % len(basis)); rem //= len(basis)
                    for d in reversed(digs):
                        syms += basis.ketSymbols[d]
                    print(f"{syms}- {round(float(p), 15)} "
                          f"({round(float(p) * 100, 13)}%)")
            return 0
        with open(path, "r") as f:
            if args.ensemble:
                from qbot_tpu.frontend.ensemble import executeTxtEnsemble
                runner = lambda: executeTxtEnsemble(f.read())
            else:
                runner = lambda: executeFile(f)
            if args.profile:
                with profiling_enabled():
                    runner()
                print(line_profile_report(), file=sys.stderr)
            else:
                runner()
    except QbotScriptError as e:
        print(str(e))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
