"""Engine configuration (SURVEY.md §5 config/flag plan).

One dataclass consumed by the CLI and embedders; the reference's only
configuration was the positional FILE argument (cli.py:43-48).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def device_memory_budget(device=None) -> float:
    """Half the memory the device lets JAX allocate (``bytes_limit``),
    leaving the other half for the fan-out working set.

    Raises ValueError when the device reports no limit: the budget is
    never assumed for a device the code does not know.
    """
    if device is None:
        import jax

        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        raise ValueError(
            f"device {device.device_kind!r} reports no memory limit; "
            f"pass --mesh PxQ explicitly")
    return limit / 2


def auto_mesh_shape(n_devices: int, n_qubits=None,
                    hbm_budget_bytes: Optional[float] = None
                    ) -> tuple[int, int]:
    """The ``--mesh auto`` policy: particles-only until the register
    forces qubit sharding.

    SMC on the particle axis needs no communication, while qubit shards
    add localization all_to_alls at every collapse — so the qubit axis is
    engaged only when a single device cannot hold the planar register
    (2·2^n·4 bytes) within ``hbm_budget_bytes`` (default:
    :func:`device_memory_budget` of the first device).  Returns
    (particles, qubit_shards) with qubit_shards the smallest power of two
    that fits the register.
    """
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    if n_qubits is None:
        return (n_devices, 1)
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_memory_budget()
    state = 2.0 * (2 ** n_qubits) * 4
    q = 1
    while state / q > hbm_budget_bytes and q < n_devices:
        q *= 2
    return (max(n_devices // q, 1), q)


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """Parse and validate a ``--mesh PxQ`` value (particles x qubit-shards).

    Raises ValueError with a rendered message on any malformed value —
    wrong factor count, non-integers, non-positive sizes, or a qubit axis
    that is not a power of two (shard counts are always 2^k).
    """
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(
            f"--mesh expects exactly two factors PxQ (particles x "
            f"qubit-shards), got {spec!r} with {len(parts)} factor(s)")
    try:
        shape = tuple(int(x) for x in parts)
    except ValueError:
        raise ValueError(
            f"--mesh factors must be integers, got {spec!r}") from None
    if any(s < 1 for s in shape):
        raise ValueError(f"--mesh factors must be >= 1, got {spec!r}")
    if shape[1] & (shape[1] - 1):
        raise ValueError(
            f"--mesh qubit-shard axis must be a power of two, got "
            f"{shape[1]} (from {spec!r})")
    return shape


@dataclass
class EngineConfig:
    backend: str = "numpy"          # numpy | jax
    dtype: Optional[str] = None     # c64 | c128 (None = backend default)
    seed: int = 0                   # PRNG seed for SMC/HMC layers
    window: int = 7                 # fusion window width (2^w <= MXU tile)
    mesh_shape: Optional[tuple[int, int]] = None   # (particles, qubits)
    profile: bool = False

    smc_particles: int = 0          # >0: sampled SMC measurements (CLI --smc)

    @staticmethod
    def from_args(args) -> "EngineConfig":
        mesh = None
        mesh_str = getattr(args, "mesh", None)
        if mesh_str and mesh_str != "auto":
            # "auto" resolves later, once the register width is known
            # (auto_mesh_shape); it is not a static PxQ shape
            mesh = parse_mesh_shape(mesh_str)
        return EngineConfig(
            backend=getattr(args, "backend", "numpy"),
            dtype=getattr(args, "dtype", None),
            seed=getattr(args, "seed", 0),
            mesh_shape=mesh,
            profile=getattr(args, "profile", False),
            smc_particles=getattr(args, "smc", 0),
        )


_RUNTIME = EngineConfig()


def set_runtime_config(cfg: EngineConfig) -> None:
    """Install the process-wide engine configuration (set by the CLI)."""
    global _RUNTIME
    _RUNTIME = cfg


def runtime_config() -> EngineConfig:
    return _RUNTIME
