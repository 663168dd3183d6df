"""Device-mesh sharding for amplitude tensors and particle ensembles.

The reference is single-process with no parallelism of any kind
(SURVEY.md §2.4); this module supplies the multi-device scaling plan:

* mesh axes ``("particles", "qubits")`` — the SMC/HMC particle-batch axis is
  pure data parallelism; the amplitude axis shards the 2^n statevector over
  its *major* qubit axes (the tensor-parallel / context-parallel slot).
* Shardings are expressed as ``NamedSharding`` annotations on jit
  boundaries; XLA GSPMD inserts the collectives.  Window-fused matmuls on
  minor qubits are embarrassingly parallel; steps touching sharded major
  qubits lower to all-to-all / collective-permute over ICI automatically
  (the "qubit resharding ≈ Ulysses head-exchange" design, SURVEY §2.4).
* Multi-host: `jax.distributed.initialize` + the same mesh spanning hosts;
  DCN-crossing axes should be the particle axis (weight normalisation is a
  small psum), keeping amplitude reshards on ICI.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "state_sharding", "batched_state_sharding",
           "shard_state", "replicated", "make_sharded_runner"]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: tuple[str, str] = ("particles", "qubits"),
              devices=None) -> Mesh:
    """Build a 2-D (particles × qubits) device mesh.

    Default shape puts all devices on the qubit axis (maximum state size);
    pass e.g. ``(4, 2)`` to trade ensemble width against shard width.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (1, devices.size)
    if int(np.prod(shape)) != devices.size:
        raise ValueError(f"mesh shape {shape} != {devices.size} devices")
    return Mesh(devices.reshape(shape), axis_names)


def state_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a flat (2^n,) statevector over the qubit axis.

    A contiguous block split of the flat vector is exactly a shard of the
    *leading* (most-significant) qubit axes: device d holds amplitudes whose
    top log2(D) qubits encode d.
    """
    return NamedSharding(mesh, P(("particles", "qubits")))


def batched_state_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a (batch, 2^n) particle ensemble of statevectors."""
    return NamedSharding(mesh, P("particles", "qubits"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state(psi: jax.Array, mesh: Mesh) -> jax.Array:
    sharding = (batched_state_sharding(mesh) if psi.ndim == 2
                else state_sharding(mesh))
    return jax.device_put(psi, sharding)


def make_sharded_runner(plan, mesh: Mesh, batched: bool = False):
    """jit a plan executor with explicit in/out shardings on the mesh.

    The executor body is ordinary ``apply_plan``; GSPMD partitions the
    window matmuls and inserts collectives for steps that touch sharded
    qubit axes.
    """
    from qbot_tpu.tpu.simulator import apply_plan

    sharding = batched_state_sharding(mesh) if batched else state_sharding(mesh)

    if batched:
        def body(psi, params):
            return jax.vmap(lambda p: apply_plan(p, plan, params))(psi)
    else:
        def body(psi, params):
            return apply_plan(psi, plan, params)

    return jax.jit(body, in_shardings=(sharding, replicated(mesh)),
                   out_shardings=sharding)
