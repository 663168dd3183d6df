"""Sharded planar executor: statevectors bigger than one card's memory.

The reference is hard-walled at whatever dense matrix fits in one host's RAM
(SURVEY.md §5 "long-context" slot); this module is the multi-device scaling
answer for *pure* states: the ``(2, 2^n)`` planar amplitude tensor is
sharded over the leading ``k = log2(K)`` qubit axes of a K-device mesh axis,
and the program runs under ``shard_map`` with explicit collectives:

* window/pair steps on **local** qubit axes run the single-device planar
  executor per shard — embarrassingly parallel, zero communication;
* steps touching **sharded** qubit axes are preceded by a *qubit reshard*:
  one ``lax.all_to_all`` that exchanges the k device-axis bits with a
  contiguous block of k local qubit axes (the Ulysses-style axis exchange
  of SURVEY.md §2.4) — the compiler tracks the resulting logical→physical
  permutation so later steps target the right axes;
* basis-state flips touch one amplitude on one shard: a masked
  single-element update, no communication;
* readout marginals are per-shard partial sums + ``psum``.

Unlike :func:`qbot_tpu.tpu.sharding.make_sharded_runner` (GSPMD over the
complex executor — fine on CPU meshes), this path uses only planar float32
and explicit collectives.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map as _shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qbot_tpu.tpu.circuit import Circuit, CircuitOp
from qbot_tpu.tpu.compiler import Plan, compile_circuit

__all__ = ["ShardedPlan", "compile_sharded", "splan_cache_key",
           "make_sharded_planar_runner",
           "sharded_zero_state", "sharded_probs_fn", "unpermute_planar",
           "ShardedReflect", "LocalPerm", "BitSwap",
           "plan_reshards_to_localize", "plan_perm_to_identity",
           "apply_bitswap_local",
           "density_circuit", "compile_sharded_density",
           "shard_density", "sharded_zero_density",
           "sharded_density_probs_fn", "sharded_density_discard",
           "unpermute_density"]


@dataclass(frozen=True)
class LocalSegment:
    """A run of ops acting only on local (unsharded) qubit axes, compiled
    to a normal window-fused plan over the n−k local axes."""
    plan: Plan


@dataclass(frozen=True)
class Reshard:
    """Exchange the k sharded axes (physical [0,k)) with local physical
    axes [m, m+k): one all_to_all on the mesh axis."""
    m: int


@dataclass(frozen=True)
class ShardedFlip:
    """Sign-flip of one global basis state: owner shard + local index."""
    owner: int
    local_index: int


@dataclass(frozen=True)
class LocalPerm:
    """Shard-local qubit-axis transpose: new local axis i holds what was
    at local axis ``order[i]``.  Zero communication, one HBM pass — used
    when target localization finds no contiguous free exchange block."""
    order: tuple[int, ...]


@dataclass(frozen=True)
class BitSwap:
    """Exchange ONE sharded axis (device bit ``shard_pos``) with ONE local
    qubit axis: each device keeps the local slice matching its own bit and
    ppermutes the other half to the device differing in that bit — half
    the state crosses the links (vs (K−1)/K for a full Reshard).  The
    primitive that makes ANY layout reachable (full-block all_to_alls can
    never mix the sharded set with the local set in the tight n = 2k
    case)."""
    shard_pos: int
    local_axis: int


@dataclass(frozen=True)
class ShardedReflect:
    """Householder reflection about a product state, sharded.

    ``ψ → ψ − 2⟨v|ψ⟩v`` with ``v = ⊗ single-qubit factors``: the sharded
    axes contribute only a per-device scalar ``s_d = Π v_p[bit_p(d)]``, so
    the whole two-layer+flip sandwich costs ONE psum of a complex scalar —
    a sharded Grover iteration needs zero all_to_alls.

    ``shard_factors``: one complex 2-vector per sharded physical position;
    ``local_factors``: one per local physical axis, in order.
    """
    shard_factors: tuple[np.ndarray, ...]
    local_factors: tuple[np.ndarray, ...]


@dataclass(frozen=True)
class _OpReflect:
    """Op-stream marker produced by reflection detection (internal)."""
    factors: tuple[np.ndarray, ...]      # per LOGICAL qubit, in order
    kind: str = "reflect"
    controls: tuple = ()
    targets: tuple = ()


def _detect_op_reflections(ops, n: int):
    """Replace ``1q-layer · flip(idx) · inverse-1q-layer`` patterns in an op
    stream with :class:`_OpReflect` markers (circuit-level analogue of the
    step-level detection in compile_circuit, done here BEFORE reshard
    scheduling so the layers never touch sharded axes at all).

    Conservative: only uncontrolled static single-qubit layers match.
    """
    out: list = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if op.kind != "flip":
            out.append(op)
            i += 1
            continue
        # layer A: maximal trailing run of distinct-target 1q static gates
        a_map: dict[int, object] = {}
        j = len(out) - 1
        while j >= 0:
            o = out[j]
            if (getattr(o, "kind", None) == "gate" and o.matrix is not None
                    and not o.controls and len(o.targets) == 1
                    and o.targets[0] not in a_map):
                a_map[o.targets[0]] = o
                j -= 1
            else:
                break
        if not a_map:
            out.append(op)
            i += 1
            continue
        # layer B: forward run matching A's supports with inverse matrices
        b_seen: set[int] = set()
        kk = i + 1
        ok = True
        while kk < len(ops) and len(b_seen) < len(a_map):
            o = ops[kk]
            if (o.kind == "gate" and o.matrix is not None and not o.controls
                    and len(o.targets) == 1 and o.targets[0] in a_map
                    and o.targets[0] not in b_seen):
                ma = np.asarray(a_map[o.targets[0]].matrix)
                if not np.allclose(np.asarray(o.matrix), ma.conj().T,
                                   atol=1e-9):
                    ok = False
                    break
                b_seen.add(o.targets[0])
                kk += 1
            else:
                ok = False
                break
        if not (ok and len(b_seen) == len(a_map)):
            out.append(op)
            i += 1
            continue
        idx = op.index
        factors = []
        for q in range(n):
            bit = (idx >> (n - 1 - q)) & 1
            if q in a_map:
                A = np.asarray(a_map[q].matrix, complex)
                factors.append(np.conj(A[bit, :]))
            else:
                e = np.zeros(2, complex)
                e[bit] = 1.0
                factors.append(e)
        del out[j + 1:]                  # consume layer A
        out.append(_OpReflect(tuple(factors)))
        i = kk                           # consume flip + layer B
    return out


@dataclass(frozen=True)
class ShardedDiag:
    """Diagonal unitary whose support touches sharded axes.

    Diagonals factor across shards: each device multiplies by its slice of
    the phase tensor (sharded-position bits come from the device id), so
    NO reshard is needed — a multi-controlled-Z over every qubit is one
    local elementwise pass.  ``positions`` are physical; ``diag`` is the
    phase vector indexed by the bits of ``positions`` in order.
    """
    positions: tuple[int, ...]
    diag: np.ndarray


Item = Union[LocalSegment, Reshard, ShardedFlip, ShardedDiag,
             ShardedReflect, LocalPerm, BitSwap]


@dataclass
class ShardedPlan:
    n: int
    k: int                               # log2(number of shards)
    items: list[Item] = field(default_factory=list)
    # perm[physical_position] = logical qubit, at plan END (for readout)
    final_perm: list[int] = field(default_factory=list)
    num_params: int = 0
    gate_count: int = 0

    @property
    def num_reshards(self) -> int:
        return sum(isinstance(i, (Reshard, BitSwap)) for i in self.items)

    def comm_bytes(self, dtype_bytes: int = 4) -> int:
        """Interconnect traffic per execution: a reshard all_to_all moves
        (K−1)/K of the full planar state across the links; a BitSwap
        ppermute moves exactly half of it."""
        K = 2**self.k
        state = 2 * (2**self.n) * dtype_bytes        # planar (re, im)
        total = 0
        for i in self.items:
            if isinstance(i, Reshard):
                total += state * (K - 1) // K
            elif isinstance(i, BitSwap):
                total += state // 2
        return total

    def hbm_bytes(self, dtype_bytes: int = 4) -> int:
        """Aggregate HBM traffic across shards per execution."""
        state = 2 * (2**self.n) * dtype_bytes
        passes = sum(i.plan.num_passes for i in self.items
                     if isinstance(i, LocalSegment))
        passes += sum(isinstance(i, (Reshard, ShardedDiag, LocalPerm,
                                     BitSwap))
                      for i in self.items)
        passes += 2 * sum(isinstance(i, ShardedReflect)
                          for i in self.items)
        return 2 * state * passes


def _support(op: CircuitOp) -> tuple[int, ...]:
    return tuple(op.controls) + tuple(op.targets)


def splan_cache_key(splan: "ShardedPlan"):
    """Content digest of a ShardedPlan for executor caching, or None when
    the plan is not content-addressable (parameterised gate makers).

    Two structurally-identical plans — e.g. the same program segment
    recompiled on a later run — digest equal, so the ensemble executor
    can reuse its jitted shard_map callable instead of re-tracing every
    segment.  Every behaviourally-relevant field is
    hashed: step geometry, static matrices/diagonals byte-wise, fused
    flips/phases, item parameters, and the plan header.
    """
    import hashlib

    from qbot_tpu.tpu.compiler import plan_cache_key

    h = hashlib.sha1()

    def u(*parts):
        for x in parts:
            h.update(repr(x).encode())
            h.update(b";")

    def arr(a):
        a = np.asarray(a)
        u("A", a.dtype.str, a.shape)
        h.update(a.tobytes())

    u("hdr", splan.n, splan.k, splan.num_params)
    for item in splan.items:
        if isinstance(item, LocalSegment):
            d = plan_cache_key(item.plan)
            if d is None:
                return None
            u("LS")
            h.update(d)
        elif isinstance(item, Reshard):
            u("RS", item.m)
        elif isinstance(item, ShardedFlip):
            u("SF", item.owner, item.local_index)
        elif isinstance(item, ShardedDiag):
            u("SD", item.positions)
            arr(item.diag)
        elif isinstance(item, ShardedReflect):
            u("SR")
            for f in item.shard_factors:
                arr(f)
            u("|")
            for f in item.local_factors:
                arr(f)
        elif isinstance(item, LocalPerm):
            u("LP", item.order)
        elif isinstance(item, BitSwap):
            u("BS", item.shard_pos, item.local_axis)
        else:
            return None
    return h.digest()


def compile_sharded(circ: Circuit, k: int, window: int = 7,
                    initial_perm=None) -> ShardedPlan:
    """Compile a circuit for a 2^k-way sharded register.

    Tracks the logical→physical qubit permutation across reshards.  Ops on
    disjoint qubit sets commute, so when an op touches a sharded axis the
    scheduler first pulls forward every later op that is already local and
    commutes past the blocked ones — a full layer over all n qubits then
    costs exactly ONE all_to_all, not one per blocked op.  The exchange
    block is chosen to evict qubits that no blocked op needs (Belady-style:
    minimise overlap with the pending-front support).

    ``initial_perm``: the state's starting physical→logical permutation
    (a previous plan's ``final_perm``) — lets program segments between
    collapse points compose without restoring logical order in between.
    """
    n = circ.n
    if k < 0 or (k and n - k < k):
        raise ValueError(f"cannot shard {n} qubits {2**k} ways")
    if initial_perm is None:
        pos = list(range(n))             # pos[logical] = physical
        perm = list(range(n))            # perm[physical] = logical
    else:
        perm = list(initial_perm)
        if sorted(perm) != list(range(n)):
            raise ValueError(f"initial_perm {perm} is not a permutation "
                             f"of range({n})")
        pos = [0] * n
        for p, q in enumerate(perm):
            pos[q] = p
    splan = ShardedPlan(n=n, k=k, num_params=circ.num_params,
                        gate_count=circ.gate_count)
    pending = Circuit(n - k)
    pending.num_params = circ.num_params

    def flush():
        nonlocal pending
        if pending.ops:
            splan.items.append(LocalSegment(compile_circuit(pending, window)))
            pending = Circuit(n - k)
            pending.num_params = circ.num_params

    def is_local(op: CircuitOp) -> bool:
        return all(pos[q] >= k for q in _support(op))

    def emit(op: CircuitOp) -> None:
        qubits = _support(op)
        local = [pos[q] - k for q in qubits]
        nc = len(op.controls)
        pending.ops.append(CircuitOp(op.kind, tuple(local[nc:]),
                                     tuple(local[:nc]), op.matrix,
                                     op.param_idx, op.maker, op.index))

    def reshard_for(must_avoid: set[int], prefer_avoid: set[int]) -> None:
        """Exchange sharded axes with a local block disjoint from
        ``must_avoid`` physical positions, minimising ``prefer_avoid``
        overlap (evict qubits the pending front does not need)."""
        best, best_cost = None, None
        for m in range(n - k, k - 1, -1):
            block = set(range(m, m + k))
            if block & must_avoid:
                continue
            cost = len(block & prefer_avoid)
            if best_cost is None or cost < best_cost:
                best, best_cost = m, cost
                if cost == 0:
                    break
        if best is None:
            raise ValueError(
                f"support {sorted(must_avoid)} leaves no free local block "
                f"for resharding ({n} qubits, k={k})")
        flush()
        splan.items.append(Reshard(best))
        for i in range(k):
            a, b = perm[i], perm[best + i]
            perm[i], perm[best + i] = b, a
            pos[a], pos[b] = best + i, i

    def physical_index(logical_index: int) -> int:
        out = 0
        for p in range(n):
            bit = (logical_index >> (n - 1 - perm[p])) & 1
            out |= bit << (n - 1 - p)
        return out

    from qbot_tpu.tpu.compiler import (
        decompose_spanning_swap,
        eigen_decompose_controlled,
        gate_as_diag,
    )

    ops = []
    for op in _detect_op_reflections(list(circ.ops), n):
        if isinstance(op, _OpReflect):
            ops.append(op)
            continue
        dop = gate_as_diag(op)
        ops.append(dop if dop is not None else op)
    emitted = [False] * len(ops)
    i = -1
    while i + 1 < len(ops):
        i += 1
        op = ops[i]
        if emitted[i]:
            continue
        if (not isinstance(op, _OpReflect) and op.kind == "gate"
                and op.matrix is not None and not is_local(op)):
            # algebraic rewrite instead of a reshard: spanning swaps → 3
            # CXs; controlled gates → V†·controlled-diag·V — the diagonal
            # factors across shards (ShardedDiag, zero communication) and
            # the V factors touch only the (usually local) target qubits
            dec = (decompose_spanning_swap(op)
                   or eigen_decompose_controlled(op))
            if dec is not None:
                dec = [gate_as_diag(d) or d for d in dec]
                ops[i:i + 1] = dec
                emitted[i:i + 1] = [False] * len(dec)
                i -= 1
                continue
        if isinstance(op, _OpReflect):
            # map logical factors to physical axes under the current perm
            flush()
            phys = [op.factors[perm[p]] for p in range(n)]
            splan.items.append(ShardedReflect(tuple(phys[:k]),
                                              tuple(phys[k:])))
            emitted[i] = True
            continue
        if op.kind == "flip":
            flush()
            mp = physical_index(op.index)
            splan.items.append(ShardedFlip(mp >> (n - k),
                                           mp & ((1 << (n - k)) - 1)))
            emitted[i] = True
            continue
        if op.kind == "diag" and not is_local(op):
            # diagonals factor across shards: emit in place, no reshard
            flush()
            splan.items.append(ShardedDiag(
                tuple(pos[q] for q in op.targets),
                np.asarray(op.matrix, np.complex128)))
            emitted[i] = True
            continue
        if not is_local(op):
            # pull forward commuting local ops, gathering the blocked front
            barrier = set(_support(op))
            blocked = set(_support(op))
            for j in range(i + 1, len(ops)):
                if emitted[j]:
                    continue
                oj = ops[j]
                if oj.kind in ("flip", "reflect"):   # all-qubit: hard wall
                    break
                sj = set(_support(oj))
                if sj & barrier:
                    barrier |= sj
                    blocked |= sj
                    continue
                if is_local(oj):
                    emit(oj)
                    emitted[j] = True
                else:
                    barrier |= sj
                    blocked |= sj
            must = {pos[q] for q in _support(op)}
            prefer = {pos[q] for q in blocked}
            reshard_for(must, prefer)
            if not is_local(op):         # pragma: no cover - guarded above
                raise AssertionError("reshard failed to localise op")
        emit(op)
        emitted[i] = True
    flush()
    # adjacent sharded diagonals commute: fuse runs into one pass each
    from qbot_tpu.tpu.compiler import combine_diag_vectors
    merged: list[Item] = []
    for item in splan.items:
        if (isinstance(item, ShardedDiag) and merged
                and isinstance(merged[-1], ShardedDiag)):
            prev = merged[-1]
            union = tuple(sorted(set(prev.positions) | set(item.positions)))
            if len(union) <= 12:
                merged[-1] = ShardedDiag(union, combine_diag_vectors(
                    prev.positions, prev.diag, item.positions, item.diag,
                    union))
                continue
        merged.append(item)
    splan.items = merged
    splan.final_perm = list(perm)
    return splan


def plan_reshards_to_localize(perm, n: int, k: int, logical_targets):
    """Reshard items making every target's physical position local (>= k).

    Collapse points (mid-circuit ``meas``/``disc``) need their target
    qubits on local axes so the outcome split is shard-local; ONE
    all_to_all always suffices — exchange the k sharded axes with a local
    block disjoint from the targets' current positions.  Returns
    (items, new_perm).
    """
    perm = list(perm)
    if k == 0:
        return [], perm
    pos = [0] * n
    for p, q in enumerate(perm):
        pos[q] = p
    if all(pos[q] >= k for q in logical_targets):
        return [], perm
    items: list = []
    must = {pos[q] for q in logical_targets}
    best = None
    for m in range(n - k, k - 1, -1):
        if not (set(range(m, m + k)) & must):
            best = m
            break
    if best is None:
        # no contiguous free block: transpose the local axes so local
        # targets sit at the FRONT of the local region, freeing the tail
        # (zero communication, one HBM pass)
        local_t = sorted(p - k for p in must if p >= k)
        if (n - k) - len(local_t) < k:
            raise ValueError(
                f"cannot localize targets {sorted(logical_targets)}: only "
                f"{(n - k) - len(local_t)} non-target local axes for a "
                f"width-{k} exchange block ({n} qubits)")
        order = tuple(local_t
                      + [a for a in range(n - k) if a not in local_t])
        items.append(LocalPerm(order))
        old_local = perm[k:]
        perm[k:] = [old_local[a] for a in order]
        best = n - k
    for i in range(k):
        perm[i], perm[best + i] = perm[best + i], perm[i]
    items.append(Reshard(best))
    return items, perm


def apply_bitswap_local(psi, item: BitSwap, n_local: int, k: int,
                        q_axis: str):
    """Apply a BitSwap to a shard-local planar block.

    ``psi``: (..., 2, 2^n_local) with any leading batch dims.  Each device
    keeps the local-axis slice equal to its own bit of ``shard_pos`` and
    receives the complementary slice from the device differing in that
    bit.
    """
    a = item.local_axis
    pre = 2**a
    post = 2 ** (n_local - a - 1)
    lead = psi.shape[:-1]
    t = psi.reshape(lead + (pre, 2, post))
    ax = len(lead) + 1
    dev = jax.lax.axis_index(q_axis)
    bit = (dev >> (k - 1 - item.shard_pos)) & 1
    keep = jnp.take(t, bit, axis=ax)
    send = jnp.take(t, 1 - bit, axis=ax)
    K = 2**k
    mask = 1 << (k - 1 - item.shard_pos)
    recv = jax.lax.ppermute(send, q_axis,
                            perm=[(d, d ^ mask) for d in range(K)])
    cond = (bit == 0)
    s0 = jnp.where(cond, keep, recv)
    s1 = jnp.where(cond, recv, keep)
    out = jnp.stack([s0, s1], axis=ax)
    return out.reshape(psi.shape)


def plan_perm_to_identity(perm, n: int, k: int):
    """Layout items restoring logical qubit order (perm → identity).

    BitSwaps place each of logical 0..k-1 at its sharded slot (evicting a
    mis-sharded occupant to a local axis first when needed), then one
    LocalPerm sorts the local region.  Any layout is reachable — the
    full-block all_to_all alone cannot mix the sharded set with the local
    set in the tight n = 2k case.  Used by per-op executors (the sharded
    device-ensemble engine) that keep a canonical identity layout so
    branch ensembles stay concatenable.  Returns (items, identity perm).
    """
    perm = list(perm)
    items: list = []
    for p in range(k):
        if perm[p] == p:
            continue
        pos = perm.index(p)
        if pos < k:
            # logical p is sharded at the wrong slot: evict to local axis 0
            items.append(BitSwap(pos, 0))
            perm[pos], perm[k] = perm[k], perm[pos]
            pos = k
        items.append(BitSwap(p, pos - k))
        perm[p], perm[pos] = perm[pos], perm[p]
    cur = perm[k:]
    target = sorted(cur)
    order = [cur.index(q) for q in target]
    if order != list(range(n - k)):
        items.append(LocalPerm(tuple(order)))
        perm[k:] = target
    return items, perm


def unpermute_planar(psi, perm) -> jnp.ndarray:
    """Restore logical qubit order of a (2, 2^n) planar state whose axis p
    holds logical qubit ``perm[p]`` (the runner's output layout,
    ``splan.final_perm``).

    This is a full-state transpose — use it for host-side inspection and
    conformance checks; production readout should go through
    :func:`sharded_probs_fn`, which handles the permutation shard-locally.
    """
    n = len(perm)
    pos = [0] * n
    for p, q in enumerate(perm):
        pos[q] = p
    t = jnp.asarray(psi).reshape((2,) + (2,) * n)
    t = jnp.transpose(t, (0,) + tuple(1 + pos[q] for q in range(n)))
    return t.reshape(2, -1)


def sharded_zero_state(n: int, mesh: Mesh, axis_name: str = "qubits",
                       dtype=jnp.float32) -> jax.Array:
    """|0…0⟩ as a planar (2, 2^n) array sharded over ``axis_name``."""
    psi = jnp.zeros((2, 2**n), dtype=dtype).at[0, 0].set(1.0)
    return jax.device_put(psi, NamedSharding(mesh, P(None, axis_name)))


def make_sharded_planar_runner(splan: ShardedPlan, mesh: Mesh,
                               axis_name: str = "qubits"):
    """jit a shard_map executor for a ShardedPlan.

    Returns ``run(psi_sharded, params=None) -> psi_sharded``.
    """
    from qbot_tpu.tpu.planar import apply_plan_planar

    n, k = splan.n, splan.k
    K = 2**k
    if np.prod([mesh.shape[a] for a in (axis_name,)]) != K:
        raise ValueError(f"mesh axis {axis_name!r} size != {K}")
    n_local = n - k

    def apply_sharded_diag(psi, item: ShardedDiag):
        """Elementwise multiply by this shard's slice of the phase tensor."""
        S = len(item.positions)
        dev = jax.lax.axis_index(axis_name)
        dr = jnp.asarray(item.diag.real.reshape((2,) * S), psi.dtype)
        di = jnp.asarray(item.diag.imag.reshape((2,) * S), psi.dtype)
        # contract the sharded-position axes with the device-id bits
        # (descending axis order keeps earlier axis numbers valid)
        local_axes = []                  # local axis per remaining dr axis
        for ax in range(S - 1, -1, -1):
            p = item.positions[ax]
            if p < k:
                bit = (dev >> (k - 1 - p)) & 1
                dr = jnp.take(dr, bit, axis=ax)
                di = jnp.take(di, bit, axis=ax)
            else:
                local_axes.append(p - k)
        local_axes.reverse()             # now in dr-axis order
        order = list(np.argsort(local_axes))
        if local_axes:
            dr = jnp.transpose(dr, order)
            di = jnp.transpose(di, order)
        shape = [1] * n_local
        for a in local_axes:
            shape[a] = 2
        dr = dr.reshape(shape)
        di = di.reshape(shape)
        if n_local >= 14:
            # broadcast the diag factors to the (F, S, L) carrier so no
            # array takes the rank-n (2,)*n shape (see ensemble_exec)
            from qbot_tpu.inference.ensemble_exec import _carrier

            F, S, L = _carrier(n_local)
            drc = jnp.broadcast_to(dr, (2,) * n_local).reshape(F, S, L)
            dic = jnp.broadcast_to(di, (2,) * n_local).reshape(F, S, L)
            t = psi.reshape(2, F, S, L)
            pr, pi = t[0], t[1]
            out_r = drc * pr - dic * pi
            out_i = drc * pi + dic * pr
            return jnp.stack([out_r, out_i]).reshape(psi.shape)
        t = psi.reshape((2,) + (2,) * n_local)
        pr, pi = t[0], t[1]
        out_r = dr * pr - di * pi
        out_i = dr * pi + di * pr
        return jnp.stack([out_r, out_i]).reshape(psi.shape)

    def apply_sharded_reflect(psi, item: ShardedReflect):
        """ψ → ψ − 2⟨v|ψ⟩v with product v: local contractions + ONE scalar
        psum.  Sharded axes enter only through the per-device coefficient
        s_d = Π v_p[bit_p(d)]; v on device d is s_d · (⊗ local factors)."""
        dev = jax.lax.axis_index(axis_name)
        # s_d (complex, planar scalars)
        sr = jnp.asarray(1.0, psi.dtype)
        si = jnp.asarray(0.0, psi.dtype)
        for p, f in enumerate(item.shard_factors):
            bit = (dev >> (k - 1 - p)) & 1
            fr = jnp.asarray(np.real(f), psi.dtype)[bit]
            fi = jnp.asarray(np.imag(f), psi.dtype)[bit]
            sr, si = sr * fr - si * fi, sr * fi + si * fr

        # local ⟨v_local|ψ_local⟩ via the stacked planar einsum chain
        t = psi
        for f in item.local_factors:
            fr = jnp.asarray(np.real(f), psi.dtype)
            fi = jnp.asarray(np.imag(f), psi.dtype)
            W = jnp.stack([jnp.stack([fr, fi]), jnp.stack([-fi, fr])])
            t = jnp.einsum("acx,cxr->ar", W, t.reshape(2, 2, -1),
                           precision=jax.lax.Precision.HIGHEST)
        cr, ci = t[0, 0], t[1, 0]
        # global c = psum(conj(s_d) · c_d)
        gr = jax.lax.psum(sr * cr + si * ci, axis_name)
        gi = jax.lax.psum(sr * ci - si * cr, axis_name)

        # V_local broadcast product
        nl = len(item.local_factors)
        vr = jnp.asarray(1.0, psi.dtype)
        vi = jnp.asarray(0.0, psi.dtype)
        for ax, f in enumerate(item.local_factors):
            shape = [1] * nl
            shape[ax] = 2
            br = jnp.asarray(np.real(f), psi.dtype).reshape(shape)
            bi = jnp.asarray(np.imag(f), psi.dtype).reshape(shape)
            vr, vi = vr * br - vi * bi, vr * bi + vi * br
        # coefficient 2·c·s_d applied to V_local
        ar = 2.0 * (gr * sr - gi * si)
        ai = 2.0 * (gr * si + gi * sr)
        tshape = (2,) * nl
        pr = psi[0].reshape(tshape)
        pi = psi[1].reshape(tshape)
        out_r = pr - (ar * vr - ai * vi)
        out_i = pi - (ar * vi + ai * vr)
        return jnp.stack([out_r.reshape(-1), out_i.reshape(-1)])

    def body(psi, params):
        # psi: local planar (2, 2^(n-k))
        for item in splan.items:
            if isinstance(item, LocalSegment):
                psi = apply_plan_planar(psi, item.plan, params)
            elif isinstance(item, ShardedReflect):
                psi = apply_sharded_reflect(psi, item)
            elif isinstance(item, ShardedFlip):
                here = jax.lax.axis_index(axis_name) == item.owner
                sign = jnp.where(here, -1.0, 1.0).astype(psi.dtype)
                psi = psi.at[:, item.local_index].multiply(sign)
            elif isinstance(item, ShardedDiag):
                psi = apply_sharded_diag(psi, item)
            elif isinstance(item, LocalPerm):
                t = psi.reshape((2,) + (2,) * n_local)
                t = jnp.transpose(t, (0,) + tuple(1 + a for a in item.order))
                psi = t.reshape(psi.shape)
            elif isinstance(item, BitSwap):
                psi = apply_bitswap_local(psi, item, n_local, k, axis_name)
            else:                        # Reshard
                pre = 2 ** (item.m - k)
                post = 2 ** (n - item.m - k)
                t = psi.reshape(2, pre, K, post)
                t = jax.lax.all_to_all(t, axis_name, split_axis=2,
                                       concat_axis=2, tiled=True)
                psi = t.reshape(2, 2**n_local)
        return psi

    mapped = _shard_map(body, mesh=mesh,
                        in_specs=(P(None, axis_name), P()),
                        out_specs=P(None, axis_name))

    @jax.jit
    def run(psi, params=None):
        if params is None:
            params = jnp.zeros((max(splan.num_params, 1),), psi.dtype)
        return mapped(psi, params)

    return run


# ---------------------------------------------------------------------------
# sharded density-matrix execution
#
# The reference's one-and-only state representation is a density matrix with
# every op defined on it (/root/reference/qbot/qgates.py:278-279,
# density.py:7-240); mixed states therefore must scale past one chip too.
# A planar ρ of shape (2, 2^n, 2^n), viewed flat as a planar "statevector"
# over 2n qubit axes, turns every n-qubit op into a pair of 2n-register ops:
# U on the ROW axes [0, n) and conj(U) on the COLUMN axes [n, 2n) — exactly
# how the single-chip executor works (tpu/planar.py:414-460).  So the whole
# sharded machinery above (reshard scheduling, window fusion, ShardedDiag)
# applies verbatim: compile the doubled circuit for a register of 2n qubits
# and shard its leading k row axes over the mesh.
# ---------------------------------------------------------------------------

def density_circuit(circ: Circuit) -> Circuit:
    """Map an n-qubit circuit to its 2n-qubit row/column program on ρ.

    ``gate U`` → U on rows, conj(U) on columns; ``diag d`` → d on rows,
    conj(d) on columns; ``flip m`` (ρ → FρF, F = I − 2|m⟩⟨m|) → a ±1 diag
    over the n row axes and the same over the n column axes (a flip of one
    n-qubit basis state touches a full row and column of ρ, so it is a
    diagonal over the half-register, not a single 2n-register amplitude).
    """
    from qbot_tpu.tpu.planar import _conj_maker

    n = circ.n
    out = Circuit(2 * n)
    out.num_params = circ.num_params
    for op in circ.ops:
        rows = tuple(op.targets)
        cols = tuple(n + q for q in op.targets)
        crows = tuple(op.controls)
        ccols = tuple(n + q for q in op.controls)
        if op.kind == "gate":
            if op.matrix is not None:
                out.gate(op.matrix, rows, crows)
                out.gate(np.conj(np.asarray(op.matrix)), cols, ccols)
            else:
                out.param_gate(op.maker, rows, crows, param_idx=op.param_idx)
                out.param_gate(_conj_maker(op.maker), cols, ccols,
                               param_idx=op.param_idx)
        elif op.kind == "diag":
            out.diagonal(np.asarray(op.matrix), rows)
            out.diagonal(np.conj(np.asarray(op.matrix)), cols)
        elif op.kind == "flip":
            vec = np.ones(2**n, np.complex128)
            vec[op.index] = -1.0
            out.diagonal(vec, tuple(range(n)))
            out.diagonal(vec, tuple(range(n, 2 * n)))
        else:  # pragma: no cover - circuit IR has no other kinds
            raise ValueError(f"unknown op kind {op.kind!r}")
    return out


def compile_sharded_density(circ: Circuit, k: int, window: int = 7
                            ) -> ShardedPlan:
    """Compile an n-qubit circuit for a 2^k-way sharded planar ρ.

    The returned plan runs through the ordinary
    :func:`make_sharded_planar_runner` on the flat (2, 4^n) view of ρ.
    """
    return compile_sharded(density_circuit(circ), k, window=window)


def shard_density(rho_planar, mesh: Mesh, axis_name: str = "qubits"
                  ) -> jax.Array:
    """Place a planar (2, 2^n, 2^n) ρ on the mesh, sharded over its leading
    row-qubit axes, flattened to the runner's (2, 4^n) layout."""
    flat = jnp.asarray(rho_planar).reshape(2, -1)
    return jax.device_put(flat, NamedSharding(mesh, P(None, axis_name)))


def sharded_zero_density(n: int, mesh: Mesh, axis_name: str = "qubits",
                         dtype=jnp.float32) -> jax.Array:
    """|0…0⟩⟨0…0| as a sharded flat planar (2, 4^n) array."""
    return sharded_zero_state(2 * n, mesh, axis_name, dtype)


def unpermute_density(rho_flat, perm) -> jnp.ndarray:
    """Restore a runner-output flat planar ρ to logical (2, 2^n, 2^n)."""
    n = len(perm) // 2
    flat = unpermute_planar(rho_flat, perm)
    return flat.reshape(2, 2**n, 2**n)


def sharded_density_discard(rho_flat, n: int, k: int, targets,
                            mesh: Mesh, perm=None,
                            axis_name: str = "qubits"):
    """``disc`` on a sharded density matrix: Tr over ``targets`` producing
    the REDUCED sharded ρ (register shrinks) — the density-mode sharded
    partial trace (reference semantics /root/reference/qbot/density.py:
    122-148 at sizes one chip cannot hold).

    ``rho_flat``: flat planar (2, 4^n) register-doubled ρ in the layout
    ``perm`` (a density plan's ``final_perm`` over 2n axes; identity if
    None).  Each discarded qubit q contracts its row axis q with its
    column axis n+q: both are first localized (one all_to_all covers all
    of them), then the per-shard diagonal sum drops two axes per qubit.
    Returns (reduced_flat_rho, new_perm) with new_perm over 2(n−t) axes
    in the reduced register's logical numbering.
    """
    targets = sorted(set(int(q) for q in targets))
    t = len(targets)
    n2 = 2 * n
    perm = list(range(n2)) if perm is None else list(perm)
    pair_axes = [q for q in targets] + [n + q for q in targets]
    items, perm = plan_reshards_to_localize(perm, n2, k, pair_axes)
    if items:
        splan = ShardedPlan(n=n2, k=k, items=items, final_perm=perm)
        run = make_sharded_planar_runner(splan, mesh, axis_name)
        rho_flat = run(rho_flat)
    pos = [0] * n2
    for p, q in enumerate(perm):
        pos[q] = p
    n_local = n2 - k

    def body(flat):
        tt = flat.reshape((2,) + (2,) * n_local)
        tags = list(range(k, n2))        # physical position per tensor axis
        for q in targets:
            ar = tags.index(pos[q])
            ac = tags.index(pos[n + q])
            tt = jnp.trace(tt, axis1=1 + ar, axis2=1 + ac)
            del tags[max(ar, ac)], tags[min(ar, ac)]
        return tt.reshape(2, -1)

    mapped = _shard_map(body, mesh=mesh,
                        in_specs=(P(None, axis_name),),
                        out_specs=P(None, axis_name))
    reduced = jax.jit(mapped)(rho_flat)

    # the reduced register renumbers: logical row q → q' = q − #targets<q,
    # column n+q → (n−t)+q'; physical axes = sharded positions then the
    # surviving local axes in order
    removed_phys = {pos[q] for q in targets} | {pos[n + q] for q in targets}

    def relabel(q):
        if q < n:                        # row axis
            return q - sum(1 for r in targets if r < q)
        qq = q - n
        return (n - t) + qq - sum(1 for r in targets if r < qq)

    new_perm = [relabel(q) for p, q in enumerate(perm)
                if p not in removed_phys]
    return reduced, new_perm


def sharded_density_probs_fn(splan: ShardedPlan, mesh: Mesh,
                             targets=None, axis_name: str = "qubits"):
    """jit a density readout: marginal computation-basis probabilities of
    logical ``targets`` (the diagonal of the reduced ρ), replicated.

    ``splan`` is a density plan over 2n axes (``compile_sharded_density``);
    logical qubit q lives at the physical positions of axes q (row) and
    n+q (column) under ``splan.final_perm``.  Per shard: qubit pairs are
    diagonal-extracted (kept targets) or traced (the rest), axis by axis;
    pairs with a sharded side select on device-id bits, and a both-sharded
    pair contributes only on shards whose two bits agree.  Shard results
    scatter at their device-bit offsets and a psum assembles the marginal.
    """
    n2, k = splan.n, splan.k
    n = n2 // 2
    perm = splan.final_perm
    pos = [0] * n2
    for p, q in enumerate(perm):
        pos[q] = p
    targets = list(range(n)) if targets is None else sorted(targets)
    keep = set(targets)

    def body(rho):
        # diagonal of Hermitian ρ is real: only the planar real part matters
        t = rho[0].reshape((2,) * (n2 - k))
        dev = jax.lax.axis_index(axis_name)
        # tags[i] names what tensor axis i currently holds
        tags: list = [("local", p) for p in range(k, n2)]

        def axis_of(p):
            return tags.index(("local", p))

        def dev_bit(p):
            return (dev >> (k - 1 - p)) & 1

        mask = jnp.ones((), t.dtype)
        offset = jnp.zeros((), jnp.int32)
        out_bits = len(targets)
        for q in range(n):
            pr, pc = pos[q], pos[n + q]
            weight = (1 << (out_bits - 1 - targets.index(q))
                      if q in keep else 0)
            if pr >= k and pc >= k:
                ar, ac = axis_of(pr), axis_of(pc)
                if q in keep:
                    t = jnp.diagonal(t, axis1=ar, axis2=ac)
                    del tags[max(ar, ac)], tags[min(ar, ac)]
                    tags.append(("q", q))
                else:
                    t = jnp.trace(t, axis1=ar, axis2=ac)
                    del tags[max(ar, ac)], tags[min(ar, ac)]
            elif pr < k and pc < k:
                br, bc = dev_bit(pr), dev_bit(pc)
                mask = mask * (br == bc).astype(t.dtype)
                if q in keep:
                    offset = offset + br.astype(jnp.int32) * weight
            else:
                shard_p, local_p = (pr, pc) if pr < k else (pc, pr)
                bit = dev_bit(shard_p)
                a = axis_of(local_p)
                t = jnp.take(t, bit, axis=a)
                del tags[a]
                if q in keep:
                    offset = offset + bit.astype(jnp.int32) * weight

        # remaining axes are kept qubits in tag order; flatten with the
        # output weights via index arithmetic (mirrors sharded_probs_fn)
        flat = t.reshape(-1) * mask
        idx = jnp.zeros(flat.shape, jnp.int32)
        if tags:
            coords = jnp.unravel_index(jnp.arange(flat.shape[0]), t.shape)
            for rank, (_, q) in enumerate(tags):
                weight = 1 << (out_bits - 1 - targets.index(q))
                idx = idx + coords[rank].astype(jnp.int32) * weight
        out = jnp.zeros((2**out_bits,), flat.dtype)
        out = out.at[offset + idx].add(flat)
        return jax.lax.psum(out, axis_name)

    mapped = _shard_map(body, mesh=mesh,
                        in_specs=(P(None, axis_name),),
                        out_specs=P())
    return jax.jit(mapped)


def sharded_probs_fn(splan: ShardedPlan, mesh: Mesh,
                     targets=None, axis_name: str = "qubits"):
    """jit a readout: marginal computation-basis probabilities of logical
    ``targets`` (all qubits if None), replicated on every device.

    Handles targets living on sharded axes: each shard scatters its partial
    marginal at the offset encoded by its device-id bits, then a psum
    assembles the full distribution.
    """
    n, k = splan.n, splan.k
    perm = splan.final_perm
    pos = [0] * n
    for p, q in enumerate(perm):
        pos[q] = p
    targets = list(range(n)) if targets is None else sorted(targets)
    phys = [pos[q] for q in targets]     # physical axis per logical target

    def body(psi):
        p2 = (psi[0] ** 2 + psi[1] ** 2).reshape((2,) * (n - k))
        local_axes = [p - k for p in phys if p >= k]
        keep = sorted(local_axes)
        drop = tuple(a for a in range(n - k) if a not in keep)
        marg = jnp.sum(p2, axis=drop) if drop else p2
        # marg axes are the kept local axes in physical order; reorder to
        # follow the logical target order, sharded target bits first-class
        dev = jax.lax.axis_index(axis_name)
        out_bits = len(targets)
        # position of each target's bit in the output index (MSB first)
        local_rank = {a: i for i, a in enumerate(keep)}
        # build the replicated output by scattering this shard's block
        offset = jnp.zeros((), jnp.int32)
        stride = []
        for bit_i, (q, p) in enumerate(zip(targets, phys)):
            weight = 1 << (out_bits - 1 - bit_i)
            if p < k:                    # sharded: bit comes from device id
                bit = (dev >> (k - 1 - p)) & 1
                offset = offset + bit.astype(jnp.int32) * weight
            else:
                stride.append((local_rank[p - k], weight))
        # flatten marg with arbitrary per-axis weights via index arithmetic
        flat = marg.reshape(-1)
        m_axes = len(keep)
        idx = jnp.zeros(flat.shape, jnp.int32)
        if m_axes:
            coords = jnp.unravel_index(jnp.arange(flat.shape[0]),
                                       marg.shape)
            for rank, weight in stride:
                idx = idx + coords[rank].astype(jnp.int32) * weight
        out = jnp.zeros((2**out_bits,), flat.dtype)
        out = out.at[offset + idx].add(flat)
        return jax.lax.psum(out, axis_name)

    mapped = _shard_map(body, mesh=mesh,
                        in_specs=(P(None, axis_name),),
                        out_specs=P())
    return jax.jit(mapped)
