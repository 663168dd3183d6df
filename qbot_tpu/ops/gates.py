"""Gate constructors.

Capability parity with the reference's ``qbot/qgates.py`` constructors
(/root/reference/qbot/qgates.py:18-275): identity, Simon/Deutsch oracle,
axis rotations, QFT, qubit swap, arbitrary basis-state permutation, cyclic
shift, embedding into a larger register, and (multi-)controlled gates.

Design differences from the reference:

* Every constructor is vectorised (index arithmetic on ``arange`` arrays)
  instead of Python double loops.
* Permutation gates are built directly from an index map over basis states —
  one scatter — rather than block-by-block bitmask surgery
  (cf. qgates.py:77-133).
* ``embed``/``controlled``/``multi_controlled`` produce *matrices* only for
  API compatibility and small registers; the engine applies gates by axis
  contraction (:mod:`qbot_tpu.ops.core`) and never needs full-space
  operators.
* Rotation constructors accept JAX tracers, so parameterised circuits can be
  differentiated / vmapped for the HMC layer.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from qbot_tpu.helpers import int_log2, nth_roots_of_unity, require_square

__all__ = [
    "identity",
    "hadamard",
    "pauli_x",
    "pauli_y",
    "pauli_z",
    "rot_x",
    "rot_y",
    "rot_z",
    "phase",
    "qft",
    "simons_oracle",
    "swap_qubits",
    "permutation_gate",
    "shift_gate",
    "embed",
    "controlled",
    "multi_controlled",
    "check_gate",
]

_C = np.complex128

HADAMARD = 2 ** (-0.5) * np.array([[1, 1], [1, -1]], dtype=_C)
PAULI_X = np.array([[0, 1], [1, 0]], dtype=_C)
PAULI_Y = np.array([[0, -1j], [1j, 0]], dtype=_C)
PAULI_Z = np.array([[1, 0], [0, -1]], dtype=_C)


def identity(num_qubits: int) -> np.ndarray:
    return np.eye(2**num_qubits, dtype=_C)


def hadamard() -> np.ndarray:
    return HADAMARD.copy()


def pauli_x() -> np.ndarray:
    return PAULI_X.copy()


def pauli_y() -> np.ndarray:
    return PAULI_Y.copy()


def pauli_z() -> np.ndarray:
    return PAULI_Z.copy()


def rot_x(theta, xp=np):
    """exp(-i θ X / 2); accepts JAX tracers when xp is jax.numpy."""
    c, s = xp.cos(theta / 2), xp.sin(theta / 2)
    row0 = xp.stack([c + 0j, -1j * s])
    row1 = xp.stack([-1j * s, c + 0j])
    return xp.stack([row0, row1])


def rot_y(theta, xp=np):
    c, s = xp.cos(theta / 2), xp.sin(theta / 2)
    row0 = xp.stack([c + 0j, -s + 0j])
    row1 = xp.stack([s + 0j, c + 0j])
    return xp.stack([row0, row1])


def rot_z(theta, xp=np):
    e = xp.exp(-1j * theta / 2)
    zero = xp.zeros_like(e)
    return xp.stack([xp.stack([e, zero]), xp.stack([zero, xp.conj(e)])])


def rot_planar(axis: str, theta, xp=np):
    """Planar (stacked real/imag) rotation matrix: shape (2, 2, 2).

    Parameterised gates built inside jit return (re, im) stacked on the
    leading axis; the complex executors recombine, the planar executors
    use it directly.
    """
    c, s = xp.cos(theta / 2), xp.sin(theta / 2)
    z = xp.zeros_like(c)
    if axis == "x":
        re = xp.stack([xp.stack([c, z]), xp.stack([z, c])])
        im = xp.stack([xp.stack([z, -s]), xp.stack([-s, z])])
    elif axis == "y":
        re = xp.stack([xp.stack([c, -s]), xp.stack([s, c])])
        im = xp.stack([xp.stack([z, z]), xp.stack([z, z])])
    elif axis == "z":
        re = xp.stack([xp.stack([c, z]), xp.stack([z, c])])
        im = xp.stack([xp.stack([-s, z]), xp.stack([z, s])])
    else:
        raise ValueError(f"unknown rotation axis {axis!r}")
    return xp.stack([re, im])


def phase(theta, xp=np):
    one = xp.ones((), dtype=complex)
    zero = xp.zeros((), dtype=complex)
    return xp.stack([xp.stack([one, zero]), xp.stack([zero, xp.exp(1j * theta)])])


def qft(num_qubits: int) -> np.ndarray:
    """Quantum Fourier transform matrix, ω^(jk)/√N via one outer product."""
    size = 2**num_qubits
    roots = nth_roots_of_unity(size) / np.sqrt(size)
    jk = np.outer(np.arange(size), np.arange(size)) % size
    return roots[jk]


def simons_oracle(num_qubits: int, f: Callable[[int], int]) -> np.ndarray:
    """U_f: |x⟩|b⟩ → |x⟩|b ⊕ f(x)⟩ with a single ancilla qubit.

    ``f`` is an arbitrary Python callable, so it is evaluated once per input
    value (2^(n-1) calls), then the permutation matrix is built in one shot.
    """
    size = 2**num_qubits
    x = np.arange(size) >> 1
    b = np.arange(size) & 1
    fx = np.array([int(f(int(v))) for v in x])
    dest = (x << 1) + ((fx + b) % 2)
    out = np.zeros((size, size), dtype=_C)
    out[np.arange(size), dest] = 1
    return out


def _perm_from_index_map(size: int, dest: np.ndarray) -> np.ndarray:
    """Unitary permutation P with P|i⟩ = |dest[i]⟩."""
    out = np.zeros((size, size), dtype=_C)
    out[dest, np.arange(size)] = 1
    return out


def permutation_gate(hilbert_dim: int, state_map: Callable[[int], int]) -> np.ndarray:
    """Arbitrary basis-state permutation from a Python index map."""
    dest = np.array([int(state_map(i)) for i in range(hilbert_dim)])
    return _perm_from_index_map(hilbert_dim, dest)


def swap_qubits(num_qubits: int, q1: int, q2: int) -> np.ndarray:
    """Full-register matrix exchanging qubits q1 and q2 (vectorised bit swap)."""
    size = 2**num_qubits
    if q1 == q2:
        return np.eye(size, dtype=_C)
    if not (0 <= q1 < num_qubits and 0 <= q2 < num_qubits):
        raise ValueError(f"swap qubits {q1},{q2} out of range for {num_qubits} qubits")
    i = np.arange(size)
    b1 = (i >> (num_qubits - 1 - q1)) & 1
    b2 = (i >> (num_qubits - 1 - q2)) & 1
    toggle = (b1 ^ b2) * ((1 << (num_qubits - 1 - q1)) | (1 << (num_qubits - 1 - q2)))
    return _perm_from_index_map(size, i ^ toggle)


def shift_gate(num_qubits: int, up: bool = True, num_shifts: int = 1) -> np.ndarray:
    """Cyclically shift all qubit rails up or down by ``num_shifts``.

    Shifting up maps rail 0 → last, rail 1 → 0, etc. (reference semantics,
    qgates.py:144-158), i.e. a cyclic rotation of the basis-state bits.
    """
    size = 2**num_qubits
    k = num_shifts % num_qubits if num_qubits else 0
    i = np.arange(size)
    if up:
        dest = ((i << k) % size) | ((i << k) // size)
    else:
        dest = (i >> k) | ((i & ((1 << k) - 1)) << (num_qubits - k))
    return _perm_from_index_map(size, dest)


def check_gate(gate: np.ndarray) -> int:
    """Validate a gate is square with power-of-two size; return the size."""
    size = require_square(gate)
    if size & (size - 1) != 0:
        raise ValueError("gate size must be a power of 2")
    return size


def embed(num_qubits: int, first_target: int, gate: np.ndarray) -> np.ndarray:
    """I ⊗ G ⊗ I embedding of a k-qubit gate into an n-qubit register."""
    size = check_gate(gate)
    k = int_log2(size)
    if first_target + k > num_qubits:
        raise IndexError(
            f"{k} qubit gate does not fit the {num_qubits} qubit hilbertspace "
            f"when started on qubit {first_target}"
        )
    left = np.eye(2**first_target, dtype=_C)
    right = np.eye(2 ** (num_qubits - first_target - k), dtype=_C)
    return np.kron(np.kron(left, gate), right)


def controlled(gate: np.ndarray, num_controls: int = 1) -> np.ndarray:
    """Block-diagonal controlled gate on (controls..., targets...) qubits."""
    size = check_gate(gate)
    dim = (2**num_controls) * size
    out = np.eye(dim, dtype=_C)
    out[dim - size:, dim - size:] = gate
    return out


def multi_controlled(
    num_qubits: int, control_qubits: list[int], first_target: int, gate: np.ndarray
) -> np.ndarray:
    """Full-register matrix for a multi-controlled gate at arbitrary positions.

    Provided for API parity with the reference (qgates.py:228-275); the
    engine itself uses :func:`qbot_tpu.ops.core.apply_controlled` which never
    builds this matrix.  Built here by embedding the block-diagonal controlled
    operator and permuting qubit axes — no swap-gate conjugation chain.
    """
    size = check_gate(gate)
    k = int_log2(size)
    c = len(control_qubits)
    targets = list(range(first_target, first_target + k))
    overlap = set(control_qubits) & set(targets)
    if overlap:
        raise ValueError(f"controls {sorted(overlap)} overlap targets {targets}")
    cg = controlled(gate, c)
    # Build as tensor: cg acts on qubits (controls..., targets...) of the
    # register; express via axis permutation of the embedded operator.
    full = np.kron(cg, np.eye(2 ** (num_qubits - c - k), dtype=_C))
    # full's qubit order: controls..., targets..., rest...
    order = list(control_qubits) + targets
    rest = [q for q in range(num_qubits) if q not in order]
    dest = order + rest  # qubit i of `full` goes to position dest[i]
    t = full.reshape((2,) * (2 * num_qubits))
    src = list(range(2 * num_qubits))
    dst = dest + [num_qubits + q for q in dest]
    t = np.moveaxis(t, src, dst)
    return t.reshape(full.shape)
